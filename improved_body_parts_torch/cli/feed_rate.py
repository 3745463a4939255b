"""Input-pipeline feed rate against the port's own train rate
(counterpart of ``tools/feed_rate.py``)::

    python -m improved_body_parts_torch.cli.feed_rate --workers 0,1,2,4 \\
        --train-bench train_bench_torch.json --out input_pipeline_torch.json

Measures samples/s through the real feed path, batch source →
``parallel.device_prefetch`` → a sink that synchronises the card after
each batch, for both label modes (host GT: the label maps made on the
host; device GT: padded joints for ``ops.gt_device``), on the drawn
fixture corpus (``data.fixture.fixture_records`` held in memory, the
records ``build_fixture`` writes; augmentation on).  Rows:

- ``sync`` (workers 0): batches made in this process;
- ``shm`` (workers N > 0): the persistent shared-memory ring
  (``data.ShmRingInput``), its endless ``stream()`` pipelined across
  epoch boundaries; the workers spawn once, before any timed window.

Rows run in ``--repeats`` interleaved rounds (host-load drift hits every
row alike); each row's samples and seconds are summed over the rounds.
The JAX tool's ``pool`` row (the retired spawn pool) is not ported and
``--pipelines pool`` is refused.

The answer is a projection: the shm rows' best per-worker rate against
the train rate, ``workers_for_one_chip`` (one card) and
``workers_for_8_cards``.  The train rate is ``--train-rate`` or, when
that is 0, the imgs/s of the largest batch in ``--train-bench`` (the
port's ``cli.train_bench`` artifact, ``train_bench_torch.json``);
without either the tool stops and asks for one.  No TPU figure stands
in for it.

Writes ``input_pipeline_torch.json`` (``--out``; the JAX tool's
``INPUT_PIPELINE.json`` is refused) with the card's name and power
limit.  Runs on ``--device cuda`` unless asked for ``cpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("INPUT_PIPELINE.json",)


def measure(make_iter, device, min_seconds: float):
    """(samples/s, samples, seconds) through ``make_iter(epoch)`` →
    ``device_prefetch`` → a sink that synchronises after each batch, for
    at least ``min_seconds``.  ``make_iter`` returns one epoch's batches
    (called again each epoch) or an endless stream; the window closes at
    the next batch boundary and the prefetcher is closed, so the ring
    reclaims its in-flight slots."""
    from ..parallel import device_prefetch
    from . import sync

    n, epoch = 0, 0
    t0 = time.perf_counter()
    while True:
        it = device_prefetch(make_iter(epoch), device)
        try:
            for batch in it:
                sync(device)
                n += batch[0].shape[0]
                if time.perf_counter() - t0 >= min_seconds:
                    break
        finally:
            it.close()
        epoch += 1
        dt = time.perf_counter() - t0
        if dt >= min_seconds:
            return n / dt, n, dt


def train_rate_from(path: str) -> float:
    """imgs/s of the largest batch in a ``cli.train_bench`` artifact."""
    with open(path) as f:
        batches = json.load(f)["batches"]
    largest = max(batches, key=int)
    return float(batches[largest]["imgs_per_sec"])


def projection(rows, train_rate: float, host_cores: int) -> dict:
    """Per mode: the sync rate, the best per-worker shm rate at worker
    counts within the host's cores, and the workers that rate needs to
    feed one card and eight."""
    out = {}
    for mode in ("host_gt", "device_gt"):
        mrows = [r for r in rows if r["mode"] == mode]
        if not mrows:
            continue
        sync_rate = max((r["samples_per_sec"] for r in mrows
                         if r["pipeline"] == "sync"), default=None)
        per_worker = max((r["samples_per_sec"] / r["workers"]
                          for r in mrows if r["pipeline"] == "shm"
                          and 0 < r["workers"] <= host_cores), default=None)
        if not per_worker:
            continue
        out[mode] = {
            "sync_rate": sync_rate,
            "shm_per_worker_rate": round(per_worker, 2),
            "workers_for_one_chip": math.ceil(train_rate / per_worker),
            "workers_for_8_cards": math.ceil(8 * train_rate / per_worker),
        }
    return out


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="canonical",
                    help="the 512-pixel published protocol by default")
    ap.add_argument("--records", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--min-seconds", type=float, default=20.0,
                    help="measure at least this long a row (split across "
                         "--repeats interleaved passes, at least 2 s each)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="interleaved rounds: every row once a round")
    ap.add_argument("--workers", default="0,1,2,4",
                    help="comma-separated worker counts (0 = the sync row)")
    ap.add_argument("--pipelines", default="sync,shm",
                    help="transports: sync, shm ('pool', the retired "
                         "spawn pool, is not ported)")
    ap.add_argument("--wire", default="uint8", choices=("uint8", "f32"),
                    help="image wire format for every row")
    ap.add_argument("--max-people", type=int, default=8,
                    help="joint padding of the device-GT payload")
    ap.add_argument("--train-rate", type=float, default=0.0,
                    help="the card's train rate in imgs/s; 0 reads "
                         "--train-bench")
    ap.add_argument("--train-bench", default="train_bench_torch.json",
                    help="cli.train_bench artifact whose largest batch "
                         "gives the train rate")
    ap.add_argument("--out", default="input_pipeline_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    from .. import resolve_device
    from ..config import get_config
    from ..data import MemoryDataset, ShmRingInput, batches
    from ..data.fixture import fixture_records
    from ..obs.events import strict_dump, strict_dumps
    from . import card_stamp, refuse_artifact

    refuse_artifact(args.out, JAX_ARTIFACTS)
    pipelines = [p.strip() for p in args.pipelines.split(",")]
    if "pool" in pipelines:
        raise SystemExit("--pipelines pool: the retired spawn pool is not "
                         "ported (ROADMAP.md); measure sync and shm")
    device = resolve_device(args.device)
    train_rate = args.train_rate
    if not train_rate:
        if not os.path.exists(args.train_bench):
            raise SystemExit(
                f"no train rate: {args.train_bench} (cli.train_bench's "
                "artifact) is missing; run cli.train_bench or pass "
                "--train-rate IMGS_PER_S")
        train_rate = train_rate_from(args.train_bench)

    cfg = get_config(args.config)
    size = cfg.skeleton.height
    worker_counts = [int(x) for x in args.workers.split(",")]
    records = fixture_records(num_images=args.records, people_per_image=2,
                              img_size=(size * 3 // 4, size),
                              image_size=size, seed=0, drawn=True)
    ds = MemoryDataset(records, cfg, augment=True)
    print(f"corpus: {len(records)} records at {size}px; train rate target "
          f"{train_rate:.2f} imgs/s; wire={args.wire}", flush=True)

    def sync_iter(raw_gt):
        return lambda epoch: batches(ds, args.batch, epoch, raw_gt=raw_gt,
                                     wire=args.wire)

    # every row's source is built first: the rings spawn here, outside
    # any timed window (idle workers block on the task queue)
    specs, rings = [], []
    try:
        for mode, raw_gt in (("host_gt", 0), ("device_gt", args.max_people)):
            for w in worker_counts:
                if w <= 0:
                    if "sync" in pipelines:
                        specs.append((mode, "sync", 0, sync_iter(raw_gt)))
                    continue
                if "shm" in pipelines:
                    ring = ShmRingInput(ds, args.batch, w, raw_gt=raw_gt,
                                        wire=args.wire)
                    rings.append(ring)
                    specs.append((mode, "shm", w,
                                  lambda epoch, r=ring: r.stream()))

        acc = [[0, 0.0] for _ in specs]
        per_pass = max(args.min_seconds / max(args.repeats, 1), 2.0)
        for rep in range(max(args.repeats, 1)):
            for i, (_, _, _, make_iter) in enumerate(specs):
                _, n, dt = measure(make_iter, device, per_pass)
                acc[i][0] += n
                acc[i][1] += dt
                time.sleep(0.5)  # let abandoned in-flight work settle
            print(f"round {rep + 1}/{args.repeats} done", flush=True)
    finally:
        for ring in rings:
            ring.close()

    rows = []
    for (mode, pipeline, w, _), (n, dt) in zip(specs, acc):
        rate = n / dt if dt else 0.0
        rows.append({"mode": mode, "pipeline": pipeline, "workers": w,
                     "samples_per_sec": round(rate, 2), "samples": n,
                     "seconds": round(dt, 2)})
        print(f"{mode} {pipeline} workers={w}: {rate:.2f} samples/s "
              f"({n} in {dt:.1f}s)", flush=True)

    host_cores = os.cpu_count() or 1
    note = None
    if max(worker_counts) >= host_cores:
        note = (f"host has {host_cores} cores: worker counts >= "
                f"{host_cores} timeshare them with the consumer, so the "
                "measured rates saturate near the core count; the "
                "per-worker projection scales to hosts with more cores")
    result = {
        "config": args.config, "image_size": size, "batch": args.batch,
        "platform": device.type, **card_stamp(device),
        "host_cores": host_cores, "host_note": note, "wire": args.wire,
        "chip_train_rate_imgs_per_sec": train_rate,
        "train_rate_source": (f"--train-rate {args.train_rate}"
                              if args.train_rate else args.train_bench),
        "protocol": "batch source -> parallel.device_prefetch -> a sink "
                    "that synchronises the card each batch; drawn fixture "
                    "records in memory; augment on; shm rows use the "
                    "persistent data.ShmRingInput stream() (pipelined "
                    "across epochs; spawn outside the window)",
        "rows": rows,
        "projection": projection(rows, train_rate, host_cores),
    }
    with open(args.out, "w") as f:
        strict_dump(result, f, indent=2)
    print(strict_dumps(result))
    return result


if __name__ == "__main__":
    main()
