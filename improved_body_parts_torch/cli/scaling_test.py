"""Weak-scaling curve of the port's multi-rank train step (counterpart of
``tools/scaling_test.py``)::

    python -m improved_body_parts_torch.cli.scaling_test --devices 1 2 4 \\
        --steps 10 --rounds 3 --device cpu --out scaling_torch.json

For each rank count n of ``--devices`` a process group of n ranks (gloo
on the CPU, NCCL with one card a rank) runs ``make_train_step(mesh=,
rules=)`` at a fixed ``--batch-per-device``, so the global batch grows
with n.  The protocol is the JAX tool's:

- every group is started and warmed first (one step each), outside every
  timing window;
- then ``--rounds`` rounds; each times ``--steps`` chained steps at every
  n back to back, so a slow stretch of the host hits every n alike;
- the verdict for n is the median over rounds, and the curve's is global
  imgs/s non-decreasing within ``--tolerance``.

On CPU ranks every rank shares the host's cores, so the gated claim is
global throughput growing with n, not per-rank efficiency.  The largest
group's first step on a fixed batch is also held to a single-process
step of the same seed on the same global batch (loss within rel 2e-5).

Writes ``scaling_torch.json`` (``--out``; the JAX tool's ``SCALING.json``
is refused) and exits 1 when parity or the curve fails.
"""
from __future__ import annotations

import argparse
import os
import statistics
import time

#: the JAX tool's artifact, which this CLI never writes
JAX_ARTIFACTS = ("SCALING.json",)

PARITY_TOL = 2e-5


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--batch-per-device", type=int, default=1)
    ap.add_argument("--steps", type=int, default=10,
                    help="chained steps a (round, n) timing segment")
    ap.add_argument("--rounds", type=int, default=3,
                    help="interleaved verdict rounds (median wins)")
    ap.add_argument("--image-size", type=int, default=None,
                    help="H = W (default: the config's input size)")
    ap.add_argument("--rules", default="imhn",
                    help="partition ruleset (parallel.partition."
                         "NAMED_RULESETS)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="'model' mesh-axis size where it divides n (1 "
                         "elsewhere)")
    ap.add_argument("--min-shard-dim", type=int, default=None,
                    help="per-rank extent floor of the rule refinement "
                         "(default: parallel.partition's 8)")
    ap.add_argument("--tolerance", type=float, default=0.10,
                    help="allowed fractional dip between consecutive "
                         "median imgs/s points")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="scaling_torch.json")
    return ap


def _setup(args, device):
    """The config, the model's input and label sizes, the ruleset and its
    floor."""
    from ..config import get_config
    from ..parallel.partition import DEFAULT_MIN_SHARD_DIM, get_ruleset

    cfg = get_config(args.config)
    size = args.image_size or cfg.skeleton.height
    return (cfg, size, size // cfg.skeleton.stride, get_ruleset(args.rules),
            args.min_shard_dim or DEFAULT_MIN_SHARD_DIM)


def _batch(cfg, rows, size, label, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (rows, size, size, 3)).astype(np.float32),
            np.ones((rows, label, label, 1), np.float32),
            rng.uniform(0, 1, (rows, label, label, cfg.skeleton.num_layers)
                        ).astype(np.float32))


def _state(cfg, device):
    from ..models import build_model
    from ..train import create_train_state, make_optimizer
    from ..train import step_decay_schedule

    model = build_model(cfg, device=device, seed=0, train=True)
    opt = make_optimizer(model, cfg, step_decay_schedule(
        cfg.train, steps_per_epoch=100))
    return create_train_state(model, cfg, opt)


def rank_main(rank, n, coord, args, commands, results):
    """One rank of the n-rank group: warm, report, then run each timing
    command it is sent (rank 0 reports the seconds)."""
    import torch

    from ..parallel import (
        initialize_distributed,
        make_mesh,
        shard_batch,
        sharding_summary,
        shutdown_distributed,
        train_state_shardings,
    )
    from ..parallel.mesh import rank_device
    from ..train import make_train_step

    torch.set_num_threads(1)
    device = rank_device(args.device, rank)
    initialize_distributed(coord, n, rank, device=device)
    cfg, size, label, rules, floor = _setup(args, device)
    model_ax = args.model_axis if n % args.model_axis == 0 else 1
    mesh = make_mesh(n // model_ax, model_ax, device=device)
    data = n // model_ax
    state = _state(cfg, device)
    layout = train_state_shardings(state.model, state.optimizer, mesh,
                                   rules, min_shard_dim=floor)
    step = make_train_step(state.model, cfg, state.optimizer, mesh=mesh,
                           rules=rules, min_shard_dim=floor)
    gb = args.batch_per_device * data
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    parity = shard_batch(_batch(cfg, gb, size, label, 1234), mesh)
    state, loss_p = step(state, *parity)
    batch = shard_batch(_batch(cfg, gb, size, label, n), mesh)
    t0 = time.perf_counter()
    state, loss = step(state, *batch)
    sync()
    warm_s = time.perf_counter() - t0
    if rank == 0:
        results.put((n, "warm", dict(
            mesh={"data": data, "model": model_ax}, global_batch=gb,
            warm_s=warm_s, first_step_loss=float(loss),
            parity_loss=float(loss_p),
            state_leaves=sharding_summary(layout))))
    while True:
        steps = commands.get()
        if steps is None:
            break
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step(state, *batch)
        float(loss)
        sync()
        if rank == 0:
            results.put((n, "round", time.perf_counter() - t0))
    shutdown_distributed()


def main(argv=None):
    args = _parser().parse_args(argv)
    if os.path.basename(args.out) in JAX_ARTIFACTS:
        raise SystemExit(f"--out {args.out}: that name is the JAX tool's "
                         "artifact; pick another")
    import multiprocessing as mp

    import numpy as np

    from .. import resolve_device
    from ..obs.events import strict_dump
    from ..parallel.mesh import free_port
    from ..parallel.partition import rules_fingerprint
    from ..train import make_train_step

    device = resolve_device(args.device)
    cfg, size, label, rules, floor = _setup(args, device)
    sizes = sorted(set(args.devices))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    groups = {}
    try:
        for n in sizes:
            coord = f"127.0.0.1:{free_port()}"
            cmds = [ctx.Queue() for _ in range(n)]
            procs = [ctx.Process(target=rank_main,
                                 args=(r, n, coord, args, cmds[r], results),
                                 daemon=True) for r in range(n)]
            for p in procs:
                p.start()
            groups[n] = (procs, cmds)
        arms = {}
        for _ in sizes:
            n, kind, rec = results.get(timeout=900)
            arms[n] = rec
            print(f"n={n}: warmed in {rec['warm_s']:.1f} s, global batch "
                  f"{rec['global_batch']}, state {rec['state_leaves']}",
                  flush=True)
        per_round = {n: [] for n in sizes}
        for r in range(args.rounds):
            for n in sizes:
                for q in groups[n][1]:
                    q.put(args.steps)
                got_n, kind, dt = results.get(timeout=900)
                per_round[got_n].append(
                    args.steps * arms[got_n]["global_batch"] / dt)
            print(f"round {r}: " + "  ".join(
                f"n={n}: {per_round[n][-1]:.2f} imgs/s" for n in sizes),
                flush=True)
    finally:
        for procs, cmds in groups.values():
            for q in cmds:
                q.put(None)
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.kill()
                    p.join()

    # the single-process step of the same seed on the largest group's
    # parity batch
    big = arms[sizes[-1]]
    state = _state(cfg, device)
    step = make_train_step(state.model, cfg, state.optimizer)
    _, loss_s = step(state, *_batch(cfg, big["global_batch"], size, label,
                                    1234))
    rel = abs(big["parity_loss"] - float(loss_s)) / max(abs(float(loss_s)),
                                                        1e-12)
    parity = {"global_batch": big["global_batch"],
              "partitioned_mesh": big["mesh"],
              "single_process_loss": float(loss_s),
              "partitioned_loss": big["parity_loss"], "rel_diff": rel,
              "tolerance": PARITY_TOL, "ok": bool(rel <= PARITY_TOL)}
    results_by_n = {}
    for n in sizes:
        med = statistics.median(per_round[n])
        results_by_n[str(n)] = {
            "mesh": arms[n]["mesh"], "global_batch": arms[n]["global_batch"],
            "imgs_per_sec_rounds": per_round[n],
            "imgs_per_sec_median": med, "per_rank_imgs_per_sec": med / n,
            "warm_s": arms[n]["warm_s"],
            "state_leaves": arms[n]["state_leaves"],
            "first_step_loss": arms[n]["first_step_loss"],
            "first_step_finite": bool(np.isfinite(
                arms[n]["first_step_loss"]))}
    medians = [results_by_n[str(n)]["imgs_per_sec_median"] for n in sizes]
    monotone = all(b >= a * (1.0 - args.tolerance)
                   for a, b in zip(medians, medians[1:]))
    artifact = {
        "config": args.config, "image_size": size,
        "batch_per_device": args.batch_per_device, "devices": sizes,
        "device": device.type,
        "partition_rules": {"name": args.rules,
                            "fingerprint": rules_fingerprint(
                                rules, min_shard_dim=floor),
                            "min_shard_dim": floor},
        "steps_per_segment": args.steps, "rounds": args.rounds,
        "results": results_by_n, "imgs_per_sec_medians": medians,
        "weak_scaling_efficiency": {
            str(n): results_by_n[str(n)]["imgs_per_sec_median"]
            / (medians[0] * n) for n in sizes},
        "loss_parity": parity, "monotone_tolerance": args.tolerance,
        "monotone_ok": bool(monotone),
        "protocol": "one process group a rank count, all started and "
                    "warmed before timing; interleaved rounds (every n "
                    "timed each round, chained steps), median-of-rounds "
                    "verdict.  CPU ranks share the host's cores, so the "
                    "gated claim is monotone global throughput.",
    }
    with open(args.out, "w") as f:
        strict_dump(artifact, f, indent=2)
    print(f"medians {medians} imgs/s, monotone_ok={monotone}, parity rel "
          f"{rel:.2e} ok={parity['ok']}; wrote {args.out}")
    if not parity["ok"]:
        raise SystemExit(f"partitioned-vs-single-process loss parity "
                         f"failed: rel {rel}")
    if not monotone:
        raise SystemExit(f"weak-scaling curve is not monotone: {medians}")
    return artifact


if __name__ == "__main__":
    main()
