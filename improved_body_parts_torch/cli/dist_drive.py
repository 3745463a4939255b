"""Multi-process training drive of the port (counterpart of
``tools/dist_drive.py``)::

    python -m improved_body_parts_torch.cli.dist_drive --config tiny \\
        --images 8 --epochs 3 --resume-after 2 --device cpu

Runs ``cli.train`` over gloo ranks (the CPU) or NCCL ranks (one card a
rank) in four arms, each on the same drawn HDF5 corpus and val corpus:

A. one process at the two-rank layout: ``cli.train.train`` with the
   global batch of two ranks (``batch_size_per_device`` doubled) and
   their world-size LR (``learning_rate_per_device`` doubled);
B. two processes (``--coordinator --num-processes 2``) straight through
   all epochs;
C. two processes stopped after ``--resume-after`` epochs and restarted
   from the shared checkpoint (``--resume auto``);
P. the partitioned state: ``--partition-processes`` ranks with
   ``--partition --mesh-model 2`` on ``tiny`` (its own corpus); the mesh
   and the realized sharding are read from rank 0's log.

Two claims, each asserted:

- resume (C against B): every epoch's loss equal, bit for bit.  The
  checkpoint restores parameters, momentum, the update count and the step,
  and the data order is keyed on (seed, epoch, index);
- topology (B against A): the same global sample set a step (process p
  takes ``perm[p::2]``) summed in another order, so the first epoch
  agrees within ``--tolerance``; later epochs are reported, not gated
  (tiny weight differences grow through a steep descent).

Writes ``dist_drive_torch.json`` (``--out``); the JAX tool's
``DIST_DRIVE.json`` is refused.  Exits 1 when a claim fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
import subprocess
import sys
import tempfile
import time

#: the JAX tool's artifact, which this CLI never writes
JAX_ARTIFACTS = ("DIST_DRIVE.json",)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3,
                    help="total epochs; arm C restarts after --resume-after")
    ap.add_argument("--resume-after", type=int, default=2)
    ap.add_argument("--tolerance", type=float, default=0.02,
                    help="max relative first-epoch loss difference, B vs A")
    ap.add_argument("--partition-epochs", type=int, default=2,
                    help="epochs of arm P (0 leaves it out)")
    ap.add_argument("--partition-processes", type=int, default=4,
                    help="ranks of arm P (a (ranks / 2, 2) mesh)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default="dist_drive_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (NCCL, one card a rank) or 'cpu' (gloo)")
    return ap


def epoch_losses(ckpt_dir: str):
    """Epoch → train loss from the append-only log, the last line of an
    epoch winning."""
    log = os.path.join(ckpt_dir, "log")
    if not os.path.exists(log):
        return []
    with open(log) as f:
        entries = re.findall(r"Epoch (\d+)\ttrain_loss: ([0-9.eE+-]+)",
                             f.read())
    by_epoch = {int(e): float(v) for e, v in entries}
    return [by_epoch[e] for e in sorted(by_epoch)]


def launch_ranks(n: int, argv, logs, timeout_s: float = 1800.0):
    """``n`` ranks of ``cli.train argv`` joined at a free localhost port;
    returns their exit codes (a rank left running past the timeout is
    killed, so no rank outlives the call)."""
    from ..parallel.mesh import free_port

    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    try:
        for rank in range(n):
            log = open(logs(rank), "w")
            cmd = [sys.executable, "-m", "improved_body_parts_torch.cli.train",
                   *argv, "--coordinator", coord, "--num-processes", str(n),
                   "--process-id", str(rank)]
            procs.append((subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT,
                                           env=env), log))
        deadline = time.monotonic() + timeout_s
        for p, _ in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return [p.returncode for p, _ in procs]


def main(argv=None):
    args = _parser().parse_args(argv)
    if os.path.basename(args.out) in JAX_ARTIFACTS:
        raise SystemExit(f"--out {args.out}: that name is the JAX tool's "
                         "artifact; pick another")

    from .. import resolve_device
    from ..config import get_config
    from ..data import CocoPoseDataset
    from ..data.fixture import build_fixture
    from ..obs.events import strict_dump, strict_dumps
    from . import train as cli_train

    device = resolve_device(args.device)
    work = os.path.abspath(args.workdir
                           or tempfile.mkdtemp(prefix="dist_drive_"))
    os.makedirs(work, exist_ok=True)
    cfg = get_config(args.config)
    size = cfg.skeleton.height
    h5, val_h5 = os.path.join(work, "corpus.h5"), os.path.join(work,
                                                               "val.h5")
    n_rec = build_fixture(h5, num_images=args.images, people_per_image=2,
                          img_size=(192, 256), image_size=size, seed=0,
                          drawn=True)
    build_fixture(val_h5, num_images=max(args.images // 4, 2),
                  people_per_image=2, img_size=(192, 256), image_size=size,
                  seed=99, drawn=True)
    print(f"corpus: {n_rec} records", flush=True)

    def train_argv(ckpt, epochs, *extra):
        return ["--config", args.config, "--train-h5", h5, "--val-h5",
                val_h5, "--checkpoint-dir", ckpt, "--epochs", str(epochs),
                "--workers", "0", "--print-freq", "1", "--device",
                args.device, *extra]

    def pair(ckpt, tag, epochs, *extra):
        rcs = launch_ranks(2, train_argv(ckpt, epochs, *extra),
                           lambda r: os.path.join(work,
                                                  f"rank{r}{tag}.log"))
        if any(rc != 0 for rc in rcs):
            raise SystemExit(f"arm ranks failed, exit codes {rcs}; see "
                             f"{work}/rank*{tag}.log")

    seconds = {}
    # --- A: one process, the two-rank layout ----------------------------
    ckpt_a = os.path.join(work, "ckpt_single")
    t0 = time.perf_counter()
    tr = cfg.train
    cfg_a = cfg.replace(train=dataclasses.replace(
        tr, batch_size_per_device=2 * tr.batch_size_per_device,
        learning_rate_per_device=2 * tr.learning_rate_per_device,
        checkpoint_dir=ckpt_a, print_freq=1))
    ds, val_ds = (CocoPoseDataset(h5, cfg_a, augment=True, seed=0),
                  CocoPoseDataset(val_h5, cfg_a, augment=False))
    try:
        cli_train.train(cfg_a, ds, args.epochs, device=device,
                        val_dataset=val_ds, log_fn=lambda s: None)
    finally:
        ds.close()
        val_ds.close()
    seconds["single"] = time.perf_counter() - t0
    losses_a = epoch_losses(ckpt_a)
    print(f"A one process, two-rank layout: {losses_a}", flush=True)

    # --- B: two processes straight through ------------------------------
    ckpt_b = os.path.join(work, "ckpt_dist_straight")
    t0 = time.perf_counter()
    pair(ckpt_b, "_straight", args.epochs)
    seconds["two_process_straight"] = time.perf_counter() - t0
    losses_b = epoch_losses(ckpt_b)
    print(f"B two processes: {losses_b}", flush=True)

    # --- C: two processes with a restart from the checkpoint ------------
    ckpt_c = os.path.join(work, "ckpt_dist")
    t0 = time.perf_counter()
    pair(ckpt_c, "", args.resume_after)
    pair(ckpt_c, "_resumed", args.epochs - args.resume_after,
         "--resume", "auto")
    seconds["two_process_resumed"] = time.perf_counter() - t0
    losses_c = epoch_losses(ckpt_c)
    print(f"C two processes, restarted after epoch "
          f"{args.resume_after - 1}: {losses_c}", flush=True)

    partitioned = None
    if args.partition_epochs > 0:
        partitioned = partitioned_arm(work, args, device)
        seconds["partitioned"] = partitioned.pop("seconds")

    ok = len(losses_a) == len(losses_b) == len(losses_c) == args.epochs
    resume_exact = ok and losses_c == losses_b
    topology_rel = [abs(a - b) / max(abs(a), 1e-9)
                    for a, b in zip(losses_a, losses_b)]
    topology_ok = ok and topology_rel[0] <= args.tolerance
    result = {
        "config": args.config, "records": n_rec, "epochs": args.epochs,
        "device": device.type,
        "resume_boundary_after_epoch": args.resume_after,
        "single_process_losses": losses_a,
        "two_process_straight_losses": losses_b,
        "two_process_resumed_losses": losses_c,
        "resume_exact": bool(resume_exact),
        "topology_rel_diff_per_epoch": topology_rel,
        "topology_first_epoch_ok": bool(topology_ok),
        "tolerance": args.tolerance,
        "parity_ok": bool(resume_exact and topology_ok),
        "partitioned": partitioned,
        "seconds": seconds,
        "protocol": "arm A: cli.train.train in one process with two "
                    "ranks' global batch and world-size LR; arms B/C: "
                    "two cli.train processes over torch.distributed "
                    f"({'NCCL' if device.type == 'cuda' else 'gloo'}); C "
                    "restarts both ranks from the shared checkpoint after "
                    f"epoch {args.resume_after - 1}. Resume parity (C vs "
                    "B) asserted bit for bit; topology parity (B vs A) on "
                    "the first epoch only.",
        "workdir": work,
    }
    with open(args.out, "w") as f:
        strict_dump(result, f, indent=2)
    print(strict_dumps(result))
    if not result["parity_ok"]:
        raise SystemExit(f"parity failed: resume exact {resume_exact}, "
                         f"topology rel {topology_rel}")
    if partitioned is not None and not partitioned["ok"]:
        raise SystemExit(f"partitioned arm failed: {partitioned}")
    return result


def partitioned_arm(work, args, device):
    """Arm P: ``cli.train --partition --mesh-model 2`` on ``tiny`` over
    ``--partition-processes`` ranks (its corpus is its val set too: every
    rank evaluates); the mesh and the realized sharding from rank 0's
    log."""
    from ..data.fixture import build_fixture

    p_h5 = os.path.join(work, "partition_corpus.h5")
    build_fixture(p_h5, num_images=args.partition_processes, img_size=(
        192, 256), people_per_image=2, image_size=128, seed=0, drawn=True)
    ckpt = os.path.join(work, "ckpt_partitioned")
    t0 = time.perf_counter()
    rcs = launch_ranks(
        args.partition_processes,
        ["--config", "tiny", "--train-h5", p_h5, "--val-h5", p_h5,
         "--checkpoint-dir", ckpt,
         "--epochs", str(args.partition_epochs), "--workers", "0",
         "--print-freq", "1", "--device", args.device, "--partition",
         "--mesh-model", "2"],
        lambda r: os.path.join(work, f"partitioned{r}.log"))
    seconds = time.perf_counter() - t0
    with open(os.path.join(work, "partitioned0.log")) as f:
        text = f.read()
    mesh = sharding = None
    m = re.search(r"mesh=data:(\d+),model:(\d+)", text)
    if m:
        mesh = {"data": int(m.group(1)), "model": int(m.group(2))}
    m = re.search(r"partitioned state: \{'sharded': (\d+), "
                  r"'replicated': (\d+)\}", text)
    if m:
        sharding = {"sharded": int(m.group(1)),
                    "replicated": int(m.group(2))}
    losses = epoch_losses(ckpt)
    finite = all(x == x and abs(x) != float("inf") for x in losses)
    out = {"config": "tiny", "processes": args.partition_processes,
           "epochs": args.partition_epochs, "exit_codes": rcs,
           "losses": losses, "mesh": mesh,
           "realized_state_sharding": sharding, "finite": finite,
           "ok": bool(all(rc == 0 for rc in rcs)
                      and len(losses) == args.partition_epochs and finite
                      and sharding is not None and sharding["sharded"] > 0),
           "seconds": seconds}
    print(f"P partitioned ({args.partition_processes} ranks): "
          f"losses={losses} mesh={mesh} sharding={sharding}", flush=True)
    return out


if __name__ == "__main__":
    main()
