"""Checkpointing of the port (``improved_body_parts_torch.train.checkpoint``)
and ``fit``'s cadence, on the CPU: the counterparts of
``tests/test_checkpoint_async.py``.

- async and sync saves restore the same bits; a restore rebuilds the
  model, the momentum, the update count and the step;
- the next in-place train step leaves a just-saved checkpoint unchanged;
- a process killed during the write resumes from the last committed
  checkpoint; an in-flight save is invisible until its marker lands;
- the marker is strict JSON on a non-finite loss; the in-flight stamp
  guards the legacy rule; an unmarked legacy directory still resumes;
- a writer failure surfaces on ``wait()``;
- retention keeps exactly {last N, best, milestones}, never deletes an
  uncommitted directory, prefers val-scored epochs, ignores non-finite
  scores and is rebuilt across a resume;
- ``fit``: the save cadence on absolute epochs with the final epoch
  always saved, the val-keyed best watermark, the train-loss fallback,
  the manager flushed when an epoch raises, and its spans and events.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from improved_body_parts_torch.config import get_config
from improved_body_parts_torch.models import build_model
from improved_body_parts_torch.obs import (
    EventSink,
    TraceRecorder,
    read_events,
    set_sink,
    set_tracer,
)
from improved_body_parts_torch.train import (
    CheckpointManager,
    TrainState,
    create_train_state,
    fit,
    is_committed,
    latest_checkpoint,
    make_optimizer,
    make_train_step,
    read_commit_meta,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
    step_decay_schedule,
)
from improved_body_parts_torch.train.checkpoint import _inflight_stamp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_config("tiny")


def _state(v=1.0, step=0):
    """A small state: a linear layer with SGD, its weights all ``v``."""
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.fill_(v)
        lin.bias.fill_(v)
    opt = make_optimizer(lin, CFG, step_decay_schedule(CFG.train, 4))
    with torch.no_grad():
        for i, buf in enumerate(opt.momentum):
            buf.fill_(v + i)
        opt.count.fill_(3)
    state = create_train_state(lin, CFG, opt)
    state.step = step
    return state


def _epochs(d):
    return sorted(int(n.split("_")[1]) for n in os.listdir(str(d))
                  if n.startswith("epoch_"))


def _tensors(state):
    out = {f"model/{k}": v.clone() for k, v in
           state.model.state_dict().items()}
    for i, b in enumerate(state.optimizer.momentum):
        out[f"momentum/{i}"] = b.clone()
    out["count"] = state.optimizer.count.clone()
    return out


def _assert_equal_states(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step


# ----------------------------------------------------- save / restore


def test_async_and_sync_saves_restore_identical(tmp_path):
    state = _state(1.5, step=7)
    sync_path = save_checkpoint(str(tmp_path / "sync"), state, 3,
                                train_loss=1.5, best_loss=1.2)
    with CheckpointManager(str(tmp_path / "async")) as m:
        async_path = m.save(state, 3, train_loss=1.5, best_loss=1.2)
    a, b = restore_checkpoint(sync_path), restore_checkpoint(async_path)
    assert a.keys() == b.keys()
    for part in ("model", "optimizer"):
        for k, v in a[part].items():
            if isinstance(v, dict):
                for n, t in v.items():
                    assert torch.equal(t, b[part][k][n])
            elif isinstance(v, torch.Tensor):
                assert torch.equal(v, b[part][k])
            else:
                assert v == b[part][k]
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (7, 3)
    assert is_committed(sync_path) and is_committed(async_path)
    # a restore into a fresh state rebuilds every part of it
    fresh = _state(0.0)
    restored, meta = restore_checkpoint(async_path, fresh)
    _assert_equal_states(restored, state)
    assert meta["epoch"] == 3 and meta["best_loss"] == pytest.approx(1.2)
    assert meta["metric"] == "train_loss"


def test_next_in_place_step_leaves_the_saved_checkpoint_unchanged(
        tmp_path):
    """The train step updates parameters, BN stats and momentum in place:
    a save must own its snapshot when it returns, or the step that runs
    while the write is in flight changes the checkpoint."""
    cfg = get_config("tiny")
    cfg = cfg.replace(
        skeleton=dataclasses.replace(cfg.skeleton, width=64, height=64),
        train=dataclasses.replace(cfg.train, bf16_compute=False))
    model = build_model(cfg, device="cpu", train=True)
    opt = make_optimizer(model, cfg, step_decay_schedule(cfg.train, 4))
    state = create_train_state(model, cfg, opt)
    step = make_train_step(model, cfg, opt)
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
             np.ones((2, 16, 16, 1), np.float32),
             rng.uniform(0, 1, (2, 16, 16, cfg.skeleton.num_layers))
             .astype(np.float32))
    state, _ = step(state, *batch)       # momentum non-zero from here on
    expected = {k: v.clone() for k, v in model.state_dict().items()}
    expected_mom = [b.clone() for b in opt.momentum]
    # the commit delay keeps the write in flight across the next step
    m = CheckpointManager(str(tmp_path), _commit_delay_s=1.0)
    m.save(state, 0, 2.0, 2.0)
    state, _ = step(state, *batch)
    moved = max(float((model.state_dict()[k] - v).abs().max())
                for k, v in expected.items() if v.is_floating_point())
    assert moved > 0
    m.close()
    payload = restore_checkpoint(os.path.join(str(tmp_path), "epoch_0"))
    for k, v in expected.items():
        assert torch.equal(payload["model"][k], v), k
    names = [n for n, _ in model.named_parameters()]
    for n, want in zip(names, expected_mom):
        assert torch.equal(payload["optimizer"]["momentum"][n], want), n
    assert payload["optimizer"]["count"] == 1 and payload["step"] == 1


_KILL_CHILD = """
import sys, time
sys.path.insert(0, {repo!r})
import torch
from improved_body_parts_torch.config import get_config
from improved_body_parts_torch.train import (
    CheckpointManager, create_train_state, make_optimizer,
    step_decay_schedule)

def st(v):
    lin = torch.nn.Linear(64, 64)
    with torch.no_grad():
        lin.weight.fill_(v)
    cfg = get_config("tiny")
    opt = make_optimizer(lin, cfg, step_decay_schedule(cfg.train, 4))
    return create_train_state(lin, cfg, opt)

d = sys.argv[1]
m = CheckpointManager(d)
m.save(st(1.0), 0, train_loss=1.0, best_loss=1.0)
m.wait()                                   # epoch_0 committed
print("EPOCH0_COMMITTED", flush=True)
# epoch_1: the writer sleeps between the payload and the commit marker,
# the window a crashing host leaves a complete but uncommitted entry in
m2 = CheckpointManager(d, _commit_delay_s=600)
m2.save(st(2.0), 1, train_loss=0.5, best_loss=0.5)
print("WRITE_IN_FLIGHT", flush=True)
time.sleep(600)
"""


def test_kill_during_write_resumes_from_last_committed(tmp_path):
    d = str(tmp_path / "ck")
    script = tmp_path / "child.py"
    script.write_text(_KILL_CHILD.format(repo=REPO))
    proc = subprocess.Popen([sys.executable, str(script), d],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    e1 = os.path.join(d, "epoch_1")
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if os.path.isfile(os.path.join(e1, "state.pt")):
                break
            if proc.poll() is not None:
                out, err = proc.communicate()
                pytest.fail(f"child died early:\n{out}\n{err}")
            time.sleep(0.05)
        else:
            pytest.fail("epoch_1 write never appeared")
        time.sleep(0.5)  # let torch.save finish its file
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert os.path.isdir(e1) and not is_committed(e1)
    assert latest_checkpoint(d) == os.path.join(d, "epoch_0")
    restored = restore_latest(d)
    assert float(restored["model"]["weight"][0, 0]) == 1.0
    assert restored["epoch"] == 0
    # saving epoch 1 again overwrites the debris and commits
    m = CheckpointManager(d)
    m.save(_state(3.0), 1, train_loss=0.4, best_loss=0.4)
    m.close()
    assert latest_checkpoint(d) == e1 and is_committed(e1)


def test_in_flight_save_invisible_until_commit(tmp_path):
    d = str(tmp_path)
    m = CheckpointManager(d)
    m.save(_state(1.0), 0, 1.0, 1.0)
    m.wait()
    m2 = CheckpointManager(d, _commit_delay_s=1.5)
    m2.save(_state(2.0), 1, 0.5, 0.5)
    e1 = os.path.join(d, "epoch_1")
    deadline = time.time() + 60
    while not os.path.isfile(os.path.join(e1, "state.pt")):
        assert time.time() < deadline
        time.sleep(0.02)
    assert latest_checkpoint(d) == os.path.join(d, "epoch_0")
    m2.close()
    assert is_committed(e1) and latest_checkpoint(d) == e1


def test_marker_strict_json_on_nonfinite(tmp_path):
    save_checkpoint(str(tmp_path), _state(), 0, train_loss=float("nan"),
                    best_loss=float("inf"))
    raw = (tmp_path / "epoch_0" / "COMMIT.json").read_text()
    assert "NaN" not in raw and "Infinity" not in raw
    meta = json.loads(raw)
    assert meta["train_loss"] == "nan" and meta["best_loss"] == "inf"


def test_inflight_stamp_guards_legacy_fallback(tmp_path):
    d = str(tmp_path)
    for e in (0, 1):  # entries from before the protocol: no markers
        os.makedirs(os.path.join(d, f"epoch_{e}"))
    os.makedirs(os.path.join(d, "epoch_5"))   # a new save, killed
    open(_inflight_stamp(d, 5), "w").close()
    assert latest_checkpoint(d) == os.path.join(d, "epoch_1")
    m = CheckpointManager(d)
    m.save(_state(), 6, 1.0, 1.0)
    m.close()
    assert latest_checkpoint(d) == os.path.join(d, "epoch_6")
    assert not os.path.exists(_inflight_stamp(d, 6))


def test_legacy_unmarked_directory_still_resumes(tmp_path):
    legacy = os.path.join(str(tmp_path), "epoch_4")
    os.makedirs(legacy)
    torch.save({"model": {"w": torch.ones(3)}},
               os.path.join(legacy, "state.pt"))
    assert latest_checkpoint(str(tmp_path)) == legacy
    assert torch.equal(restore_latest(str(tmp_path))["model"]["w"],
                       torch.ones(3))
    m = CheckpointManager(str(tmp_path))
    m.save(_state(), 5, 1.0, 1.0)
    m.close()
    assert latest_checkpoint(str(tmp_path)).endswith("epoch_5")


def test_writer_failure_surfaces_on_wait(tmp_path):
    m = CheckpointManager(str(tmp_path))

    class Boom:
        def save(self, *a, **k):
            raise OSError("disk gone")

    m._writer = Boom()
    m.save(_state(), 0, 1.0, 1.0)
    with pytest.raises(OSError, match="disk gone"):
        m.wait()
    assert not is_committed(os.path.join(str(tmp_path), "epoch_0"))


# ----------------------------------------------------------- retention


def test_gc_keeps_exactly_last_best_milestones(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last_n=2, keep_best=True,
                          milestone_every=4)
    for e in range(10):
        m.save(_state(float(e)), e, train_loss=10.0 - e, best_loss=10.0 - e)
        m.record_metric(e, "val_loss", 0.1 if e == 3 else 5.0 + e)
    m.close()
    # last 2 {8, 9} + best {3} + milestones {0, 4, 8}
    assert _epochs(tmp_path) == [0, 3, 4, 8, 9]
    assert all(is_committed(os.path.join(str(tmp_path), f"epoch_{e}"))
               for e in _epochs(tmp_path))


def test_gc_never_deletes_uncommitted(tmp_path):
    d = str(tmp_path)
    partial = os.path.join(d, "epoch_0")
    os.makedirs(partial)
    (tmp_path / "epoch_0" / "junk").write_text("partial")
    m = CheckpointManager(d, keep_last_n=1, keep_best=False)
    for e in (1, 2, 3):
        m.save(_state(), e, 1.0, 1.0)
    m.close()
    assert _epochs(tmp_path) == [0, 3]


def test_keep_best_prefers_val_scored_epochs(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last_n=1, keep_best=True)
    metrics = {0: ("train_loss", 0.01), 1: ("val_loss", 3.0),
               2: ("val_loss", 2.0), 3: ("train_loss", 0.05),
               4: ("val_loss", 5.0)}
    for e in range(5):
        m.save(_state(), e, 1.0, 1.0)
        m.record_metric(e, *metrics[e])
    m.close()
    assert _epochs(tmp_path) == [2, 4]


def test_keep_best_ignores_nonfinite_scores(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last_n=2, keep_best=True)
    metrics = {0: float("nan"), 1: 0.5, 2: 2.0, 3: 2.0, 4: 2.0}
    for e in range(5):
        m.save(_state(), e, 1.0, 1.0)
        m.record_metric(e, "val_loss", metrics[e])
    m.close()
    assert _epochs(tmp_path) == [1, 3, 4]


def test_retention_state_rebuilt_across_resume(tmp_path):
    d = str(tmp_path)
    m = CheckpointManager(d, keep_last_n=1, keep_best=True)
    for e in range(3):
        m.save(_state(), e, 1.0, 1.0)
        m.record_metric(e, "val_loss", 0.1 if e == 1 else 9.0)
    m.close()
    m2 = CheckpointManager(d, keep_last_n=1, keep_best=True)
    for e in (3, 4):
        m2.save(_state(), e, 1.0, 1.0)
        m2.record_metric(e, "val_loss", 9.0)
    m2.close()
    assert _epochs(tmp_path) == [1, 4]


# ------------------------------------------------------ fit's cadence


def _run_fit(tmp_path, save_freq, eval_freq, with_eval=True,
             train_losses=(1.0, 0.9, 0.8, 0.7, 0.6), epochs=5):
    cfg = CFG.replace(train=dataclasses.replace(
        CFG.train, save_freq=save_freq, eval_freq=eval_freq,
        checkpoint_dir=str(tmp_path)))
    current = [0]

    def make_batches(epoch):
        current[0] = epoch
        return iter([(np.ones((1, 4), np.float32),)] * 2)

    def step(s, x):
        return s, torch.tensor(train_losses[current[0]])

    eval_step = ((lambda s, x: torch.tensor(0.25)) if with_eval else None)
    make_eval = ((lambda epoch: iter([(np.ones((1, 4), np.float32),)]))
                 if with_eval else None)
    fit(_state(), step, cfg, make_batches, epochs=epochs,
        eval_step=eval_step, make_eval_batches=make_eval,
        log_fn=lambda s: None)


def _meta(tmp_path, e):
    return read_commit_meta(os.path.join(str(tmp_path), f"epoch_{e}"))


def test_fit_save_freq_and_final_always_saves(tmp_path):
    _run_fit(tmp_path, save_freq=2, eval_freq=5)
    assert _epochs(tmp_path) == [0, 2, 4]
    m2 = _meta(tmp_path, 2)
    assert m2["metric"] == "train_loss"
    assert m2["metric_value"] == pytest.approx(0.8)
    assert m2["best_loss"] == pytest.approx(0.25)  # epoch 0's val
    m4 = _meta(tmp_path, 4)
    assert m4["metric"] == "val_loss"
    assert m4["metric_value"] == pytest.approx(0.25)
    assert m4["best_loss"] == pytest.approx(0.25)
    log = (tmp_path / "log").read_text()
    assert log.count("train_loss: ") == 5 and log.count("val_loss: ") == 2


def test_fit_every_epoch_evals_best_is_val(tmp_path):
    _run_fit(tmp_path, save_freq=1, eval_freq=1)
    for e in range(5):
        meta = _meta(tmp_path, e)
        assert meta["metric"] == "val_loss"
        assert meta["best_loss"] == pytest.approx(0.25)


def test_fit_best_watermark_not_contaminated_by_train_loss(tmp_path):
    _run_fit(tmp_path, save_freq=1, eval_freq=4,
             train_losses=(0.01, 0.01, 0.01), epochs=3)
    m1 = _meta(tmp_path, 1)
    assert m1["metric"] == "train_loss"
    assert m1["metric_value"] == pytest.approx(0.01)
    assert m1["best_loss"] == pytest.approx(0.25)
    assert _meta(tmp_path, 2)["best_loss"] == pytest.approx(0.25)


def test_fit_no_eval_falls_back_to_train_loss(tmp_path):
    _run_fit(tmp_path, save_freq=1, eval_freq=1, with_eval=False)
    meta = _meta(tmp_path, 4)
    assert meta["metric"] == "train_loss"
    assert meta["best_loss"] == pytest.approx(0.6)


def test_fit_flushes_the_write_when_an_epoch_raises(tmp_path):
    """A crash in epoch 1 still lands epoch 0's in-flight write."""
    cfg = CFG.replace(train=dataclasses.replace(
        CFG.train, checkpoint_dir=str(tmp_path)))

    def make_batches(epoch):
        if epoch == 1:
            raise RuntimeError("data gone")
        return iter([(np.ones((1, 4), np.float32),)])

    with pytest.raises(RuntimeError, match="data gone"):
        fit(_state(), lambda s, x: (s, torch.tensor(1.0)), cfg,
            make_batches, epochs=3, log_fn=lambda s: None)
    assert is_committed(os.path.join(str(tmp_path), "epoch_0"))
    # a mesh is a parallel.make_mesh DeviceMesh, or nothing
    with pytest.raises(TypeError, match="DeviceMesh"):
        fit(_state(), lambda s, x: (s, torch.tensor(1.0)), cfg,
            make_batches, epochs=1, mesh=object())


def test_checkpoint_spans_and_events(tmp_path):
    sink = EventSink(str(tmp_path / "ev.jsonl"))
    tracer = TraceRecorder()
    prev_sink, prev_tracer = set_sink(sink), set_tracer(tracer)
    try:
        with CheckpointManager(str(tmp_path / "ck"), keep_last_n=1) as m:
            for e in range(2):
                m.save(_state(float(e)), e, 1.0 - e * 0.1, 1.0)
                m.record_metric(e, "val_loss", 0.5)
    finally:
        set_sink(prev_sink)
        set_tracer(prev_tracer)
        sink.close()
    cks = [e for e in read_events(str(tmp_path / "ev.jsonl"))
           if e["event"] == "checkpoint"]
    assert [c["epoch"] for c in cks] == [0, 1]
    for c in cks:
        assert c["bytes"] > 0 and c["async_save"] is True
        assert c["serialize_s"] >= 0 and c["commit_s"] >= 0
    # keep_last_n=1 keeps epoch 1; keep-best keeps epoch 0 (a tie at 0.5,
    # the first epoch wins)
    assert cks[-1]["retained"] == 2
    assert len(m.blocked_seconds) == len(m.write_seconds) == 2
    names = {e["name"] for e in tracer.events()
             if e.get("name") in ("snapshot", "serialize", "commit")}
    assert names == {"snapshot", "serialize", "commit"}


def test_restore_needs_no_optimizer_state(tmp_path):
    """An inference checkpoint (no optimizer, as ``cli.synth_ap``'s
    fresh baseline writes) restores the model and keeps the state's own
    optimizer."""
    state = _state(2.0)
    path = save_checkpoint(str(tmp_path), TrainState(model=state.model,
                                                     optimizer=None),
                           0, float("inf"), float("inf"))
    assert restore_checkpoint(path)["optimizer"] is None
    fresh = _state(0.0)
    restored, _ = restore_checkpoint(path, fresh)
    assert float(restored.model.weight.detach()[0, 0]) == 2.0
    assert float(restored.optimizer.momentum[0][0, 0]) == 0.0
