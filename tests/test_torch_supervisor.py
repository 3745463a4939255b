"""The port's run supervisor (``train.supervisor``): the cases of
``tests/test_supervisor.py`` that a single-card run has.

- failure classification: infrastructure patterns transient, program
  bugs deterministic, an explicit "looks deterministic" diagnosis wins,
  and the port's classifier agrees with the JAX package's on every case;
- the ledger in ``RUN.json``: segment 0 of a fresh run, a stable run id,
  exponential backoff after kills without progress (capped), a committed
  epoch resetting the streak, the crash budget, transient crashes never
  tripping it, ``max_restarts``, the manifest merge, the close record;
- ``on_failure``: transient retries with backoff, a deterministic error
  recorded as a crash, the budget, a committed epoch resetting it;
- stops: SIGTERM requests a drain; ``fit`` raises ``StopRequested`` at the
  window boundary with epoch 0's save flushed and no epoch 1 debris, and
  at an epoch boundary with that epoch's save committed;
- ``chaos_kill_point``: a no-op without its variable, SIGKILL at the n-th
  hit of its point in a subprocess;
- resume: ``restore_latest`` through the supervisor; an unchanged
  single-process topology (no stamp, the port's earlier ``{"devices": 1,
  "processes": 1}``, this process's stamp) passes, another raises
  ``TopologyChanged`` under ``refuse``, is re-placed under ``adjust``,
  and another ruleset raises ``PartitionRulesChanged`` under either.
(The supervised ring rebuild is in ``test_torch_input.py``.)
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
from improved_body_parts_torch.train import (
    create_train_state,
    make_optimizer,
    step_decay_schedule,
)
from improved_body_parts_torch.train.checkpoint import (
    is_committed,
    latest_checkpoint,
    save_checkpoint,
)
from improved_body_parts_torch.parallel.mesh import mesh_topology
from improved_body_parts_torch.train.loop import fit
from improved_body_parts_torch.train.supervisor import (
    PartitionRulesChanged,
    RunSupervisor,
    StopRequested,
    SupervisorGaveUp,
    TopologyChanged,
    chaos_kill_point,
    classify_error,
    reshard_on_topology_change,
)
from improved_body_parts_tpu.train.supervisor import \
    classify_error as jclassify_error

sys.path.insert(0, "tests")
from test_torch_models import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_config("tiny")


def _state(v=1.0):
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.fill_(v)
        lin.bias.fill_(v)
    opt = make_optimizer(lin, CFG, step_decay_schedule(CFG.train, 4))
    return create_train_state(lin, CFG, opt)


def _sup(directory, **kw):
    sleeps = []
    sup = RunSupervisor(str(directory), sleep=sleeps.append,
                        log_fn=lambda s: None, **kw)
    return sup, sleeps


@pytest.mark.parametrize("msg,kind", [
    ("RuntimeError: UNAVAILABLE: socket closed", "transient"),
    ("DEADLINE_EXCEEDED while waiting", "transient"),
    ("RuntimeError: input worker died while the consumer waited",
     "transient"),
    ("the VM was preempted by the scheduler", "transient"),
    ("connection reset by peer", "transient"),
    ("XlaRuntimeError: RESOURCE_EXHAUSTED: Out of memory while trying to "
     "allocate 2147483648 bytes.", "transient"),
    ("ValueError: shapes (3, 4) and (5,) are incompatible", "deterministic"),
    ("KeyError: 'params'", "deterministic"),
    ("RuntimeError: input ring rebuilt 3 consecutive times without "
     "yielding a batch (max_rebuilds=3); the worker failure looks "
     "deterministic — last: input worker died (exitcode=-11)",
     "deterministic"),
])
def test_classification(msg, kind):
    assert classify_error(msg) == jclassify_error(msg) == kind


@pytest.mark.parametrize("msg,xla_counterpart", [
    # torch.OutOfMemoryError as the caching allocator raises it
    ("OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB. "
     "GPU 0 has a total capacity of 79.19 GiB of which 1.06 GiB is free. "
     "Process 1234 has 78.12 GiB memory in use.",
     "XlaRuntimeError: RESOURCE_EXHAUSTED: Out of memory while trying to "
     "allocate 2147483648 bytes."),
    # a CUDA runtime allocation (cudaErrorMemoryAllocation)
    ("RuntimeError: CUDA error: out of memory\nCUDA kernel errors might be "
     "asynchronously reported at some other API call",
     "XlaRuntimeError: RESOURCE_EXHAUSTED: Out of memory"),
    ("RuntimeError: CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
     "`cublasCreate(handle)`",
     "XlaRuntimeError: RESOURCE_EXHAUSTED: Out of memory"),
    ("RuntimeError: cuDNN error: CUDNN_STATUS_ALLOC_FAILED",
     "XlaRuntimeError: RESOURCE_EXHAUSTED: Out of memory"),
    ("RuntimeError: CUDA error: CUDA-capable device(s) is/are busy or "
     "unavailable", "XlaRuntimeError: UNAVAILABLE: device lost"),
])
def test_torch_errors_classify_as_their_xla_counterparts(msg,
                                                         xla_counterpart):
    """The messages torch and CUDA raise take the class the JAX
    supervisor gives the XLA error of the same failure."""
    assert classify_error(msg) == jclassify_error(xla_counterpart) \
        == "transient"


def test_torch_out_of_memory_error_is_retried(tmp_path):
    """A ``torch.OutOfMemoryError`` raised in the loop is retried with
    backoff, not counted as a deterministic crash."""
    sup, sleeps = _sup(tmp_path, crash_budget=2)
    sup.open_segment()
    err = torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.06 GiB is free.")
    assert sup.on_failure(err) == "retry" and sleeps == [1.0]
    assert sup.on_failure(err) == "raise"  # the budget still bounds it
    assert sup._segment_record()["error"].startswith("OutOfMemoryError")


def test_ledger_fresh_run_and_stable_run_id(tmp_path):
    sup, sleeps = _sup(tmp_path)
    rec = sup.open_segment({"argv": ["--epochs", "3"]})
    assert rec["segment"] == 0 and rec["previous_end"] == "fresh"
    assert sleeps == [] and sup.state() == "running"
    with open(tmp_path / "RUN.json") as f:
        ledger = json.load(f)
    assert ledger["run_id"] == sup.run_id
    assert ledger["segments"][0]["argv"] == ["--epochs", "3"]
    sup.update_manifest({"tool": "train", "config": "tiny"})
    with open(tmp_path / "RUN.json") as f:
        data = json.load(f)
    assert data["tool"] == "train"
    assert data["segments"][0]["status"] == "running"
    sup.close_segment("preempted", "stop requested")
    assert "end_unix" in sup._segment_record()
    s1, sleeps = _sup(tmp_path)
    assert s1.run_id == sup.run_id and s1.segment == 1
    assert s1.open_segment()["previous_end"] == "preemption"
    assert sleeps == []


def test_ledger_backoff_progress_and_budgets(tmp_path):
    kills = tmp_path / "kills"
    s0, _ = _sup(kills)
    s0.open_segment()  # never closed: SIGKILLed
    s1, sl1 = _sup(kills)
    assert s1.open_segment()["previous_end"] == "killed" and sl1 == [1.0]
    s2, sl2 = _sup(kills)
    s2.open_segment()
    assert sl2 == [2.0]
    save_checkpoint(str(kills), _state(), 0, train_loss=1.0, best_loss=1.0)
    s3, sl3 = _sup(kills)
    assert s3.open_segment()["epoch_committed"] == 0 and sl3 == []
    s4, sl4 = _sup(kills, backoff_max_s=0.5)
    s4.open_segment()
    assert sl4 == [0.5]  # capped

    crash = tmp_path / "crash"
    for _ in range(2):
        s, _ = _sup(crash, crash_budget=2)
        s.open_segment()
        s.close_segment("crashed", "ValueError: boom")
    s, _ = _sup(crash, crash_budget=2)
    with pytest.raises(SupervisorGaveUp, match="looks deterministic"):
        s.open_segment()

    transient = tmp_path / "transient"
    for i in range(4):
        s, _ = _sup(transient, crash_budget=2)
        rec = s.open_segment()
        assert i == 0 or rec["previous_end"] == "transient"
        s.close_segment("crashed", "RuntimeError: UNAVAILABLE")

    bound = tmp_path / "bound"
    for _ in range(2):
        s, _ = _sup(bound, max_restarts=2)
        s.open_segment()
        s.close_segment("preempted")
    s, _ = _sup(bound, max_restarts=2)
    with pytest.raises(SupervisorGaveUp, match="max_restarts"):
        s.open_segment()


def test_on_failure_decisions(tmp_path):
    sup, sleeps = _sup(tmp_path / "a", crash_budget=3)
    sup.open_segment()
    exc = RuntimeError("UNAVAILABLE: connection reset by peer")
    assert sup.on_failure(exc) == "retry" and sleeps == [1.0]
    assert sup.on_failure(exc) == "retry" and sleeps == [1.0, 2.0]

    sup, _ = _sup(tmp_path / "b")
    sup.open_segment()
    assert sup.on_failure(ValueError("bad shape")) == "raise"
    rec = sup._segment_record()
    assert rec["status"] == "crashed" and "ValueError" in rec["error"]
    nxt, _ = _sup(tmp_path / "b")
    assert nxt.open_segment()["previous_end"] == "deterministic"

    sup, _ = _sup(tmp_path / "c", crash_budget=2)
    sup.open_segment()
    exc = RuntimeError("DEADLINE_EXCEEDED")
    assert sup.on_failure(exc) == "retry"
    save_checkpoint(str(tmp_path / "c"), _state(), 0, train_loss=1.0,
                    best_loss=1.0)
    assert sup.on_failure(exc) == "retry"  # progress since the last try
    assert sup.on_failure(exc) == "retry"
    assert sup.on_failure(exc) == "raise"  # 2nd attempt without progress


def test_sigterm_requests_a_drain(tmp_path):
    sup, _ = _sup(tmp_path)
    sup.install_signal_handlers()
    try:
        assert not sup.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not sup.should_stop() and time.time() < deadline:
            time.sleep(0.01)
        assert sup.should_stop() and sup.state() == "draining"
    finally:
        sup.uninstall_signal_handlers()


def _cfg(tmp_path, **kw):
    return CFG.replace(train=dataclasses.replace(
        CFG.train, checkpoint_dir=str(tmp_path), **kw))


def _step(state, x):
    return state, torch.tensor(0.5)


def test_stop_at_window_boundary_flushes_epoch_0(tmp_path):
    current = [0]

    def make_batches(epoch):
        current[0] = epoch
        return iter([(np.ones((1, 4), np.float32),)] * 3)

    with pytest.raises(StopRequested, match="window boundary"):
        fit(_state(), _step, _cfg(tmp_path, print_freq=1), make_batches,
            epochs=4, should_stop=lambda: current[0] >= 1,
            log_fn=lambda s: None)
    e0 = os.path.join(str(tmp_path), "epoch_0")
    assert latest_checkpoint(str(tmp_path)) == e0 and is_committed(e0)
    assert not os.path.isdir(os.path.join(str(tmp_path), "epoch_1"))


def test_stop_at_epoch_boundary_keeps_that_epochs_save(tmp_path):
    stop = [False]

    def make_batches(epoch):
        def gen():
            yield (np.ones((1, 4), np.float32),)
            stop[0] = True  # lands after the epoch's only window
        return gen()

    with pytest.raises(StopRequested, match="epoch 0 boundary"):
        fit(_state(), _step, _cfg(tmp_path), make_batches, epochs=3,
            should_stop=lambda: stop[0], log_fn=lambda s: None)
    assert is_committed(os.path.join(str(tmp_path), "epoch_0"))


def test_chaos_kill_point(monkeypatch):
    monkeypatch.delenv("IBP_CHAOS_KILL", raising=False)
    chaos_kill_point("window")  # returns
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from improved_body_parts_torch.train.supervisor import "
        "chaos_kill_point\n"
        "chaos_kill_point('pt'); print('one', flush=True)\n"
        "chaos_kill_point('other'); print('two', flush=True)\n"
        "chaos_kill_point('pt'); print('never', flush=True)\n" % REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "IBP_CHAOS_KILL": "pt:2"})
    assert r.returncode == -signal.SIGKILL
    assert "one" in r.stdout and "two" in r.stdout
    assert "never" not in r.stdout


def test_resume_and_topology_policy(tmp_path):
    sup, _ = _sup(tmp_path)
    sup.open_segment()
    assert sup.resume(_state(0.0)) is None
    save_checkpoint(str(tmp_path), _state(2.0), 3, train_loss=1.0,
                    best_loss=1.0)
    state, meta = sup.resume(_state(0.0))
    assert meta["epoch"] == 3
    assert float(state.model.weight[0, 0]) == 2.0
    assert sup._segment_record()["resumed_epoch"] == 3
    here = mesh_topology(device="cpu")
    for stamp in (None, {}, {"devices": 1, "processes": 1}, here):
        for policy in ("refuse", "adjust"):
            assert reshard_on_topology_change(
                state, {"topology": stamp, "epoch": 3}, None, 1, policy,
                "p", device="cpu") == (state, None)
    for stamp in ({"devices": 8}, {"devices": 1, "processes": 2},
                  dict(here, process_count=2, device_count=2)):
        with pytest.raises(TopologyChanged, match="--reshard adjust"):
            reshard_on_topology_change(state, {"topology": stamp}, None, 1,
                                       "refuse", "p", device="cpu")
        got, change = reshard_on_topology_change(
            state, {"topology": stamp, "epoch": 3}, None, 1, "adjust", "p",
            log_fn=lambda s: None, device="cpu")
        assert got is state and change
    with pytest.raises(PartitionRulesChanged, match="ruleset"):
        reshard_on_topology_change(
            state, {"topology": dict(here, partition_rules="0123abcd4567"),
                    "epoch": 3}, None, 1, "adjust", "p", device="cpu")
    save_checkpoint(str(tmp_path), _state(5.0), 4, train_loss=1.0,
                    best_loss=1.0,
                    topology=dict(here, process_count=2, device_count=2))
    refusing = RunSupervisor(str(tmp_path), reshard="refuse",
                             sleep=lambda s: None, log_fn=lambda s: None)
    with pytest.raises(TopologyChanged, match="process_count"):
        refusing.resume(_state(0.0), None, 1, device="cpu")
    state, meta = sup.resume(_state(0.0), None, 1, device="cpu")
    assert meta["epoch"] == 4 and meta["topology_change"] == {
        "process_count": (2, 1), "device_count": (2, 1)}
