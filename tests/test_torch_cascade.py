"""The port's cascade (``improved_body_parts_torch.serve.cascade``) held to
the JAX package's, on the CPU.

- ``EscalationPolicy`` gives the JAX package's decision on a grid of
  signals and policies; ``device_signals`` the JAX signals of one
  payload; ``CascadeMetrics`` the JAX exposition text, byte for byte.
- A tiny student -> teacher cascade in both packages: the ``tiny`` IMHN
  on weights converted from one seeded Flax tree, behind a planted-maps
  wrapper (the JAX package's ``tools/cascade_bench.py``
  ``TieredPlantedModel`` and the port's ``cli.cascade_bench``
  ``TieredPlantedModel``): dark frames carry
  one planted person, bright ones two on the student, one on the
  teacher.  With ``max_people=1`` the same frames escalate in both
  packages, each answer equals its tier's direct answer, and the port's
  answers equal the JAX package's (counts exactly, coordinates and
  scores within 1e-4).
- A teacher that sheds or fails degrades to the student's answer;
  ``DeadlineExceeded`` propagates; warmup covers both tiers.
"""
import functools
import importlib
import os
import sys
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import improved_body_parts_torch.serve as tserve
import improved_body_parts_tpu.serve as jserve
from improved_body_parts_torch import config as tconfig

tdecode = importlib.import_module("improved_body_parts_torch.infer.decode")
jdecode = importlib.import_module("improved_body_parts_tpu.infer.decode")

sys.path.insert(0, "tests")
sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "tools"))
from test_torch_models import _seeded_flax, one_torch_thread  # noqa: E402,F401

CFG = tconfig.get_config("tiny")
SK = CFG.skeleton
SIZE = 128
DARK = np.zeros((SIZE, SIZE, 3), np.uint8)
BRIGHT = np.full((SIZE, SIZE, 3), 255, np.uint8)


# --------------------------------------------------------------------- #
# escalation policy, signals, metrics                                   #
# --------------------------------------------------------------------- #
def _grid():
    for n in (0, 1, 4, 5, 9):
        for flags in ((False, False, False), (True, False, False),
                      (False, True, False), (False, False, True)):
            for score in (0.0, 0.1, 1.4999, 1.5, 2.0, float("inf")):
                yield (n, *flags, score, not any(flags))


@pytest.mark.parametrize("policy", [
    dict(max_people=4), dict(max_people=100),
    dict(max_people=4, escalate_on_overflow=False),
    dict(max_people=100, score_floor=1.5),
    dict(max_people=1, score_floor=1.5)])
def test_escalation_policy_matches_jax_on_a_grid(policy):
    jp, tp = jserve.EscalationPolicy(**policy), \
        tserve.EscalationPolicy(**policy)
    reasons = set()
    for sig in _grid():
        want = jp.reason(jdecode.EscalationSignals(*sig))
        got = tp.reason(tdecode.EscalationSignals(*sig))
        assert got == want, sig
        reasons.add(got)
    assert len(reasons) >= 2        # the grid crosses a boundary


def test_device_signals_reads_masked_people_only():
    n = SK.num_parts
    subset = np.zeros((4, n + 2, 2), np.float32)
    subset[0, n, 0], subset[0, n + 1, 0] = 6.0, 3.0
    subset[1, n, 0], subset[1, n + 1, 0] = 1.0, 2.0
    subset[2, n, 0], subset[2, n + 1, 0] = 0.1, 1.0
    mask = np.array([True, True, False, False])
    kw = dict(subset=subset, mask=mask, n_people=2, peak_overflow=False,
              cand_overflow=True, person_overflow=False, compact=None)
    for m in (mask, np.zeros(4, bool)):
        got = tdecode.device_signals(tdecode.DeviceDecoded(
            **dict(kw, mask=m)))
        want = jdecode.device_signals(jdecode.DeviceDecoded(
            **dict(kw, mask=m)))
        assert tuple(got) == tuple(want)
    assert got.min_mean_score == float("inf")


def test_cascade_metrics_exposition_names():
    """The same routing events give the JAX exposition, byte for byte."""
    from improved_body_parts_torch.obs import Registry as TRegistry
    from improved_body_parts_tpu.obs import Registry as JRegistry

    texts = []
    for serve, registry in ((jserve, JRegistry), (tserve, TRegistry)):
        reg = registry()
        m = serve.CascadeMetrics().register_into(reg)
        for _ in range(3):
            m.on_submit()
        m.on_escalate("people")
        m.on_answer("teacher")
        m.on_answer("student")
        m.on_fail()
        texts.append(reg.prometheus())
        assert m.conservation()["exact"]
    assert texts[1] == texts[0]
    assert 'cascade_escalations_total{reason="people"} 1.0' in texts[1]
    assert "cascade_escalation_rate 0.5" in texts[1]


# --------------------------------------------------------------------- #
# the tiny two-tier pair                                                #
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _weights():
    """The tiny IMHN's seeded Flax tree and the port's model on it."""
    from improved_body_parts_torch.models import (
        build_model,
        load_flax_variables,
    )

    jmodel, variables = _seeded_flax(CFG, SIZE, SIZE, seed=3)
    model = build_model(CFG, dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    return jmodel, variables, model.eval()


@functools.lru_cache(maxsize=None)
def _plants():
    """Planted maps of one and of two people on the stride-4 grid, with
    1e-3 of seeded uniform noise (keeps near-ties out of the NMS)."""
    from cascade_bench import plant_people

    rng = np.random.default_rng(3)
    out = {}
    for name, n in (("one", 1), ("two", 2)):
        maps, _ = plant_people(SK, n, rng, SIZE)
        noise = np.random.default_rng(n).uniform(0, 1e-3, maps.shape)
        out[name] = (maps + noise).astype(np.float32)
    return out


def tier_predictors(kinds, replicas=1):
    """([JAX predictors], [port predictors]), ``replicas`` of each, whose
    dark frames see the ``kinds[0]`` planted maps and bright frames the
    ``kinds[1]`` ones ("one" or "two" people)."""
    from cascade_bench import TieredPlantedModel

    from improved_body_parts_tpu.config import InferenceModelParams
    from improved_body_parts_tpu.infer import Predictor as JPredictor
    from improved_body_parts_torch.cli import cascade_bench as port_bench
    from improved_body_parts_torch.infer import Predictor

    jmodel, variables, model = _weights()
    easy, hard = (_plants()[k] for k in kinds)
    jpreds = [JPredictor(TieredPlantedModel(jmodel, easy, hard, SK),
                         variables, SK, model_params=InferenceModelParams(
                             boxsize=SIZE, max_downsample=64), bucket=64)
              for _ in range(replicas)]
    tpreds = [Predictor(port_bench.TieredPlantedModel(model, easy, hard,
                                                      SK), SK,
                        model_params=tconfig.InferenceModelParams(
                            boxsize=SIZE, max_downsample=64), bucket=64,
                        device="cpu") for _ in range(replicas)]
    return jpreds, tpreds


@pytest.fixture(scope="module")
def tiers(one_torch_thread):
    """{package: (student predictor, teacher predictor)}."""
    sj, st = tier_predictors(("one", "two"))
    tj, tt = tier_predictors(("one", "one"))
    return {"jax": (sj[0], tj[0]), "torch": (st[0], tt[0])}


def _frames():
    from cascade_bench import make_images

    easy, hard = make_images(SIZE, 2, np.random.default_rng(5))
    return [DARK, BRIGHT] + [f for pair in zip(easy, hard) for f in pair]


def _close(got, want, atol):
    assert len(got) == len(want)
    for (gk, gs), (wk, ws) in zip(got, want):
        assert abs(gs - ws) <= atol
        for a, b in zip(gk, wk):
            assert (a is None) == (b is None)
            if a is not None:
                assert abs(a[0] - b[0]) <= atol and abs(a[1] - b[1]) <= atol


def test_easy_from_student_hard_from_teacher(tiers):
    """Dark frames are answered by the student (one person), bright ones
    escalate and come back from the teacher (one person, where the
    student saw two): the escalated frames are those whose direct
    student signals trip the policy, the same frames in both packages,
    each answer equals its tier's direct one, and the port's answers
    equal the JAX package's."""
    frames = _frames()
    answers, escalated = {}, {}
    for name, serve in (("jax", jserve), ("torch", tserve)):
        student, teacher = tiers[name]
        decode = tdecode if name == "torch" else jdecode
        policy = serve.EscalationPolicy(max_people=1)
        direct = []
        for f in frames:
            sd = student.predict_decoded(f)
            if policy.reason(decode.device_signals(sd)) is None:
                direct.append((False, decode.decode_device(sd, SK)))
            else:
                direct.append((True, decode.decode_device(
                    teacher.predict_decoded(f), SK)))
        cascade = serve.CascadeEngine.build(student, teacher,
                                            policy=policy, max_batch=1,
                                            use_native=False)
        with cascade:
            cascade.warmup([(SIZE, SIZE)], batch_sizes=(1,))
            got = [cascade.submit(f).result(timeout=120) for f in frames]
        snap = cascade.metrics.snapshot()
        escalated[name] = [e for e, _ in direct]
        assert snap["escalated_teacher"] == sum(escalated[name])
        assert snap["answered_student"] == len(frames) - sum(
            escalated[name])
        assert snap["failed"] == snap["depth"] == 0
        assert cascade.metrics.conservation()["exact"]
        for g, (_, want) in zip(got, direct):
            _close(g, want, atol=1e-4)
        answers[name] = got
    assert escalated["torch"] == escalated["jax"] == [False, True] * 3
    assert [len(a) for a in answers["torch"]] == [1] * len(frames)
    for g, w in zip(answers["torch"], answers["jax"]):
        _close(g, w, atol=1e-4)


class _FakeTeacher:
    """Duck-typed teacher engine with scripted submit behaviour."""

    def __init__(self, behavior):
        self.behavior = behavior
        self.emit_signals = False

    def start(self):
        return self

    def stop(self, drain_timeout_s=None):
        pass

    def warmup(self, *a, **kw):
        return {"newly_compiled": 0}

    def submit(self, image, deadline_s=None):
        return self.behavior(image, deadline_s)


def test_teacher_failure_mid_flight_degrades_deadline_propagates(tiers):
    """A teacher that sheds, then one that fails mid-flight, delivers the
    student's answer (two people); a teacher DeadlineExceeded
    propagates; the routing counts equal the JAX package's."""
    out = {}
    for name, serve in (("jax", jserve), ("torch", tserve)):
        student, _ = tiers[name]
        calls = {"n": 0}

        def teacher(image, deadline_s=None, serve=serve):
            calls["n"] += 1
            if calls["n"] == 1:
                raise serve.ServerOverloaded("teacher full")
            f = Future()
            f.set_exception(RuntimeError("teacher died mid-batch")
                            if calls["n"] == 2
                            else serve.DeadlineExceeded("too late"))
            return f

        server = serve.DynamicBatcher(
            student, max_batch=1, use_native=False, emit_signals=True,
            metrics=serve.ServeMetrics(model="student"))
        cascade = serve.CascadeEngine(server, _FakeTeacher(teacher),
                                      policy=serve.EscalationPolicy(
                                          max_people=1))
        with cascade:
            cascade.student.warmup([(SIZE, SIZE)], batch_sizes=(1,))
            shed = cascade.submit(BRIGHT).result(timeout=120)
            failed = cascade.submit(BRIGHT).result(timeout=120)
            with pytest.raises(serve.DeadlineExceeded):
                cascade.submit(BRIGHT).result(timeout=120)
        snap = cascade.metrics.snapshot()
        assert len(shed) == len(failed) == 2
        out[name] = (snap["degraded_student_answer"], snap["failed"],
                     snap["escalated_teacher"], snap["escalations"])
        _close(failed, shed, atol=0.0)
    assert out["torch"] == out["jax"] == (2, 1, 0, {
        "overflow": 0, "people": 3, "score": 0})


def test_warmup_covers_both_tiers_and_drain_rejects(tiers):
    for name, serve in (("jax", jserve), ("torch", tserve)):
        student, teacher = tiers[name]
        cascade = serve.CascadeEngine.build(
            student, teacher, policy=serve.EscalationPolicy(max_people=1),
            max_batch=2, use_native=False)
        with cascade:
            warm = cascade.warmup([(SIZE, SIZE)], batch_sizes=(1,))
            assert set(warm) == {"student", "teacher"}
            again = cascade.warmup([(SIZE, SIZE)], batch_sizes=(1,))
            assert again["student"]["newly_compiled"] == 0
            assert again["teacher"]["newly_compiled"] == 0
        cascade._draining = True
        with pytest.raises(serve.ServerOverloaded):
            cascade.submit(DARK)
    with pytest.raises(ValueError, match="emit_signals"):
        tserve.CascadeEngine(tserve.DynamicBatcher(tiers["torch"][0]),
                             _FakeTeacher(None))


def test_emit_signals_plumbing(tiers):
    """emit_signals=True resolves futures to (skeletons, signals), equal
    to the JAX package's; the knob needs the device-decode lane."""
    got = {}
    for name, serve in (("jax", jserve), ("torch", tserve)):
        student, _ = tiers[name]
        with pytest.raises(ValueError):
            serve.DynamicBatcher(student, device_decode=False,
                                 emit_signals=True)
        with serve.DynamicBatcher(student, max_batch=1, use_native=False,
                                  emit_signals=True) as server:
            server.warmup([(SIZE, SIZE)], batch_sizes=(1,))
            got[name] = [server.submit(f).result(timeout=120)
                         for f in (DARK, BRIGHT)]
    for (tp, ts), (jp, js) in zip(got["torch"], got["jax"]):
        assert (ts.n_people, ts.peak_overflow, ts.cand_overflow,
                ts.person_overflow, ts.fused) == (
            js.n_people, js.peak_overflow, js.cand_overflow,
            js.person_overflow, js.fused)
        assert ts.min_mean_score == pytest.approx(js.min_mean_score,
                                                  abs=1e-4)
        _close(tp, jp, atol=1e-4)
    assert [s.n_people for _, s in got["torch"]] == [1, 2]


def test_cascade_predictors_pair_on_the_cpu():
    """``cascade_predictors`` builds a cheap-storage student under a
    full-precision teacher, on the CPU when asked (it raises for the
    card where there is none)."""
    student, teacher = tserve.cascade_predictors(
        "tiny", "tiny", student_dtype="int8", teacher_dtype="fp32",
        boxsize=SIZE, bucket=64, device="cpu")
    assert student.device.type == teacher.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.checkpoint_predictor("tiny", device="cuda")
