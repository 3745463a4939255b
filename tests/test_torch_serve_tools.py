"""The port's serving tools (``improved_body_parts_torch.cli``'s
``cascade_bench`` and ``tta_bench --ab``'s gate) and its artifact names,
on the CPU at ``tiny`` / ``tiny_student``, 64-128 px, each tool's
``main(argv)`` in this process:

- ``plant_people`` and ``make_images`` equal ``tools/cascade_bench.py``'s
  array for array on several seeds and people counts, and the stream's
  hard frames and each slice's indices are the JAX tool's;
- ``TieredPlantedModel`` against the JAX shim on the same inputs (a dark
  and a bright image, straight and mirror lanes): the planted part bit
  for bit (both shims over a network that outputs zeros), and over the
  ``tiny`` IMHN at 64 px on weights carried across by
  ``models.convert`` within 1e-3 x the forward's tolerance (rtol 1e-4,
  atol 1e-5) plus the rounding of the sum;
- ``cascade_bench.main`` at 128 px, 1 round of 2 clients x 2 requests:
  the artifact strict JSON with the JAX tool's keys plus the card stamp,
  the ledger exact, escalations equal to the hard frames submitted, AP
  within tolerance, 0 first runs after warmup;
- ``tta_bench.oks_ap`` equals ``tools/tta_bench.py``'s on equal,
  shifted, missing, extra and empty people;
- ``tta_bench --ab --planted 2`` at ``tiny`` 64 px, 2 images, 1 round:
  payloads equal, AP parity, the gate not binding on the CPU, exit code
  0, the events file holding the round and verdict events; the exit rule
  on made-up reports, a binding gate under its ratio failing;
- the JAX tools' artifact names (``TTA.json``, ``TTA_AB.json``,
  ``TTA_AB_events.jsonl``, ``CASCADE_BENCH.json``, ``SYNTH_AP_SWA.json``
  and every ``SYNTH_AP*.json`` of the reference at the repo root) are
  refused before any work, the work's entry patched to fail if reached;
  the port's defaults and the ``*_TORCH_S<n>.json`` names pass;
- ``--device cuda`` without a card raises (``cli.fleet_audit``'s model
  predictor too), and ``--help`` works (also for ``cli.fleet_audit``,
  ``cli.trace_report`` and ``cli.request_report``).
"""
import contextlib
import functools
import glob
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import improved_body_parts_torch
from improved_body_parts_torch.cli import (
    cascade_bench,
    fleet_audit,
    request_report,
    swa_stage,
    synth_ap,
    trace_report,
    tta_bench,
)
from improved_body_parts_torch.config import get_config
from improved_body_parts_torch.obs.events import strict_dumps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, os.path.join(REPO, "tools"))
import cascade_bench as jax_cascade  # noqa: E402  (tools/cascade_bench.py)
import tta_bench as jax_tta  # noqa: E402  (tools/tta_bench.py)
from improved_body_parts_tpu.config import (  # noqa: E402
    get_config as jax_config,
)
from test_torch_models import _seeded_flax, one_torch_thread  # noqa: E402,F401

SK, JSK = get_config("tiny").skeleton, jax_config("tiny").skeleton

# the keys a JAX run of tools/cascade_bench.py writes (:332-453)
JAX_CASCADE_KEYS = {
    "platform", "student_config", "teacher_config", "size",
    "hard_frac_requested", "hard_frac_stream", "easy_people",
    "hard_people", "policy", "clients", "requests_per_slice", "rounds",
    "max_batch", "max_wait_ms", "note", "warmup", "hops_ms",
    "hop_conservation_frac", "quality", "cascade_imgs_per_sec",
    "teacher_only_imgs_per_sec", "cascade_p95_ms", "teacher_only_p95_ms",
    "shed_retries_total", "per_round_ratio", "median_round_ratio",
    "target_ratio", "cascade_beats_target", "cascade_routing",
    "cascade_conservation", "escalation_rate", "recompiles_post_warmup"}
JAX_CASCADE_VERDICT = {"median_round_ratio", "cascade_beats_target",
                       "escalation_rate", "ap_within_tolerance",
                       "cascade_conservation_exact",
                       "recompiles_post_warmup"}
# the keys a JAX run of tools/tta_bench.py --ab writes (:204-301)
JAX_AB_KEYS = {
    "platform", "config", "images", "size", "boxsize", "planted_people",
    "scale_search", "rotation_search", "grid_entries", "rounds",
    "params_dtype", "telemetry_events", "payload_equal_all_images",
    "ap_parity", "rounds_detail", "per_round_fused_speedup",
    "median_fused_speedup", "fused_speedup_gate",
    "fused_speedup_gate_binding", "fused_speedup_sustained",
    "median_fused_dispatches_per_image",
    "median_looped_dispatches_per_image", "fused_arm_recompile_delta_total",
    "looped_arm_recompile_delta_total", "recompiles_post_warmup"}
CARD_KEYS = {"device", "power_limit"}

# the reference's SYNTH_AP artifacts at the repo root (a port run's
# _TORCH artifact, where one was left there, is not the JAX tool's)
JAX_SYNTH_AP = sorted(
    name for name in map(os.path.basename,
                         glob.glob(os.path.join(REPO, "SYNTH_AP*.json")))
    if "_TORCH" not in name)


def _strict_load(path):
    """The artifact, refusing NaN / Infinity (strict JSON)."""
    def refuse(name):
        raise ValueError(f"{path}: non-finite {name}")
    with open(path) as f:
        return json.load(f, parse_constant=refuse)


def _run(main, argv):
    """(main's return or its SystemExit code, its standard output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            result = main(argv)
        except SystemExit as e:
            result = e.code
    return result, out.getvalue()


# --------------------------------------------------------------------- #
# the synthetic fixtures                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,people,canvas", [
    (0, 2, 128), (1, 6, 128), (2, 1, 64), (3, 6, 256)])
def test_plant_people_equals_jax(seed, people, canvas):
    maps, gts = cascade_bench.plant_people(
        SK, people, np.random.default_rng(seed), canvas)
    jmaps, jgts = jax_cascade.plant_people(
        JSK, people, np.random.default_rng(seed), canvas)
    assert maps.dtype == jmaps.dtype and np.array_equal(maps, jmaps)
    assert len(gts) == len(jgts) == people
    for got, want in zip(gts, jgts):
        assert np.array_equal(got["keypoints"], want["keypoints"])
        assert got["area"] == want["area"]


@pytest.mark.parametrize("seed,size", [(0, 128), (5, 64), (9, 96)])
def test_make_images_equals_jax(seed, size):
    got = cascade_bench.make_images(size, 3, np.random.default_rng(seed))
    want = jax_cascade.make_images(size, 3, np.random.default_rng(seed))
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        assert all(a.dtype == np.uint8 and np.array_equal(a, b)
                   for a, b in zip(g, w))


@pytest.mark.parametrize("hard_frac", [0.25, 0.1, 0.5])
def test_stream_layout_is_the_jax_interleave(hard_frac):
    """``tools/cascade_bench.py``'s inline Bresenham interleave (:310-320)
    written out: the same frames are hard."""
    n_stream = 16
    n_hard = max(1, round(hard_frac * n_stream))
    want = [(i + 1) * n_hard // n_stream > i * n_hard // n_stream
            for i in range(n_stream)]
    assert cascade_bench.stream_layout(hard_frac) == want
    assert sum(want) == n_hard


def test_slice_indices_are_what_run_slice_submits():
    from concurrent.futures import Future

    stream = list(range(16))
    seen = []

    def submit(img):
        seen.append(img)
        fut = Future()
        fut.set_result([])
        return fut

    cascade_bench.run_slice(submit, stream, 3, 5)
    assert sorted(seen) == sorted(cascade_bench.slice_indices(3, 5, 16))


# --------------------------------------------------------------------- #
# the tiered shim against the JAX package's                             #
# --------------------------------------------------------------------- #
class _Zeros(torch.nn.Module):
    """A network whose last-stack output is zeros (its shape the tiny
    IMHN's at stride 4)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))

    def forward(self, imgs):
        n, h, w, _ = imgs.shape
        return [[torch.zeros((n, h // 4, w // 4, SK.num_layers))]]


class _JaxZeros:
    def apply(self, variables, imgs, train=False):
        import jax.numpy as jnp

        n, h, w, _ = imgs.shape
        return [[jnp.zeros((n, h // 4, w // 4, JSK.num_layers))]]


def _lanes(size=64):
    """[dark, bright, dark mirrored, bright mirrored] in [0, 1], as the
    predictor hands its model the [image..., mirror...] lanes."""
    rng = np.random.default_rng(7)
    easy, hard = cascade_bench.make_images(size, 1, rng)
    imgs = np.stack([easy[0], hard[0]]).astype(np.float32) / 255.0
    return np.concatenate([imgs, imgs[:, :, ::-1]], axis=0)


def _both_shims(tnet, jnet, variables, easy, hard, lanes):
    """(port output, JAX output, the port network's raw last-stack
    output) of the two packages' tiered shims over ``tnet`` / ``jnet``."""
    import jax

    shim = cascade_bench.TieredPlantedModel(tnet, easy, hard, SK)
    with torch.no_grad():
        got = shim(torch.from_numpy(lanes))[0][0].numpy()
        raw = tnet(torch.from_numpy(lanes))[-1][0].numpy()
    jshim = jax_cascade.TieredPlantedModel(jnet, easy, hard, JSK)
    # one jitted program: the JAX forward op by op takes seconds
    want = np.asarray(jax.jit(lambda v, x: jshim.apply(v, x)[0][0])(
        variables, lanes))
    return got, want, raw


@functools.lru_cache(maxsize=None)
def _shim_outputs():
    """{"zeros" | "tiny": :func:`_both_shims` over :func:`_lanes`}."""
    from improved_body_parts_torch.models import (
        build_model,
        load_flax_variables,
    )

    rng = np.random.default_rng(11)
    easy, _ = cascade_bench.plant_people(SK, 2, rng, 128)
    hard, _ = cascade_bench.plant_people(SK, 6, rng, 128)
    lanes = _lanes()
    jmodel, variables = _seeded_flax(get_config("tiny"), 64, 64, seed=4)
    model = build_model(get_config("tiny"), dtype=torch.float32,
                        device="cpu")
    load_flax_variables(model, variables)
    return {"zeros": _both_shims(_Zeros(), _JaxZeros(), variables, easy,
                                 hard, lanes),
            "tiny": _both_shims(model.eval(), jmodel, variables, easy, hard,
                                lanes)}


@pytest.mark.parametrize("lane", range(4),
                         ids=["dark", "bright", "dark_mirror",
                              "bright_mirror"])
def test_tiered_shim_plants_the_jax_maps_exactly(lane):
    got, want, _ = _shim_outputs()["zeros"]
    assert got.shape == want.shape == (4, 16, 16, SK.num_layers)
    assert np.array_equal(got[lane], want[lane])
    # bright lanes carry the hard crowd, dark ones the easy crowd
    assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("lane", range(4),
                         ids=["dark", "bright", "dark_mirror",
                              "bright_mirror"])
def test_tiered_shim_over_tiny_matches_jax(lane):
    got, want, raw = _shim_outputs()["tiny"]
    # the forward's tolerance (rtol 1e-4, atol 1e-5) at 1e-3, the port's
    # raw output standing for the JAX one (the two within that tolerance),
    # and the sum's rounding
    bound = (1e-3 * (1e-5 + 1e-4 * np.abs(raw[lane]))
             + 2 * np.spacing(np.abs(want[lane]).astype(np.float32)))
    assert (np.abs(got[lane] - want[lane]) <= bound).all()
    planted, jplanted, _ = _shim_outputs()["zeros"]
    # the network's term is there, at 1e-3 of its output
    assert not np.array_equal(got[lane], planted[lane])
    assert np.abs(got[lane] - planted[lane]).max() <= 1e-3 * (
        np.abs(raw[lane]).max() * 1.001 + 1e-5) + 1e-6


# --------------------------------------------------------------------- #
# cascade_bench end to end on the CPU                                   #
# --------------------------------------------------------------------- #
CASCADE_ARGV = ["--student-config", "tiny_student", "--teacher-config",
                "tiny", "--size", "128", "--rounds", "1", "--clients", "2",
                "--requests", "2", "--max-batch", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def cascade_run(tmp_path_factory, one_torch_thread):  # noqa: F811
    path = str(tmp_path_factory.mktemp("cascade") / "cascade_torch.json")
    report, stdout = _run(cascade_bench.main,
                          CASCADE_ARGV + ["--out", path])
    return report, _strict_load(path), stdout


def test_cascade_artifact_has_the_jax_keys(cascade_run):
    report, artifact, _ = cascade_run
    assert set(artifact) == JAX_CASCADE_KEYS | CARD_KEYS
    assert artifact == json.loads(strict_dumps(report))
    assert artifact["device"] == "cpu" and artifact["power_limit"] is None
    assert artifact["platform"] == "cpu"


def test_cascade_closing_line_has_the_jax_verdict_keys(cascade_run):
    _, artifact, stdout = cascade_run
    last = json.loads(stdout.strip().splitlines()[-1])
    assert set(last) == JAX_CASCADE_VERDICT
    assert last["median_round_ratio"] == artifact["median_round_ratio"]


def test_cascade_ledger_is_exact(cascade_run):
    cons = cascade_run[1]["cascade_conservation"]
    assert cons["exact"] and cons["depth"] == 0 and cons["failed"] == 0
    assert cons["submitted"] == (cons["answered_student"]
                                 + cons["escalated_teacher"]
                                 + cons["degraded_student_answer"])


def test_cascade_escalates_exactly_the_hard_frames(cascade_run):
    art = cascade_run[1]
    clients = art["clients"]
    layout = cascade_bench.stream_layout(art["hard_frac_requested"])
    hard = art["rounds"] * sum(layout[j] for j in cascade_bench.slice_indices(
        clients, art["requests_per_slice"] // clients, len(layout)))
    routing = art["cascade_routing"]
    assert hard >= 1
    assert routing["escalated_teacher"] == hard
    assert routing["escalations"] == {"overflow": 0, "people": hard,
                                      "score": 0}
    assert routing["submitted"] == art["requests_per_slice"] * art["rounds"]
    assert routing["escalation_rate"] == round(hard / routing["submitted"],
                                               4)


def test_cascade_quality_within_tolerance(cascade_run):
    quality = cascade_run[1]["quality"]
    assert quality["within_tolerance"] is True
    assert quality["teacher_only_synthetic_ap"] > 0.5


def test_cascade_no_first_run_after_warmup(cascade_run):
    art = cascade_run[1]
    assert art["recompiles_post_warmup"] == 0
    assert art["warmup"]["student_newly_compiled"] > 0
    assert art["warmup"]["teacher_only_newly_compiled"] == 0


# --------------------------------------------------------------------- #
# the A/B's AP parity and gate                                          #
# --------------------------------------------------------------------- #
def _people(rng, n, shift=0.0):
    out = []
    for _ in range(n):
        kps = [None if rng.uniform() < 0.2
               else (float(rng.uniform(10, 100)), float(rng.uniform(10, 100)))
               for _ in range(17)]
        out.append((kps, float(rng.uniform(0.5, 1.0))))
    if shift:
        out = [([None if p is None else (p[0] + shift, p[1]) for p in kps],
                s) for kps, s in out]
    return out


def _oks_case(kind):
    rng = np.random.default_rng(len(kind))
    ref = [_people(rng, 2), _people(rng, 3)]
    if kind == "equal":
        return ref, ref
    if kind == "shifted":
        return ref, [[(kps, s) for kps, s in _people(
            np.random.default_rng(len(kind)), 2, shift=3.0)],
            ref[1]]
    if kind == "missing":
        return ref, [ref[0][:1], ref[1]]
    if kind == "extra":
        return ref, [ref[0] + _people(rng, 1), ref[1]]
    return [[], []], [[], []]


@pytest.mark.parametrize("kind", ["equal", "shifted", "missing", "extra",
                                  "empty"])
def test_oks_ap_equals_jax(kind):
    ref, det = _oks_case(kind)
    got = tta_bench.oks_ap(ref, det)
    assert got == jax_tta.oks_ap(ref, det)
    assert (got == 1.0) == (kind in ("equal", "empty"))


AB_ARGV = ["--ab", "--planted", "2", "--config", "tiny", "--size", "64",
           "--num-images", "2", "--rounds", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def ab_run(tmp_path_factory, one_torch_thread):  # noqa: F811
    path = str(tmp_path_factory.mktemp("tta_ab") / "tta_ab_torch.json")
    code, stdout = _run(tta_bench.main, AB_ARGV + ["--out", path])
    return code, _strict_load(path), stdout


def test_ab_payloads_and_ap_parity_equal(ab_run):
    _, art, _ = ab_run
    assert art["payload_equal_all_images"] is True
    assert art["ap_parity"]["equal"] is True
    assert art["ap_parity"]["fused_vs_looped_oks_ap"] == 1.0
    assert sum(art["ap_parity"]["people_per_image"]) > 0


def test_ab_dispatches_and_first_runs(ab_run):
    _, art, _ = ab_run
    assert art["grid_entries"] == 9
    assert art["median_fused_dispatches_per_image"] == 1.0
    assert art["median_looped_dispatches_per_image"] == 10.0
    assert art["recompiles_post_warmup"] == 0
    assert art["fused_arm_recompile_delta_total"] == 0
    assert art["looped_arm_recompile_delta_total"] == 0


def test_ab_gate_does_not_bind_on_the_cpu_and_exits_0(ab_run):
    code, art, stdout = ab_run
    assert art["fused_speedup_gate"] == 1.3
    assert art["fused_speedup_gate_binding"] is False
    assert art["fused_speedup_sustained"] == (
        art["median_fused_speedup"] >= 1.3)
    assert code == 0 and art["ok"] is True
    assert '"ok": true' in stdout


def test_ab_artifact_has_the_jax_keys(ab_run):
    _, art, _ = ab_run
    assert JAX_AB_KEYS | CARD_KEYS <= set(art)
    assert art["boxsize"] == art["size"] == 64
    assert art["planted_people"] == 2


def test_ab_events_hold_the_rounds_and_the_verdict(ab_run):
    _, art, _ = ab_run
    path = art["telemetry_events"]
    assert path.endswith("tta_ab_torch_events.jsonl")
    events = [json.loads(line) for line in open(path) if line.strip()]
    kinds = [e["event"] for e in events]
    assert kinds.count("tta_ab_round") == art["rounds"] == 1
    assert kinds.count("tta_ab_verdict") == 1
    (verdict,) = [e for e in events if e["event"] == "tta_ab_verdict"]
    assert verdict["ap_parity_equal"] is True
    assert verdict["median_fused_speedup"] == art["median_fused_speedup"]


def _made_up_report(speedup=1.0, binding=True, **over):
    report = {"payload_equal_all_images": True, "grid_entries": 9,
              "ap_parity": {"equal": True}, "median_fused_speedup": speedup,
              "rounds_detail": [{arm: {"dispatches_per_image": [d, d],
                                       "recompile_delta": 0}
                                 for arm, d in (("fused", 1),
                                                ("looped", 10))}]}
    tta_bench.gate_verdict(report, 1.3, binding, recompiles_post_warmup=0)
    report.update(over)
    return report


@pytest.mark.parametrize("binding,speedup,ok", [
    (True, 1.0, False), (True, 1.29, False), (True, 1.3, True),
    (False, 1.0, True), (False, 2.0, True)])
def test_gate_fails_the_verdict_only_where_it_binds(binding, speedup, ok):
    report = _made_up_report(speedup, binding)
    assert report["fused_speedup_sustained"] == (speedup >= 1.3)
    assert tta_bench.ab_ok(report) is ok


@pytest.mark.parametrize("over", [
    {"payload_equal_all_images": False}, {"ap_parity": {"equal": False}},
    {"recompiles_post_warmup": 1}, {"median_fused_dispatches_per_image": 2.0},
    {"median_looped_dispatches_per_image": 9.0}])
def test_each_correctness_field_fails_the_verdict(over):
    assert tta_bench.ab_ok(_made_up_report(2.0, False))
    assert not tta_bench.ab_ok(_made_up_report(2.0, False, **over))


# --------------------------------------------------------------------- #
# the artifact names                                                    #
# --------------------------------------------------------------------- #
class Reached(Exception):
    """The patched work entry was called: the refusal did not come
    first."""


def _forbid(monkeypatch, tmp_path):
    """Patch every tool's first piece of work to raise :class:`Reached`,
    in ``tmp_path`` as the working directory."""
    def reached(*args, **kwargs):
        raise Reached

    monkeypatch.chdir(tmp_path)

    import improved_body_parts_torch.cli.evaluate as cli_evaluate
    import improved_body_parts_torch.data.fixture as fixture
    import improved_body_parts_torch.serve.artifacts as artifacts

    monkeypatch.setattr(improved_body_parts_torch, "resolve_device", reached)
    for module, name in ((cascade_bench, "plant_people"),
                         (tta_bench, "ab_main"), (swa_stage, "run_cli"),
                         (synth_ap, "run_cli"), (fixture, "build_fixture"),
                         (artifacts, "checkpoint_predictor"),
                         (cli_evaluate, "load_predictor")):
        monkeypatch.setattr(module, name, reached)


GRID_ARGV = ["--checkpoint", "c", "--anno", "a", "--images", "i"]
SWA_ARGV = ["--workdir", "no_such_workdir"]


@pytest.mark.parametrize("main,argv", [
    (tta_bench.main, GRID_ARGV + ["--out", "TTA.json"]),
    (tta_bench.main, GRID_ARGV + ["--out", "sub/TTA_AB.json"]),
    (tta_bench.main, ["--ab", "--out", "TTA_AB.json"]),
    (tta_bench.main, ["--ab", "--out", "TTA.json"]),
    (tta_bench.main, ["--ab", "--telemetry-sink", "TTA_AB_events.jsonl"]),
    (tta_bench.main, ["--ab", "--out", "runs/TTA_AB_events.jsonl"]),
    (cascade_bench.main, ["--out", "CASCADE_BENCH.json"]),
    (swa_stage.main, SWA_ARGV + ["--out", "SYNTH_AP_SWA.json"]),
], ids=["tta_grid", "tta_grid_subdir", "tta_ab", "tta_ab_grid_name",
        "tta_ab_events", "tta_ab_events_as_out", "cascade", "swa_default"])
def test_jax_artifact_names_refused_before_any_work(monkeypatch, tmp_path,
                                                    main, argv):
    _forbid(monkeypatch, tmp_path)
    with pytest.raises(SystemExit, match="JAX tool's artifact"):
        main(argv)


def test_the_reference_synth_ap_artifacts_are_found():
    assert len(JAX_SYNTH_AP) >= 23
    assert "SYNTH_AP.json" in JAX_SYNTH_AP


@pytest.mark.parametrize("name", JAX_SYNTH_AP)
@pytest.mark.parametrize("tool", ["synth_ap", "swa_stage"])
def test_tracked_synth_ap_artifacts_refused(monkeypatch, tmp_path, tool,
                                            name):
    _forbid(monkeypatch, tmp_path)
    main, argv = ((synth_ap.main, []) if tool == "synth_ap"
                  else (swa_stage.main, SWA_ARGV))
    with pytest.raises(SystemExit, match="JAX tool's artifact"):
        main(argv + ["--out", name])


@pytest.mark.parametrize("main,argv", [
    (synth_ap.main, ["--workdir", "w"]),
    (synth_ap.main, ["--workdir", "w", "--out", "SYNTH_AP_TORCH.json"]),
    (synth_ap.main, ["--workdir", "w", "--out",
                     "SYNTH_AP_DEEP_TORCH_S1.json"]),
    (synth_ap.main, ["--workdir", "w", "--out",
                     "SYNTH_AP_CROWD_UNMASKED_TORCH_S2.json"]),
    (swa_stage.main, []),
    (swa_stage.main, ["--out", "SYNTH_AP_DEEP_SWA_TORCH_S3.json"]),
    (tta_bench.main, GRID_ARGV),
    (tta_bench.main, ["--ab"]),
    (cascade_bench.main, []),
], ids=["synth_ap_default", "synth_ap_torch", "deep_torch_s1",
        "crowd_unmasked_torch_s2", "swa_default", "deep_swa_torch_s3",
        "tta_grid_default", "tta_ab_default", "cascade_default"])
def test_port_names_pass_to_the_work(monkeypatch, tmp_path, main, argv):
    _forbid(monkeypatch, tmp_path)
    if main is swa_stage.main:
        # the workdir check comes after the name's
        argv = argv + SWA_ARGV
        with pytest.raises(SystemExit, match="not a synth_ap workdir"):
            main(argv)
        return
    with pytest.raises(Reached):
        main(argv)


def test_default_artifact_names():
    """The port's names: ``tta_torch.json`` (``tta_ab_torch.json`` under
    ``--ab``, events beside it), ``cascade_bench_torch.json``,
    ``SYNTH_AP_TORCH.json`` and ``SYNTH_AP_SWA_TORCH.json``."""
    assert (tta_bench.GRID_OUT, tta_bench.AB_OUT) == (
        "tta_torch.json", "tta_ab_torch.json")
    assert tta_bench.sink_path(tta_bench.AB_OUT, "auto") == \
        "tta_ab_torch_events.jsonl"
    assert tta_bench.sink_path("x.json", "none") is None
    assert cascade_bench._parser().parse_args([]).out == \
        "cascade_bench_torch.json"
    from improved_body_parts_torch.cli import refuse_synth_ap_artifact

    for name in ("SYNTH_AP_TORCH.json", "SYNTH_AP_SWA_TORCH.json",
                 "SYNTH_AP_DEEP_SWA_TORCH_S2.json", "other.json"):
        refuse_synth_ap_artifact(name)


# --------------------------------------------------------------------- #
# no card, and --help                                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("main,argv", [
    (cascade_bench.main, ["--student-config", "tiny_student",
                          "--teacher-config", "tiny", "--size", "64"]),
    (tta_bench.main, ["--ab", "--config", "tiny", "--size", "64"]),
    (fleet_audit.main, ["--config", "tiny", "--size", "64"])],
    ids=["cascade_bench", "tta_ab", "fleet_audit"])
def test_device_cuda_without_a_card_raises(tmp_path, main, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CPU refusal is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--out", str(tmp_path / "out.json")])
    assert not os.path.exists(tmp_path / "out.json")


@pytest.mark.parametrize("main,flags", [
    (cascade_bench.main, ("--target-ratio", "--ap-tol", "--device")),
    (tta_bench.main, ("--gate", "--planted", "--telemetry-sink")),
    (fleet_audit.main, ("--predictor", "--rounds", "--keep-workdir",
                        "--params-dtype", "--device")),
    (trace_report.main, ("--no-shards", "--json", "--out")),
    (request_report.main, ("--strict", "--min-coverage", "--no-shards",
                           "--top"))],
    ids=["cascade_bench", "tta_bench", "fleet_audit", "trace_report",
         "request_report"])
def test_help_names_the_flags(main, flags):
    code, stdout = _run(main, ["--help"])
    assert code == 0
    for flag in flags:
        assert flag in stdout
