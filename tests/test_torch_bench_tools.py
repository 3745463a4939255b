"""The port's measuring tools (``improved_body_parts_torch.cli``'s
``speed_test``, ``perf_audit``, ``train_bench``, ``e2e_bench`` and
``serve_bench``) on the CPU, at ``tiny`` and 64-128 px, each tool's
``main(argv)`` in this process:

- the shared fixtures (``synth_images``, ``planted_maps``) equal the JAX
  tool's (``tools/e2e_bench.py``) array for array on the same seeds, and
  their old import paths (``cli.tta_bench``, ``cli.stream_bench``)
  resolve to the same objects;
- ``FlopCounterMode``'s count of a forward equals the analytic count over
  every ``nn.Conv2d`` and ``nn.Linear`` (``tiny``; one lone conv against
  2·Cin/g·Cout·k²·Ho·Wo·N written out);
- the device-time reading (``utils.profiling.tally``) counts the card's
  kernels and copies and skips the user-annotation ranges a host records
  on the device's track; ``profile_device`` measures nothing on the CPU;
- each artifact is strict JSON with the JAX tool's keys (``perf_audit``
  and ``train_bench`` with the XLA cost keys renamed), every number
  finite, the device metrics null on the CPU;
- ``e2e_bench --planted 2``: the planted people within 1 px in every
  mode; ``serve_bench``: ``hop_conservation_frac`` >= 0.95, and the
  ``--proc-only`` chaos arm resolves every future and respawns;
- the refusals: each JAX artifact name, ``--devices`` above the visible
  cards, and ``--device cuda`` on a host without a card (it raises;
  nothing falls back).

The JAX tools are not run end to end here (one JAX e2e run at ``tiny``,
128 px, 2 images takes over a minute on a CPU); their keys are written
out below as a JAX run of each tool at these flags produces them.
"""
import json
import math
import sys

import numpy as np
import pytest
import torch

from improved_body_parts_torch.cli import (
    e2e_bench,
    fleet_audit,
    perf_audit,
    serve_bench,
    speed_test,
    stream_bench,
    train_bench,
    tta_bench,
)
from improved_body_parts_torch.config import get_config
from improved_body_parts_torch.models import build_model
from improved_body_parts_torch.utils import profiling

sys.path.insert(0, "tests")
sys.path.insert(0, "tools")
import e2e_bench as jax_e2e  # noqa: E402
from improved_body_parts_tpu.config import (  # noqa: E402
    get_config as jax_config,
)
from test_torch_models import one_torch_thread  # noqa: E402,F401

SK = get_config("tiny").skeleton

# the keys a JAX run of each tool writes at the flags used here
JAX_E2E_KEYS = {
    "platform", "config", "size", "images", "planted_people",
    "reference_fps", "full_path_fps", "full_path_ms", "fast_path_fps",
    "pipelined_fps", "decode_workers", "compact_fps",
    "compact_pipelined_fps", "compact_batch_fps", "compact_batch",
    "device_decode_fps", "device_decode_fused",
    "device_decode_host_fallback", "device_decode_batch_fps",
    "device_decode_batch"}
JAX_AUDIT_KEYS = {"platform", "config", "size", "iters", "repeats",
                  "bf16_params", "batches"}
# hlo_gflops_per_step -> gflops_per_step (FlopCounterMode), and
# hlo_gbytes_per_step -> min_gbytes_per_step (a stated floor)
JAX_AUDIT_ENTRY = {"gflops_per_step", "min_gbytes_per_step",
                   "throughput_fps_median", "throughput_fps_best",
                   "repeat_spread_ms", "chained_latency_ms", "chained_fps",
                   "implied_tflops", "implied_hbm_gbps", "flags"}
JAX_TRAIN_KEYS = {"platform", "config", "size", "steps", "repeats",
                  "batches", "device_gt"}
JAX_TRAIN_ENTRY = {"step_ms_median", "imgs_per_sec", "repeat_spread_ms",
                   "gflops_per_step", "min_gbytes_per_step",
                   "implied_tflops", "implied_hbm_gbps"}
JAX_DEVICE_GT = {"batch", "step_ms_median", "imgs_per_sec",
                 "repeat_spread_ms"}
JAX_SERVE_KEYS = {
    "platform", "config", "sizes", "telemetry_events", "serve_devices",
    "occupancy_first", "note", "planted_people", "requests_per_client",
    "max_batch", "max_wait_ms", "max_queue", "decode_workers",
    "bucket_shapes", "decode_ab", "sequential_overlapped",
    "sequential_concurrent", "serve", "sequential", "serve_at_peak_load",
    "batched_beats_sequential", "speedup_at_peak_load",
    "beats_all_sequential_baselines", "recompiles_post_warmup"}
JAX_PROC_KEYS = {"platform", "config", "telemetry_events",
                 "requests_per_client", "note", "proc_ab", "proc_chaos",
                 "recompiles_post_warmup"}
# what the port adds to every artifact: the card and its power limit
# (null on the CPU) and the precision settings
CARD_KEYS = {"device", "power_limit"}


def _strict_load(path):
    """The artifact, refusing NaN / Infinity (strict JSON)."""
    def refuse(name):
        raise ValueError(f"{path}: non-finite {name}")
    with open(path) as f:
        return json.load(f, parse_constant=refuse)


def _numbers(doc):
    if isinstance(doc, dict):
        for v in doc.values():
            yield from _numbers(v)
    elif isinstance(doc, list):
        for v in doc:
            yield from _numbers(v)
    elif isinstance(doc, (int, float)) and not isinstance(doc, bool):
        yield doc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each tool once at a small size on the CPU: {tool: (returned
    document, the artifact read back)}, and the e2e modes' people."""
    tmp = tmp_path_factory.mktemp("bench_tools")
    out = {}
    decoded = {}
    for name, tool, argv in (
            ("e2e", e2e_bench, ["--config", "tiny", "--size", "96",
                                "--boxsize", "128", "--images", "2",
                                "--planted", "2", "--batch", "2"]),
            ("audit", perf_audit, ["--config", "tiny", "--size", "64",
                                   "--batches", "1", "8", "--iters", "2",
                                   "--repeats", "2"]),
            ("train", train_bench, ["--config", "tiny", "--size", "128",
                                    "--batches", "1", "--steps", "1",
                                    "--repeats", "2", "--device-gt"]),
            ("serve", serve_bench, ["--config", "tiny", "--sizes", "96",
                                    "--boxsize", "96", "--requests", "2",
                                    "--clients", "2",
                                    "--baseline-clients", "2",
                                    "--rounds", "1", "--max-batch", "2",
                                    "--telemetry-sink", "none"]),
            ("proc", serve_bench, ["--proc-only", "--proc-rounds", "1",
                                   "--requests", "2",
                                   "--telemetry-sink", "none"])):
        path = str(tmp / f"{name}_torch.json")
        argv = argv + ["--device", "cpu", "--out", path]
        if tool is e2e_bench:
            doc = tool.main(argv, decoded=decoded)
        else:
            doc = tool.main(argv)
        out[name] = (doc, _strict_load(path))
    out["speed"] = speed_test.main(["--config", "tiny", "--size", "64",
                                    "--batch", "2", "--iters", "2",
                                    "--device", "cpu"])
    out["decoded"] = decoded
    return out


# ----------------------------------------------------------- fixtures
@pytest.mark.parametrize("seed", [0, 5])
def test_synth_images_equal_the_jax_tools(seed):
    got = e2e_bench.synth_images(3, 64, np.random.default_rng(seed))
    want = jax_e2e.synth_images(3, 64, np.random.default_rng(seed))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,people,canvas", [(0, 2, 256), (3, 3, 1024)])
def test_planted_maps_equal_the_jax_tools(seed, people, canvas):
    got = e2e_bench.planted_maps(SK, people, np.random.default_rng(seed),
                                 canvas=canvas)
    want = jax_e2e.planted_maps(jax_config("tiny").skeleton, people,
                                np.random.default_rng(seed), canvas=canvas)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_fixtures_keep_their_old_import_paths():
    assert tta_bench.synth_images is e2e_bench.synth_images
    assert stream_bench.planted_maps is e2e_bench.planted_maps
    assert stream_bench.PlantedModel is e2e_bench.PlantedModel


# -------------------------------------------------------------- FLOPs
def _tiny_forward_flops(shape):
    """(FlopCounterMode's, the analytic) count of a ``tiny`` forward."""
    net = build_model(get_config("tiny"), device="cpu")
    x = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        return (perf_audit.counted_flops(lambda: net(x)),
                perf_audit.analytic_flops(net, lambda: net(x)))


def test_flop_counter_equals_the_analytic_count_on_tiny():
    counted, analytic = _tiny_forward_flops((2, 64, 96, 3))
    assert counted == analytic > 0


@pytest.mark.parametrize("cin,cout,k,stride,groups", [
    (3, 8, 3, 1, 1), (8, 6, 1, 2, 1), (8, 8, 3, 1, 4)])
def test_flop_counter_of_a_lone_conv(cin, cout, k, stride, groups):
    conv = torch.nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                           groups=groups)
    x = torch.zeros(2, cin, 9, 11)
    with torch.no_grad():
        counted = perf_audit.counted_flops(lambda: conv(x))
        out = conv(x)
    ho, wo = out.shape[2:]
    want = 2 * (cin // groups) * cout * k * k * ho * wo * 2
    assert counted == want
    assert perf_audit.analytic_flops(conv, lambda: conv(x)) == want


# -------------------------------------------------------- device time
class _Record:
    """A raw kineto record as ``utils.profiling.tally`` reads one."""

    def __init__(self, name, device, ns=0, annotation=False):
        self._name, self._device, self._ns = name, device, ns
        self._annotation = annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def duration_ns(self):
        return self._ns

    def is_user_annotation(self):
        return self._annotation


def test_tally_counts_the_cards_work_and_skips_user_annotations():
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    activity, launches, cuda_launch = profiling.tally([
        _Record("conv_kernel", cuda, 300),
        _Record("conv_kernel", cuda, 200),
        _Record("Memcpy HtoD (Pageable -> Device)", cuda, 50),
        # host ranges over the kernels above: no work of their own
        _Record("Optimizer.step#SGD.step", cuda, 900, annotation=True),
        _Record("DistributedDataParallel.forward", cuda, 700,
                annotation=True),
        _Record("cudaLaunchKernel", cpu),
        _Record("cudaLaunchKernelExC", cpu),
        _Record("cuLaunchKernel", cpu),
        _Record("aten::conv2d", cpu, 5000)])
    assert activity == {"conv_kernel": [500, 2],
                        "Memcpy HtoD (Pageable -> Device)": [50, 1]}
    assert (launches, cuda_launch) == (3, 1)
    window = profiling.DeviceWindow(activity, launches, cuda_launch, 1.0,
                                    None)
    assert window.device_ns == 550 and window.kernels == 2


def test_profile_device_measures_nothing_on_the_cpu():
    calls = []
    got = profiling.profile_device(lambda: calls.append(1),
                                   torch.device("cpu"))
    assert got == dict.fromkeys(("device_ms", "kernels", "launch_calls",
                                 "cuda_launch_kernel"))
    assert calls == []


def test_speed_test_has_no_bf16_params_alias(capsys):
    with pytest.raises(SystemExit) as exc:
        speed_test.main(["--bf16-params", "--device", "cpu"])
    assert exc.value.code == 2
    assert "unrecognized arguments: --bf16-params" in capsys.readouterr().err


# ---------------------------------------------------------- artifacts
@pytest.mark.parametrize("name", ["e2e", "audit", "train", "serve",
                                  "proc"])
def test_artifact_is_what_main_returned_and_finite(runs, name):
    doc, written = runs[name]
    assert json.loads(json.dumps(doc, allow_nan=False)) == written
    assert all(math.isfinite(v) for v in _numbers(written))
    assert written["platform"] == "cpu" and written["device"] == "cpu"
    assert written["power_limit"] is None


def test_e2e_keys_are_the_jax_tools(runs):
    _, doc = runs["e2e"]
    assert set(doc) == JAX_E2E_KEYS | CARD_KEYS | {"precision"}
    assert doc["device_decode_fused"] == 2
    assert doc["device_decode_host_fallback"] == 0


@pytest.mark.parametrize("mode", e2e_bench.MODES)
def test_e2e_planted_people_within_a_pixel(runs, mode):
    decoded = runs["decoded"]
    joints = decoded["planted_joints"]
    assert joints.shape == (2, SK.num_parts, 2)
    assert len(decoded[mode]) == 2
    for people in decoded[mode]:
        assert e2e_bench.planted_gap(SK, people, joints) <= 1.0


def test_perf_audit_keys_flops_and_device_metrics(runs):
    _, doc = runs["audit"]
    assert JAX_AUDIT_KEYS | CARD_KEYS | {"precision"} <= set(doc)
    assert set(doc["batches"]) == {"1", "8"}
    for b, entry in doc["batches"].items():
        assert JAX_AUDIT_ENTRY <= set(entry)
        assert entry["flops_per_step"] == entry["analytic_flops_per_step"]
        assert entry["flags"] == []
        assert entry["device_ms"] is None            # not measured: CPU
        assert ("vs_baseline" in entry) == (b == "8")
    one, eight = doc["batches"]["1"], doc["batches"]["8"]
    assert eight["flops_per_step"] == 8 * one["flops_per_step"]
    assert eight["vs_baseline"] == pytest.approx(
        eight["chained_fps"] / perf_audit.BASELINE_FPS, abs=1e-3)


def test_train_bench_keys_and_layer_figures(runs):
    _, doc = runs["train"]
    assert JAX_TRAIN_KEYS | CARD_KEYS | {"precision"} <= set(doc)
    entry = doc["batches"]["1"]
    assert JAX_TRAIN_ENTRY <= set(entry)
    # the backward's convolutions are counted beside the forward's
    forward, _ = _tiny_forward_flops((1, 128, 128, 3))
    assert entry["flops_per_step"] > 2 * forward
    assert entry["focal_fwd_launches_per_step"] == 0  # plain on the CPU
    assert entry["cuda_launch_kernel_per_step"] is None
    assert set(doc["device_gt"]) == JAX_DEVICE_GT
    assert doc["device_gt"]["batch"] == 1


def test_serve_bench_keys_and_hop_conservation(runs):
    _, doc = runs["serve"]
    assert JAX_SERVE_KEYS | CARD_KEYS | {"precision"} <= set(doc)
    assert doc["serve_at_peak_load"]["hop_conservation_frac"] >= 0.95
    for arm in doc["serve"]:
        assert arm["hop_conservation_frac"] >= 0.95
    assert doc["decode_ab"]["decode_fused"] > 0
    assert doc["recompiles_post_warmup"] == 0


def test_serve_bench_proc_only_chaos_resolves_and_respawns(runs):
    _, doc = runs["proc"]
    assert JAX_PROC_KEYS | CARD_KEYS <= set(doc)
    chaos = doc["proc_chaos"]
    assert chaos["all_futures_resolved"] and chaos["respawned"]
    assert chaos["resolved"] == chaos["in_flight_at_kill"]
    assert doc["proc_ab"]["predictor"]["spec"] == serve_bench.GIL_SPEC


def test_speed_test_reports_a_finite_rate(runs):
    out = runs["speed"]
    assert out["imgs_per_sec"] > 0 and math.isfinite(out["ms_per_iter"])
    assert out["precision"]["autocast_dtype"] == "bfloat16"


def test_speed_test_fp32_turns_autocast_off():
    out = speed_test.main(["--config", "tiny", "--size", "64", "--batch",
                           "1", "--iters", "1", "--fp32", "--device",
                           "cpu"])
    assert out["precision"]["autocast_dtype"] == "float32"
    assert out["precision"]["params_dtype"] == "float32"


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("tool,name", [
    (perf_audit, "PERF_AUDIT.json"), (perf_audit, "PERF_AUDIT_BF16.json"),
    (train_bench, "TRAIN_BENCH.json"), (e2e_bench, "E2E_BENCH.json"),
    (serve_bench, "SERVE_BENCH.json"), (serve_bench, "PROC_BENCH.json")])
def test_refuses_the_jax_tools_artifact(tmp_path, tool, name):
    with pytest.raises(SystemExit, match="JAX tool's artifact"):
        tool.main(["--device", "cpu", "--out", str(tmp_path / name)])
    assert not (tmp_path / name).exists()


def test_serve_bench_refuses_more_cards_than_visible(tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--devices 2: only 1 CUDA"):
        serve_bench.main(["--devices", "2", "--out",
                          str(tmp_path / "s.json")])


@pytest.mark.parametrize("tool", [speed_test, perf_audit, train_bench,
                                  e2e_bench, serve_bench])
def test_cuda_without_a_card_raises(tmp_path, tool):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--config", "tiny", "--out", str(tmp_path / "x.json")]
                  if tool is not speed_test else ["--config", "tiny"])


@pytest.mark.parametrize("tool", [speed_test, perf_audit, train_bench,
                                  e2e_bench, serve_bench, fleet_audit])
def test_help(tool, capsys):
    with pytest.raises(SystemExit) as exc:
        tool.main(["--help"])
    assert exc.value.code == 0
    assert "--device" in capsys.readouterr().out
