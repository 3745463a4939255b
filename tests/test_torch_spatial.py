"""The port's height-sharded inference (``parallel.spatial``,
``Predictor(mesh=)``, ``shard_batch`` / ``device_prefetch(spatial_shard=
True)``) on spawned gloo ranks of one torch thread, against the
unsharded port and the JAX package.  One group a mesh shape (the rank
bodies are in ``tests/torch_spatial_ranks.py``):

- every layer kind a height shard touches, over 2, 3 and 4 ``'model'``
  ranks, on a 24-row float64 input whose shards on 4 ranks hold 8, 8, 4
  and 4 rows (so the dilated conv's halo of 5 reaches past a neighbour):
  the stride-2 7x7 stem, a dilated 3x3 (d = 5), ``Residual``,
  ``HourglassAE``'s conv, a 1x1, the 2x2 pool, the 2x upsample and
  ``SELayer``, each equal to the unsharded layer within 1e-12;
- every variant's tiny forward over 2 ranks in float64 within 1e-10 of
  its largest value, and the tiny forward at 320 rows over 3 ranks (20
  bottom rows split 7 / 7 / 6); an input of fewer bottom rows than ranks
  refused, naming H, S and M;
- the collectives of one sharded forward of the tiny net: 39 halo
  exchanges, 6 SE means and the gathers;
- ``Predictor(mesh=)`` on the tiny net with weights converted from a
  seeded Flax tree: ``predict`` maps on meshes (1, 2) and (2, 2) within
  JAX's own ``atol=3e-5`` of JAX's ``Predictor(mesh=make_mesh(data=2,
  model=4))`` and of its plain ``Predictor``; ``predict_decoded`` and
  ``predict_compact`` on planted people (fixed maps + 1e-3 noise) equal
  to the JAX plain lanes' payloads (integer fields exactly, floats within
  1e-5), and ``predict_fast`` to the port's plain lane; on a one-rank
  mesh (1, 1) the decoded payload and the maps equal the plain
  predictor's bit for bit; the data-axis and lane refusals carry JAX's
  messages;
- ``shard_batch(spatial_shard=True)`` and ``device_prefetch(
  spatial_shard=True)``: each rank's rows equal its slice of the host
  batch.
"""
import sys

import numpy as np
import pytest

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.models import VARIANTS, build_model, \
    flax_to_state_dict
from improved_body_parts_torch.parallel.spatial import (
    HeightShard,
    split_units,
)

sys.path.insert(0, "tests")
import torch_dist_ranks  # noqa: E402
import torch_spatial_ranks as ranks  # noqa: E402
from test_decode import synth_person_joints  # noqa: E402
from test_torch_models import _seeded_flax  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_slice import (  # noqa: E402
    _JaxMirrorStub,
    _perm,
    _planted_maps,
)
from test_torch_tta import SK, _assert_same_payload, _fields  # noqa: E402

BOX = 128
LAYER_KINDS = [name for name, _, _ in ranks.layer_cases()]


def _payload():
    import torch

    cfg = tconfig.get_config("tiny")
    jmodel, variables = _seeded_flax(cfg, BOX, BOX, seed=3)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    state = {k: v.numpy().copy()
             for k, v in flax_to_state_dict(variables, model).items()}
    rng = np.random.default_rng(5)
    planted = np.zeros((256, 320, 3), np.uint8)
    planted[:, 0, 0] = 255          # the lane marker (torch_spatial_ranks)
    images = np.arange(4 * 48 * 32 * 3, dtype=np.int64).reshape(
        4, 48, 32, 3) % 251
    batch = (images.astype(np.uint8),
             rng.uniform(0, 1, (4, 12, 8, 1)).astype(np.float32),
             rng.uniform(0, 1, (4, 12, 8, 5)).astype(np.float32))
    return dict(
        tiny_state=state, boxsize=BOX, variants=VARIANTS,
        image=rng.integers(0, 255, (BOX, BOX, 3), dtype=np.uint8),
        tall_image=rng.integers(0, 255, (320, 64, 3), dtype=np.uint8),
        planted_maps=_planted_maps([synth_person_joints(40, 40, 180),
                                    synth_person_joints(150, 60, 150)],
                                   h=256, w=320),
        perm=_perm(SK), planted_image=planted, global_batch=batch,
        batch_stride=16), jmodel, variables


@pytest.fixture(scope="module")
def inputs(one_torch_thread):  # noqa: F811
    payload, jmodel, variables = _payload()
    return dict(payload=payload, jmodel=jmodel, variables=variables)


BODIES = {2: ranks.two_ranks, 3: ranks.three_ranks, 4: ranks.four_ranks}


@pytest.fixture(scope="module")
def group2(inputs):
    return torch_dist_ranks.spawn_group(BODIES[2], 2, inputs["payload"])


@pytest.fixture(scope="module")
def group3(inputs):
    return torch_dist_ranks.spawn_group(BODIES[3], 3, inputs["payload"])


@pytest.fixture(scope="module")
def group4(inputs):
    return torch_dist_ranks.spawn_group(BODIES[4], 4, inputs["payload"])


def _group(request, m):
    """{rank: result} of the gloo group of ``m`` ranks."""
    return request.getfixturevalue(f"group{m}")


@pytest.fixture(scope="module")
def jax_side(inputs, eight_devices):
    """JAX's sharded and plain ``predict`` maps of the tiny net, its
    plain lanes on the planted image, and its refusals."""
    from improved_body_parts_tpu.config import (
        InferenceModelParams,
        InferenceParams,
    )
    from improved_body_parts_tpu.infer import Predictor as JPredictor
    from improved_body_parts_tpu.parallel import make_mesh

    p = inputs["payload"]
    kw = dict(params=InferenceParams(scale_search=(1.0,)),
              model_params=InferenceModelParams(boxsize=BOX,
                                                max_downsample=64),
              bucket=64)
    sharded = JPredictor(inputs["jmodel"], inputs["variables"], SK,
                         mesh=make_mesh(data=2, model=4), **kw)
    plain = JPredictor(inputs["jmodel"], inputs["variables"], SK, **kw)
    stub = JPredictor(_JaxMirrorStub(p["planted_maps"]), {}, SK,
                      model_params=InferenceModelParams(
                          boxsize=256, max_downsample=64), bucket=64)
    img = p["planted_image"]
    refused = {}
    for name, call in (
            ("batch", lambda: sharded.predict_decoded_batch([p["image"]])),
            ("grid", lambda: sharded.predict_compact_ms(p["image"])),
            ("replica", lambda: sharded.device_replica(eight_devices[0])),
            ("data", lambda: JPredictor(inputs["jmodel"],
                                        inputs["variables"], SK,
                                        mesh=make_mesh(data=4, model=2),
                                        **kw))):
        with pytest.raises(ValueError) as e:
            call()
        refused[name] = str(e.value)
    return dict(sharded=sharded.predict(p["image"]),
                plain=plain.predict(p["image"]),
                decoded=stub.predict_decoded(img),
                compact=stub.predict_compact(img), refused=refused)


# ------------------------------------------------------------- the split
@pytest.mark.parametrize("height,stride,parts,units", [
    (640, 64, 4, [3, 3, 2, 2]),
    (320, 16, 3, [7, 7, 6]),
    (128, 16, 4, [2, 2, 2, 2]),
    (64, 64, 1, [1]),
])
def test_row_split_deals_bottom_rows_in_rank_order(height, stride, parts,
                                                   units):
    assert split_units(height, stride, parts) == units
    bounds = [HeightShard(units, r, None, stride).rows
              for r in range(parts)]
    assert [(b - a) // stride for a, b in bounds] == units
    assert bounds[0][0] == 0 and bounds[-1][1] == height
    assert all(a % stride == 0 and b == c for (a, b), (c, _) in zip(
        bounds, bounds[1:]))


@pytest.mark.parametrize("height,stride,parts,match", [
    (128, 64, 3, "H/S = 2 .*S = 64.*M = 3"),
    (100, 16, 2, "no multiple"),
])
def test_row_split_refuses_what_cannot_split(height, stride, parts, match):
    with pytest.raises(ValueError, match=match):
        split_units(height, stride, parts)


# ------------------------------------------------------- layers, forwards
@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("kind", LAYER_KINDS)
def test_layer_kind_on_a_shard_equals_unsharded(request, m, kind):
    err, scale, same_shape = _group(request, m)[0]["layers"][kind]
    assert same_shape
    assert err <= 1e-12 * max(scale, 1.0), (kind, err, scale)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_forward_over_two_ranks_equals_unsharded(group2, variant):
    for rank in (0, 1):
        err, scale = group2[rank]["variants"][variant]
        assert err <= 1e-10 * max(scale, 1.0), (variant, rank, err, scale)


def test_uneven_split_forward_and_predictor(group3):
    """320 rows of tiny (S = 16) over 3 ranks: 7 / 7 / 6 bottom rows."""
    err, scale = group3[0]["uneven"]
    assert err <= 1e-10 * max(scale, 1.0)
    (heat, paf), (heat0, paf0) = group3[2]["tall"]
    assert heat.shape == heat0.shape == (320, 64, SK.heat_layers + 2)
    np.testing.assert_allclose(heat, heat0, atol=3e-5, rtol=0)
    np.testing.assert_allclose(paf, paf0, atol=3e-5, rtol=0)


def test_fewer_bottom_rows_than_ranks_is_refused(group3):
    for rank in range(3):
        msg = group3[rank]["short"]
        assert msg is not None and "32 rows" in msg
        assert "S = 16" in msg and "M = 3" in msg


# ------------------------------------------------------------ predictor
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("against", ["sharded", "plain"])
def test_predict_maps_match_jax(request, jax_side, m, against):
    """Mesh (1, 2) and (2, 2) against JAX's (2, 4) mesh and its plain
    predictor, at JAX's own tolerance; every rank returns the maps."""
    want_heat, want_paf = jax_side[against]
    for rank, res in _group(request, m).items():
        heat, paf = res["predict"]
        np.testing.assert_allclose(heat, want_heat, atol=3e-5, rtol=0,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(paf, want_paf, atol=3e-5, rtol=0,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("m,gathers", [(2, 1), (4, 2)])
def test_a_sharded_forward_issues_its_collectives(request, m, gathers):
    """tiny: 9 halo exchanges in the stem and 15 a stack (7 residuals, 2
    refines, 3 heads of 2 convs), an SE mean a head, the shards' gather
    (and the lanes' over a 'data' axis of 2)."""
    for res in _group(request, m).values():
        assert res["collectives"] == {"halo": 9 + 2 * 15, "mean": 2 * 3,
                                      "gather": gathers}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("lane", ["decoded", "compact"])
def test_planted_lanes_match_jax_plain_lanes(request, jax_side, m, lane):
    want = jax_side[lane]
    for res in _group(request, m).values():
        got = res["planted"][lane]
        if lane == "decoded":
            assert got.ok and got.n_people == want.n_people >= 2
        _assert_same_payload(got, want)


@pytest.mark.parametrize("m", [2, 4])
def test_predict_fast_equals_the_plain_lane(request, m):
    for res in _group(request, m).values():
        assert res["planted"]["fast_mask_equal"]
        assert res["planted"]["fast_maps_err"] <= 1e-6


def test_one_rank_mesh_equals_plain_bit_for_bit(group2):
    one = group2[0]["one_rank"]
    got, want = one["decoded"]
    for name, w in _fields(want).items():
        np.testing.assert_array_equal(_fields(got)[name], w, name)
    for a, b in zip(*one["predict"]):
        np.testing.assert_array_equal(a, b)


LANES = {"predict_decoded_batch": "batch",
         "predict_compact_batch_async": None,
         "precompile_compact": None,
         "predict_compact_ms": "grid",
         "predict_compact_grid": "grid",
         "predict_decoded_grid": "grid",
         "device_replica": "replica"}


@pytest.mark.parametrize("lane", sorted(LANES))
def test_lanes_refuse_a_mesh_as_jax_does(group4, jax_side, lane):
    for res in group4.values():
        msg = res["refusals"][lane]
        assert msg is not None, lane
        if LANES[lane] is not None:
            assert msg == jax_side["refused"][LANES[lane]]
        else:
            assert msg == ("compact_batch does not support the spatial "
                           "sharding mesh (meant for single giant inputs)")


def test_data_axis_other_than_one_or_two_is_refused(group4, jax_side):
    want = jax_side["refused"]["data"]
    prefix = want[:want.index("got")]
    for res in group4.values():
        assert res["data_axis"].startswith(prefix)
        assert "'data': 4" in res["data_axis"]


# ---------------------------------------------------------- batch split
def _want_rows(global_batch, data, d, rows, label_rows):
    n = global_batch[0].shape[0] // data
    img, mask, gt = (x[d * n:(d + 1) * n] for x in global_batch)
    return [img[:, rows[0]:rows[1]], mask[:, label_rows[0]:label_rows[1]],
            gt[:, label_rows[0]:label_rows[1]]]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("path", ["shard_batch", "prefetch"])
def test_spatial_batch_split_gives_each_rank_its_rows(request, inputs, m,
                                                      path):
    """48 image rows at stride 16 are 3 bottom rows: the first 'model'
    rank takes image rows [0, 32) and label rows [0, 8), the second
    [32, 48) and [8, 12); 'data' ranks take their 2 of the 4 rows."""
    batch = inputs["payload"]["global_batch"]
    data = 1 if m == 2 else 2
    for rank, res in _group(request, m).items():
        d, mm = divmod(rank, 2)
        rows, labels = ((0, 32), (0, 8)) if mm == 0 else ((32, 48), (8, 12))
        want = _want_rows(batch, data, d, rows, labels)
        for got, w in zip(res["batch"][path], want):
            np.testing.assert_array_equal(got, w)
