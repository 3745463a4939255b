"""The port's multi-card layout logic against the JAX package's
(``parallel.partition``, ``parallel.mesh``, the host shards, the CLI's LR
rule), in the test process; the JAX side runs on the suite's 8 virtual
CPU devices.

- ``rules_fingerprint`` equal in both packages for every named ruleset
  and three refinement floors;
- the layout of the tiny train state, leaf by leaf (the same paths, the
  same refined specs, each split torch dim the converter's image of the
  JAX axis, the same shard count) against JAX ``train_state_shardings``
  for ``imhn`` on (4, 2) and (1, 2), ``imhn_fsdp`` on (2, 1) and (4, 1)
  and ``replicated``, and ``sharding_summary`` equal;
- strict mode names every unmatched leaf, the first matching rule wins
  and ``refine_spec`` drops what the mesh cannot split, as in JAX;
- ``mesh_topology`` has the JAX keys; ``topology_mismatch`` diffs as
  JAX's does, and the port's earlier stamp reads as one process on one
  card;
- ``resolve_host_shard`` equal to JAX's in both modes; ``batch`` slabs
  of the sync path and of the shm ring reassemble the single-host global
  batch bit for bit, and ``ShmRingInput.stream`` runs on across epochs;
- ``cli.train``'s schedule under ``--lr-batch-ref`` equal to the JAX
  CLI's.
"""
import dataclasses

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from improved_body_parts_torch.cli import train as cli_train
from improved_body_parts_torch.config import get_config as tget_config
from improved_body_parts_torch.data import dataset as tds
from improved_body_parts_torch.data.fixture import build_fixture
from improved_body_parts_torch.data.shm_ring import ShmRingInput
from improved_body_parts_torch.models import build_model
from improved_body_parts_torch.models.convert import _TRANSFORMS, \
    flax_leaf_map
from improved_body_parts_torch.parallel import mesh as tmesh
from improved_body_parts_torch.parallel import partition as tpart
from improved_body_parts_torch.train import make_optimizer, \
    step_decay_schedule
from improved_body_parts_tpu.config import get_config as jget_config
from improved_body_parts_tpu.data import dataset as jds
from improved_body_parts_tpu.parallel import mesh as jmesh
from improved_body_parts_tpu.parallel import partition as jpart
from improved_body_parts_tpu.train import schedule as jsched
from improved_body_parts_tpu.train import state as jstate


def _sizes(shape):
    return {"data": shape[0], "model": shape[1]}


# ---------------------------------------------------------- fingerprints


@pytest.mark.parametrize("floor", (1, 8, 16))
@pytest.mark.parametrize("name", sorted(jpart.NAMED_RULESETS))
def test_rules_fingerprint_equals_jax(name, floor):
    assert sorted(tpart.NAMED_RULESETS) == sorted(jpart.NAMED_RULESETS)
    got = tpart.rules_fingerprint(tpart.get_ruleset(name), floor)
    assert got == jpart.rules_fingerprint(jpart.get_ruleset(name), floor)
    assert len(got) == 12
    # the default floor is the JAX default
    assert tpart.rules_fingerprint(tpart.get_ruleset(name)) == \
        jpart.rules_fingerprint(jpart.get_ruleset(name))


# --------------------------------------------------------------- layouts


@pytest.fixture(scope="module")
def tiny_states():
    """The tiny model and optimizer in both packages (JAX's abstract)."""
    import jax
    import jax.numpy as jnp

    from improved_body_parts_tpu.models import build_model as jbuild
    from improved_body_parts_tpu.train.state import create_train_state

    jcfg = jget_config("tiny")
    jmodel = jbuild(jcfg)
    jopt = jstate.make_optimizer(jcfg, jsched.step_decay_schedule(
        jcfg.train, 10))
    h, w = jcfg.skeleton.height, jcfg.skeleton.width
    abstract = jax.eval_shape(lambda: create_train_state(
        jmodel, jcfg, jopt, jax.random.PRNGKey(0),
        jnp.zeros((1, h, w, 3), jnp.float32)))
    tcfg = tget_config("tiny")
    model = build_model(tcfg, device="cpu", train=True)
    opt = make_optimizer(model, tcfg, step_decay_schedule(tcfg.train, 10))
    return dict(jmodel=jmodel, jcfg=jcfg, jopt=jopt, model=model, opt=opt,
                jshapes={n: tuple(leaf.shape) for n, leaf in
                         jpart.tree_path_names(abstract)})


@pytest.mark.parametrize("name,shape", [
    ("imhn", (4, 2)), ("imhn", (1, 2)), ("imhn_fsdp", (2, 1)),
    ("imhn_fsdp", (4, 1)), ("replicated", (2, 1))])
def test_layout_equals_jax_train_state_shardings(tiny_states, name, shape):
    st = tiny_states
    want = dict(jpart.tree_path_names(jpart.train_state_shardings(
        st["jmodel"], st["jcfg"], st["jopt"], jmesh.make_mesh(*shape),
        jpart.get_ruleset(name))))
    layout = tpart.train_state_shardings(st["model"], st["opt"],
                                         _sizes(shape),
                                         tpart.get_ruleset(name))
    assert set(layout) == set(want)
    leaf_map = flax_leaf_map(st["model"])
    params = dict(st["model"].named_parameters())
    split = 0
    for path, sharding in want.items():
        lay = layout[path]
        assert lay.spec == tuple(sharding.spec), path
        axes = [(i, a) for i, a in enumerate(tuple(sharding.spec))
                if a is not None]
        if not axes:
            assert lay.dim is None, path
            continue
        split += 1
        ((ref_axis, mesh_axes),) = axes
        mesh_axes = mesh_axes if isinstance(mesh_axes, tuple) \
            else (mesh_axes,)
        assert lay.axes == mesh_axes
        assert lay.shards == int(np.prod([_sizes(shape)[a]
                                          for a in mesh_axes]))
        # through the converter: the JAX leaf split along its axis, each
        # chunk converted, is the converted leaf split along lay.dim
        key = lay.key.split("/", 1)[-1] if lay.key.startswith(
            "momentum/") else lay.key
        _, fpath, how = leaf_map[key]
        assert path.endswith("/".join(fpath)), (path, fpath)
        jshape = st["jshapes"][path]
        leaf = np.arange(np.prod(jshape), dtype=np.float32).reshape(jshape)
        conv = _TRANSFORMS[how]
        got = np.split(conv(leaf), lay.shards, axis=lay.dim)
        chunks = [conv(c) for c in np.split(leaf, lay.shards,
                                            axis=ref_axis)]
        for a, b in zip(got, chunks):
            np.testing.assert_array_equal(a, b)
        assert tuple(params[key].shape) == conv(leaf).shape
    assert tpart.sharding_summary(layout) == jpart.sharding_summary(
        jpart.train_state_shardings(
            st["jmodel"], st["jcfg"], st["jopt"], jmesh.make_mesh(*shape),
            jpart.get_ruleset(name)))
    assert (split > 0) == (name != "replicated")


def test_strict_mode_names_every_unmatched_leaf():
    shapes = {"params/B_0/Conv_0/kernel": (3, 3, 16, 32),
              "params/B_0/Dense_0/kernel": (32, 8),
              "params/B_0/Dense_1/kernel": (8, 32), "step": ()}
    tree = {"params": {"B_0": {"Conv_0": {"kernel": np.zeros((3, 3, 16, 32))},
                               "Dense_0": {"kernel": np.zeros((32, 8))},
                               "Dense_1": {"kernel": np.zeros((8, 32))}}},
            "step": np.zeros(())}
    rules = [(r"Conv_\d+/kernel$", (None, None, None, "model"))]
    jrules = [(r"Conv_\d+/kernel$", P(None, None, None, "model"))]
    for strict_mod, r in ((tpart, rules), (jpart, jrules)):
        with pytest.raises(strict_mod.UnmatchedLeafError) as err:
            strict_mod.match_partition_rules(
                r, shapes if strict_mod is tpart else tree, strict=True)
        msg = str(err.value)
        assert "2 leaves" in msg and "Dense_0" in msg and "Dense_1" in msg
        assert "Conv_0" not in msg.split("mode:")[1].split(".")[0]
    got = tpart.match_partition_rules(rules, shapes)
    want = dict(jpart.tree_path_names(jpart.match_partition_rules(jrules,
                                                                  tree)))
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["step"] == () and got["params/B_0/Dense_0/kernel"] == ()


@pytest.mark.parametrize("flip", (False, True))
def test_first_matching_rule_wins(flip):
    rules = [(r"kernel$", (None, None, None, "model")), (r".*", ())]
    if flip:
        rules = rules[::-1]
    shapes = {"params/Conv_0/kernel": (3, 3, 8, 16), "params/Conv_0/bias":
              (16,)}
    tree = {"params": {"Conv_0": {"kernel": np.zeros((3, 3, 8, 16)),
                                  "bias": np.zeros(16)}}}
    got = tpart.match_partition_rules(rules, shapes)
    want = jpart.match_partition_rules([(p, P(*s)) for p, s in rules], tree)
    assert got == {k: tuple(v) for k, v in jpart.tree_path_names(want)}
    assert got["params/Conv_0/kernel"] == (() if flip else
                                           (None, None, None, "model"))


@pytest.mark.parametrize("spec,shape,mesh_shape,floor", [
    ((None, None, None, "model"), (3, 3, 16, 64), (4, 2), 8),
    ((None, None, None, "model"), (3, 3, 16, 12), (4, 2), 8),   # 6 < 8
    ((None, None, None, "model"), (3, 3, 16, 15), (1, 2), 1),   # 15 % 2
    ((None, None, None, ("data", "model")), (3, 3, 8, 64), (4, 2), 8),
    ((None, None, None, ("data", "model")), (3, 3, 8, 48), (4, 2), 8),
    ((None, None, None, "model"), (1, 1, 8, 64), (8, 1), 8),   # size 1
    (("data",), (64, 3, 3), (4, 2), 4),                          # short
    (("data", None, "model"), (64, 3, 8), (2, 2), 16),          # strip
])
def test_refine_spec_equals_jax(spec, shape, mesh_shape, floor):
    got = tpart.refine_spec(spec, shape, _sizes(mesh_shape), floor)
    want = jpart.refine_spec(P(*spec), shape, jmesh.make_mesh(*mesh_shape),
                             floor)
    assert got == tuple(want)


# -------------------------------------------------------------- topology


def test_mesh_topology_has_the_jax_keys():
    got = tmesh.mesh_topology({"data": 4, "model": 2},
                              partition_rules="0123456789ab", device="cpu")
    want = jmesh.mesh_topology(jmesh.make_mesh(4, 2),
                               partition_rules="0123456789ab")
    assert set(got) == set(want)
    for key in ("platform", "mesh_devices", "mesh_axes", "partition_rules"):
        assert got[key] == want[key], key
    assert set(tmesh.mesh_topology(device="cpu")) == set(
        jmesh.mesh_topology())


def _current(pkg):
    if pkg is tmesh:
        return tmesh.mesh_topology({"data": 4, "model": 2}, device="cpu")
    return jmesh.mesh_topology(jmesh.make_mesh(4, 2))


@pytest.mark.parametrize("change", [
    {}, {"process_count": 7}, {"mesh_axes": {"data": 8, "model": 1}},
    {"platform": "tpu"}, {"partition_rules": "fedcba987654"},
    {"device_count": 16, "mesh_devices": 16}])
def test_topology_mismatch_diffs_as_jax(change):
    for pkg in (tmesh, jmesh):
        current = _current(pkg)
        stamped = dict(current, **change)
        mesh = ({"data": 4, "model": 2} if pkg is tmesh
                else jmesh.make_mesh(4, 2))
        kw = {"device": "cpu"} if pkg is tmesh else {}
        diff = pkg.topology_mismatch(stamped, mesh, **kw)
        assert set(diff or {}) == set(change), pkg.__name__
        for k, v in change.items():
            assert diff[k][0] == v
            assert diff[k][1] == current.get(k)
        # a stamp without the key checks nothing there
        assert pkg.topology_mismatch(
            {k: v for k, v in stamped.items() if k not in change}, mesh,
            **kw) is None


def test_earlier_port_stamp_reads_as_one_process_on_one_card():
    here = tmesh.mesh_topology(device="cpu")
    assert here["process_count"] == here["device_count"] == 1
    for stamp in (None, {}, tmesh.LEGACY_STAMP):
        assert tmesh.topology_mismatch(stamp, None, device="cpu") is None
    assert tmesh.topology_mismatch(tmesh.LEGACY_STAMP, None, 2,
                                   device="cpu") == {"process_count": (1, 2)}


def test_shard_batch_gives_contiguous_slabs(monkeypatch):
    batch = (np.arange(8 * 3).reshape(8, 3), np.arange(8))
    slabs = []
    for d in range(2):
        monkeypatch.setattr(tmesh, "axis_index", lambda m, a, d=d: d)
        slabs.append(tmesh.shard_batch(batch, {"data": 2, "model": 1}))
    for i, x in enumerate(batch):
        np.testing.assert_array_equal(np.concatenate([s[i] for s in slabs]),
                                      x)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch((np.zeros(3),), {"data": 2, "model": 1})


# ----------------------------------------------------------- host shards


@pytest.mark.parametrize("n,count,bs", [(17, 2, 3), (16, 4, 2), (10, 3, 1)])
@pytest.mark.parametrize("mode", ("strided", "batch"))
def test_resolve_host_shard_equals_jax(mode, n, count, bs):
    perm = np.random.default_rng(n).permutation(n)
    rows = []
    for p in range(count):
        got = tds.resolve_host_shard(perm, p, count, bs, shard=mode)
        np.testing.assert_array_equal(
            got, jds.resolve_host_shard(perm, p, count, bs, shard=mode))
        rows.append(got)
    assert len({len(r) for r in rows}) == 1     # every host, same steps
    with pytest.raises(ValueError, match="host shard mode"):
        tds.resolve_host_shard(perm, 0, count, bs, shard="rows")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("parallel") / "fixture.h5")
    n = build_fixture(path, num_images=4, img_size=(96, 128),
                      people_per_image=2, image_size=64, seed=3, drawn=True)
    assert n >= 4
    cfg = tget_config("tiny")
    cfg = dataclasses.replace(cfg, skeleton=dataclasses.replace(
        cfg.skeleton, width=64, height=64))
    return path, cfg


def test_batch_slabs_reassemble_the_global_batch(corpus):
    path, cfg = corpus
    ds = tds.CocoPoseDataset(path, cfg, seed=1)
    try:
        whole = list(tds.batches(ds, 4, 1, wire="uint8", shard="batch"))
        sync = [list(tds.batches(ds, 2, 1, p, 2, wire="uint8",
                                 shard="batch")) for p in range(2)]
        with ShmRingInput(ds, 2, 1, wire="uint8") as ring:
            ringed = [[tuple(np.copy(x) for x in b)
                       for b in ring.batches(1, p, 2, shard="batch")]
                      for p in range(2)]
    finally:
        ds.close()
    assert len(whole) >= 1 and all(len(s) == len(whole) for s in sync)
    for k, want in enumerate(whole):
        for i, x in enumerate(want):
            np.testing.assert_array_equal(
                np.concatenate([sync[0][k][i], sync[1][k][i]]), x)
            for p in range(2):
                np.testing.assert_array_equal(ringed[p][k][i],
                                              sync[p][k][i])


# ------------------------------------------------------------ LR scaling


@pytest.mark.parametrize("ref,data", [(4, 2), (2, 4), (0, 2)])
def test_lr_batch_ref_schedule_equals_jax(ref, data):
    args = cli_train._parser().parse_args(
        ["--config", "tiny", "--lr-batch-ref", str(ref)])
    cfg, _ = cli_train.resolve_args(args)
    assert cfg.train.lr_batch_ref == ref
    rank_batch, spe = cfg.train.batch_size_per_device, 20
    got = cli_train.lr_schedule(cfg.train, spe, rank_batch, data)
    jtr = dataclasses.replace(jget_config("tiny").train, lr_batch_ref=ref)
    # the JAX CLI's choice (tools/train.py): the large-batch recipe on the
    # global batch when lr_batch_ref > 0, else world_size = data axis
    want = (jsched.large_batch_schedule(jtr, spe, rank_batch * data)
            if ref > 0 else
            jsched.step_decay_schedule(jtr, spe, world_size=data))
    steps = np.arange(301)
    np.testing.assert_allclose(
        np.array([got(int(s)) for s in steps], np.float32),
        np.array([float(want(int(s))) for s in steps], np.float32),
        rtol=1e-7, atol=0)
