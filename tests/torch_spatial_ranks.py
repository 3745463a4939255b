"""Rank bodies for ``test_torch_spatial.py``: each runs in a spawned
process of a gloo group on the CPU and reports to the parent through a
queue.  A module of its own (not a test file), so a rank imports torch
and the port only."""
import numpy as np

#: the unit of the layer cases' row split: every shard starts on a
#: multiple of 4 input rows, so the stride-2 stem and a 2x2 pool stay
#: aligned; 24 rows are 6 units, which 4 ranks hold as 2 / 2 / 1 / 1
LAYER_UNIT, LAYER_H, LAYER_W = 4, 24, 20


def scaled_init(model, seed):
    """Unit-scale activations in float64: conv and dense weights from
    N(0, 1/fan_in), biases and BN means N(0, 0.1), BN scales and
    variances U(0.5, 1.5), all from one numpy seed (the package's own
    init leaves the outputs near zero and would prove little)."""
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if not t.is_floating_point():
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and t.dim() > 1:
                fan_in = int(np.prod(t.shape[1:]))
                v = rng.normal(0, 1 / np.sqrt(fan_in), t.shape)
            elif leaf in ("running_var",) or (leaf == "weight"
                                              and t.dim() == 1):
                v = rng.uniform(0.5, 1.5, t.shape)
            else:
                v = rng.normal(0, 0.1, t.shape)
            t.copy_(torch.from_numpy(v))
    return model


def layer_cases():
    """(name, module factory, input channels, level): the layer kinds
    a height shard changes or must leave alone."""
    from torch import nn

    from improved_body_parts_torch.models.layers import (
        ConvBlock,
        HourglassAE,
        Residual,
        SELayer,
        max_pool_2x2,
        same_conv,
        upsample_nearest_2x,
    )

    class Fn(nn.Module):
        def __init__(self, fn):
            super().__init__()
            self.fn = fn

        def forward(self, x):
            return self.fn(x)

    class AEConv(nn.Module):
        """``HourglassAE``'s 3x3 conv as its forward calls it."""

        def __init__(self):
            super().__init__()
            self.conv = HourglassAE(1, 8, 4).up1

        def forward(self, x):
            return same_conv(self.conv, x)

    return (("stem_7x7_stride2", lambda: ConvBlock(3, 8, 7, stride=2), 3),
            ("dilated_d5", lambda: ConvBlock(8, 8, 3, dilation=5), 8),
            ("residual", lambda: Residual(8, 12), 8),
            ("hourglass_ae_conv", AEConv, 8),
            ("conv_1x1", lambda: ConvBlock(8, 6, 1, relu=False), 8),
            ("max_pool_2x2", lambda: Fn(max_pool_2x2), 8),
            ("upsample_2x", lambda: Fn(upsample_nearest_2x), 8),
            ("se_layer", lambda: SELayer(16, 4), 16))


def layer_errors(mesh):
    """Each layer kind on this rank's rows of a (2, C, 24, 20) float64
    input over ``mesh``'s ``'model'`` axis, gathered, against the
    unsharded layer: {kind: max abs error} (and the output's largest
    magnitude)."""
    import torch

    from improved_body_parts_torch.models.layers import height_sharded
    from improved_body_parts_torch.parallel.spatial import HeightShard

    out = {}
    for i, (name, make, cin) in enumerate(layer_cases()):
        layer = scaled_init(make().double(), 100 + i).eval()
        x = torch.from_numpy(np.random.default_rng(200 + i).normal(
            0, 1, (2, cin, LAYER_H, LAYER_W)))
        with torch.no_grad():
            want = layer(x)
            shard = HeightShard.over(mesh, LAYER_H, LAYER_UNIT)
            start, end = shard.rows
            with height_sharded(shard):
                got = shard.gather(layer(x[:, :, start:end]), dim=2)
        out[name] = (float((got - want).abs().max()),
                     float(want.abs().max()), tuple(got.shape) == tuple(
                         want.shape))
    return out


def variant_model(variant, state_dict=None, seed=0):
    import dataclasses

    import torch

    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.models import build_model

    cfg = get_config("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, variant=variant))
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state_dict.items()})
        return model.eval()
    return scaled_init(model.double(), seed).eval()


def forward_error(model, mesh, h, w, seed):
    """The model's last-stack scale-0 output on this rank's rows of a
    float64 (2, h, w, 3) input, gathered, against the unsharded forward:
    (max abs error, largest magnitude)."""
    import torch

    from improved_body_parts_torch.models.layers import height_sharded
    from improved_body_parts_torch.parallel.spatial import HeightShard

    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (2, h, w, 3)))
    with torch.no_grad():
        want = model(x)[-1][0]
        shard = HeightShard.over(mesh, h, model.total_stride)
        start, end = shard.rows
        with height_sharded(shard):
            got = shard.gather(model(x[:, start:end])[-1][0], dim=1)
    return float((got - want).abs().max()), float(want.abs().max())


def predictors(payload, mesh):
    """(sharded, plain) port predictors of the tiny net on the
    payload's converted weights."""
    from improved_body_parts_torch import config as tconfig
    from improved_body_parts_torch.infer import Predictor

    model = variant_model("imhn", payload["tiny_state"])
    kw = dict(params=tconfig.InferenceParams(scale_search=(1.0,)),
              model_params=tconfig.InferenceModelParams(
                  boxsize=payload["boxsize"], max_downsample=64),
              bucket=64, device="cpu")
    sk = tconfig.get_config("canonical").skeleton
    return (Predictor(model, sk, mesh=mesh, **kw),
            Predictor(model, sk, **kw))


def counted_predict(pred, payload):
    """``pred.predict`` of the payload's image, and the collectives its
    one sharded forward issued."""
    from improved_body_parts_torch.parallel.spatial import (
        COLLECTIVES,
        reset_collectives,
    )

    reset_collectives()
    maps = pred.predict(payload["image"])
    return maps, dict(COLLECTIVES)


class MarkedStub:
    """A torch stub of fixed stride-4 maps that runs on a height shard:
    image lanes get the maps, mirror lanes their mirror (width flip +
    the channel permutation), so the flip merge returns the maps.  A
    lane is a mirror when its last column's first channel outweighs its
    first column's (the test image marks column 0).  On a shard it
    returns the shard's rows (``active_shard().rows``)."""

    total_stride = 16

    def __init__(self, maps, perm):
        import torch

        self.maps = torch.from_numpy(maps)
        self.perm = list(perm)

    def __call__(self, imgs):
        import torch

        from improved_body_parts_torch.models.layers import active_shard

        n, h, w, _ = imgs.shape
        shard = active_shard()
        r0 = shard.rows[0] // 4 if shard is not None else 0
        m = self.maps[r0:r0 + h // 4, :w // 4]
        mirror = m.flip(1)[..., self.perm]
        lanes = [mirror if imgs[i, :, -1, 0].mean() > imgs[i, :, 0, 0].mean()
                 else m for i in range(n)]
        return [[torch.stack(lanes)]]


def planted_lanes(payload, mesh):
    """``predict_decoded``, ``predict_compact`` and ``predict_fast`` of
    the marked planted image through a sharded stub predictor."""
    from improved_body_parts_torch import config as tconfig
    from improved_body_parts_torch.infer import Predictor

    sk = tconfig.get_config("canonical").skeleton
    stub = MarkedStub(payload["planted_maps"], payload["perm"])
    pred = Predictor(stub, sk, model_params=tconfig.InferenceModelParams(
        boxsize=payload["planted_image"].shape[0], max_downsample=64),
        bucket=64, device="cpu", mesh=mesh)
    plain = Predictor(stub, sk, model_params=pred.model_params, bucket=64,
                      device="cpu")
    img = payload["planted_image"]
    fast, fast_plain = pred.predict_fast(img), plain.predict_fast(img)
    return {"decoded": pred.predict_decoded(img),
            "compact": pred.predict_compact_async(img)(),
            "fast_mask_equal": bool((fast[2] == fast_plain[2]).all()),
            "fast_maps_err": float(max(np.abs(a - b).max() for a, b in zip(
                fast[:2], fast_plain[:2])))}


def refusals(pred, img):
    """{lane: message} of each lane a mesh-sharded predictor refuses."""
    from improved_body_parts_torch import config as tconfig

    grid = tconfig.InferenceParams(scale_search=(0.5, 1.0))
    out = {}
    for name, call in (
            ("predict_decoded_batch",
             lambda: pred.predict_decoded_batch([img])),
            ("predict_compact_batch_async",
             lambda: pred.predict_compact_batch_async([img])),
            ("precompile_compact",
             lambda: pred.precompile_compact([(64, 64)])),
            ("predict_compact_ms", lambda: pred.predict_compact_ms(img)),
            ("predict_compact_grid",
             lambda: pred.predict_compact(img, params=grid)),
            ("predict_decoded_grid",
             lambda: pred.predict_decoded(img, params=grid)),
            ("device_replica", lambda: pred.device_replica("cpu"))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _start(rank, port, n):
    import torch

    torch.set_num_threads(1)
    from improved_body_parts_torch.parallel import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", n, rank, device="cpu")


def two_ranks(rank, port, payload, out):
    """Mesh (1, 2): the layer kinds, every variant's forward, the tiny
    predictor's maps, the planted lanes and the spatial batch split;
    then rank 0 alone in a one-rank group, mesh (1, 1)."""
    try:
        from improved_body_parts_torch.parallel import (
            make_mesh,
            shutdown_distributed,
        )

        _start(rank, port, 2)
        mesh = make_mesh(1, 2, device="cpu")
        res = {"layers": layer_errors(mesh)}
        res["variants"] = {
            v: forward_error(variant_model(v, seed=i), mesh, 64, 48, 10 + i)
            for i, v in enumerate(payload["variants"])}
        pred, plain = predictors(payload, mesh)
        res["predict"], res["collectives"] = counted_predict(pred, payload)
        res["planted"] = planted_lanes(payload, mesh)
        res["batch"] = split_batches(payload, mesh)
        shutdown_distributed()
        if rank == 0:
            from improved_body_parts_torch.parallel.mesh import free_port

            _start(0, free_port(), 1)
            mesh = make_mesh(1, 1, device="cpu")
            pred, plain = predictors(payload, mesh)
            img = payload["image"]
            res["one_rank"] = {
                "decoded": (pred.predict_decoded(img),
                            plain.predict_decoded(img)),
                "predict": (pred.predict(img), plain.predict(img))}
            shutdown_distributed()
        out.put((rank, res))
    except BaseException as e:
        out.put((rank, {"error": f"{type(e).__name__}: {e}"}))
        raise


def three_ranks(rank, port, payload, out):
    """Mesh (1, 3): the layer kinds, the tiny forward at 320 rows (20
    bottom rows: 7 / 7 / 6), the predictor on a 320-row input against
    the plain one, and an input of 2 bottom rows refused."""
    try:
        from improved_body_parts_torch.parallel import (
            make_mesh,
            shutdown_distributed,
        )

        _start(rank, port, 3)
        mesh = make_mesh(1, 3, device="cpu")
        res = {"layers": layer_errors(mesh)}
        res["uneven"] = forward_error(variant_model("imhn", seed=7), mesh,
                                      320, 64, 21)
        pred, plain = predictors(dict(payload, boxsize=320), mesh)
        tall = payload["tall_image"]
        res["tall"] = (pred.predict(tall), plain.predict(tall))
        import torch

        try:
            pred.ensemble_maps(torch.zeros(1, 32, 64, 3))
            res["short"] = None
        except ValueError as e:
            res["short"] = str(e)
        out.put((rank, res))
        shutdown_distributed()
    except BaseException as e:
        out.put((rank, {"error": f"{type(e).__name__}: {e}"}))
        raise


def four_ranks(rank, port, payload, out):
    """Mesh (2, 2): the layer kinds over 4 'model' ranks (mesh (1, 4)),
    the tiny predictor's maps, the planted lanes, the refusals, the
    spatial batch split, and a (4, 1) mesh refused by the predictor."""
    try:
        from improved_body_parts_torch.parallel import (
            make_mesh,
            shutdown_distributed,
        )

        _start(rank, port, 4)
        res = {"layers": layer_errors(make_mesh(1, 4, device="cpu"))}
        mesh = make_mesh(2, 2, device="cpu")
        pred, _ = predictors(payload, mesh)
        res["predict"], res["collectives"] = counted_predict(pred, payload)
        res["planted"] = planted_lanes(payload, mesh)
        res["refusals"] = refusals(pred, payload["image"])
        res["batch"] = split_batches(payload, mesh)
        try:
            # a (4, 1) layout: the predictor reads the axes' sizes and
            # refuses before any collective, so no process group is made
            import torch
            from torch.distributed.device_mesh import DeviceMesh

            predictors(payload, DeviceMesh(
                "cpu", torch.arange(4).view(4, 1),
                mesh_dim_names=("data", "model"), _init_backend=False))
            res["data_axis"] = None
        except ValueError as e:
            res["data_axis"] = str(e)
        out.put((rank, res))
        shutdown_distributed()
    except BaseException as e:
        out.put((rank, {"error": f"{type(e).__name__}: {e}"}))
        raise


def split_batches(payload, mesh):
    """This rank's ``shard_batch(spatial_shard=True)`` of the global
    batch and ``device_prefetch(spatial_shard=True)`` of its data
    slab, as numpy."""
    from improved_body_parts_torch.parallel import (
        device_prefetch,
        shard_batch,
    )

    batch = payload["global_batch"]
    stride = payload["batch_stride"]
    sharded = shard_batch(batch, mesh, spatial_shard=True, stride=stride)
    slab = shard_batch(batch, mesh)
    (fetched,) = list(device_prefetch([slab], mesh, spatial_shard=True,
                                      stride=stride))
    return {"shard_batch": [np.asarray(x) for x in sharded],
            "prefetch": [t.numpy() for t in fetched]}
