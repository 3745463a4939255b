"""Flip-ensemble prediction, the fused device decode (the serve lane), the
compact and full-map lanes its fallbacks and the host-pool lane use, and
the accuracy tiers: the scale x rotation grid on the device and the host
full-map protocol.

Counterpart of ``improved_body_parts_tpu/infer/predict.py``.  Per batch of
same-shape images, all on the device:

1. one forward of the IMHN over [images, mirrored images] (2N lanes);
2. the flip merge (mirror-lane channel permutation + average);
3. the x stride cubic upsample (``infer.resize``);
4. per image, peak top-K (``ops.peaks.topk_peaks``), dense limb sampling
   with acceptance + top-M ranking (``limb_topk_candidates``): the
   compact records;
5. on the fused lane, greedy assembly (``ops.assembly.greedy_assemble``);
6. everything packed into one fp32 row per image, fetched once.

The packed rows keep the JAX package's layouts exactly, so one unpacker
reads either package's buffers.  The lanes:

- ``predict_decoded(_batch)(_async)``: the fused decode (1-6), what the
  serving engine (``serve.DynamicBatcher``) dispatches by default;
- ``predict_compact(_batch)(_async)``: the compact records (1-4 and 6),
  decoded on the host by ``infer.decode.decode_compact``;
- ``predict_fast(_async)``: the full maps plus a ``keypoint_nms`` peak
  mask over the valid region (the JAX "peaks" mode), decoded on the host
  by ``infer.decode.decode``: the fallback when the compact capacities
  overflow;
- ``predict_compact_ms(_async)``: the scale x rotation grid of one image
  on the device (the reference's evaluation protocol, evaluate.py:83-166,
  minus the host round trips): per grid entry the rotation lane, the
  flip ensemble, crop, un-rotation and a cubic regrid onto the largest
  scale's unpadded grid; the mean of the entries; the compact (or, for
  ``predict_decoded*``, the fused decode) extraction on it.  The compact
  and decoded lanes route a grid here by themselves.  ``fused_tta``
  picks one call that accumulates the entries as it goes (one upload a
  scale, no per-entry map kept) or the looped form (one call an entry,
  each entry's map kept, then the mean); both run the same ops in the
  same order, so their payloads are equal bit for bit;
- ``predict``: the host full-map protocol, cv2 resizes and rotations
  around each entry's device ensemble, the mean at the original size.

Host preprocessing (cubic resize to ``boxsize``, bucket padding) is the
JAX package's, with cv2.

``Predictor(mesh=)`` spreads one image's forward over the ranks of a
``('data', 'model')`` mesh (``parallel.make_mesh``; every rank calls the
same single-image lane with the same image): the flip lanes [image,
mirror] split over ``'data'`` (1 or 2) and the padded height over
``'model'`` (``parallel.spatial``: the row split at the network's total
stride, a halo exchange at every convolution that pads the height, the
SE layers' mean over the global height); the last stack's maps are
gathered onto every rank, and the flip merge, the upsample and the decode
run on the whole maps there, so every rank returns the same result.  The
single-image lanes (``predict``, ``predict_fast``, ``predict_compact``,
``predict_decoded`` and their ``_async`` forms) take a mesh; the grid
lanes, the batch lanes and ``device_replica`` refuse it, as the JAX
package's do.
"""
from __future__ import annotations

import contextlib
import copy
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np
import torch

from .. import device_tensor, resolve_device
from ..config import (
    InferenceModelParams,
    InferenceParams,
    SkeletonConfig,
    default_inference_params,
)
from ..ops.assembly import greedy_assemble
from ..ops.nms import keypoint_nms
from ..ops.peaks import (
    LimbCandidates,
    TopKPeaks,
    limb_topk_candidates,
    topk_peaks,
)
from .decode import CompactResult, DeviceDecoded
from .resize import resize_cubic, upsample_cubic

# candidate cap of the compact payload, as a multiple of the peak top-K:
# m_cap = COMPACT_M_FACTOR * compact_topk accepted pairs ship per limb
COMPACT_M_FACTOR = 2


def trivial_grid(prm: InferenceParams) -> bool:
    """True when the ensemble grid is a single scale and no rotation --
    the protocol the batched lanes and ``predict_fast`` cover; every
    grid-routing decision goes through here."""
    return (len(prm.scale_search) == 1
            and tuple(prm.rotation_search) == (0.0,))


def _pow2_chunks(items: Sequence) -> List[list]:
    """Split ``items`` into chunks whose lengths are the binary
    decomposition of ``len(items)``, largest first (5 -> [4, 1])."""
    out, pos, g = [], 0, len(items)
    while g:
        size = 1 << (g.bit_length() - 1)
        out.append(list(items[pos:pos + size]))
        pos += size
        g -= size
    return out


def _warp_rotate(maps: torch.Tensor, angle_deg: float,
                 center: Tuple[float, float]) -> torch.Tensor:
    """(N, H, W, C) maps rotated by ``angle_deg`` about ``center`` (cx,
    cy), on their own device, with the semantics of the JAX package's
    ``_warp_rotate``: ``cv2.warpAffine(src, cv2.getRotationMatrix2D(
    center, angle, 1), (0, 0))`` sampled at M^-1 (x, y) as
    ``map_coordinates(order=1, cval=0)`` samples -- the four neighbours
    ``floor`` / ``floor + 1`` of each source point, weighted ``1 - frac``
    / ``frac``, a neighbour outside the image contributing 0, the four
    terms summed in the order (lo, lo), (lo, hi), (hi, lo), (hi, hi) of
    (y, x).  ``F.grid_sample`` rounds and borders otherwise."""
    theta = math.radians(angle_deg)
    a, b = math.cos(theta), math.sin(theta)
    cx, cy = center
    n, h, w, c = maps.shape
    dev = maps.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    dx, dy = xs - cx, ys - cy
    # getRotationMatrix2D's linear part is [[a, b], [-b, a]] (y down,
    # positive angle counter-clockwise); its inverse flips b's sign
    sx = a * dx - b * dy + cx
    sy = b * dx + a * dy + cy
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    flat = maps.reshape(n, h * w, c)
    out = None
    for y, wy in ((y0, 1 - wy1), (y0 + 1, wy1)):
        for x, wx in ((x0, 1 - wx1), (x0 + 1, wx1)):
            inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
            idx = (y.clamp(0, h - 1) * w + x.clamp(0, w - 1)).reshape(-1)
            vals = flat[:, idx].reshape(n, h, w, c)
            term = (wy * wx)[None, :, :, None] * torch.where(
                inside[None, :, :, None], vals, torch.zeros((), device=dev))
            out = term if out is None else out + term
    return out


def center_pad(img: np.ndarray, multiple: int, pad_value: int
               ) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Symmetric padding to the next multiple; returns (image,
    (top, left, bottom, right)) (reference: utils/util.py:68-100)."""
    h, w = img.shape[:2]
    dh = (multiple - h % multiple) % multiple
    dw = (multiple - w % multiple) % multiple
    top, left = int((h + dh - h) / 2), int((w + dw - w) / 2)
    bottom, right = dh - top, dw - left
    if dh or dw:
        img = cv2.copyMakeBorder(img, top, bottom, left, right,
                                 cv2.BORDER_CONSTANT,
                                 value=(pad_value,) * 3)
    return img, (top, left, bottom, right)


def pad_right_down(img: np.ndarray, multiple: int, pad_value: int
                   ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Pad bottom/right to the next multiple with a constant."""
    h, w = img.shape[:2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph or pw:
        img = cv2.copyMakeBorder(img, 0, ph, 0, pw, cv2.BORDER_CONSTANT,
                                 value=(pad_value,) * 3)
    return img, (ph, pw)


class Predictor:
    """Runs the fused decode, compact and full-map lanes of ``model`` on
    ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``, where the
    kernels' plain versions run).

    ``model`` maps (N, H, W, 3) float images in [0, 1] to ``[stack][scale]``
    NHWC float32 predictions (``models.posenet.PoseNet``) and lies on
    ``device``.  ``compact_topk`` is the per-channel peak capacity,
    ``assembly_pmax`` the person-table capacity; crowds past either set
    an overflow flag in the result (``DeviceDecoded.ok``).  ``fused_tta``
    picks the scale x rotation grid's fused form (one call an image)
    over the looped one (one call an entry, then the mean).

    ``mesh`` (a ``parallel.make_mesh`` mesh whose ``'data'`` axis is 1 or
    2) height-shards each image's forward over its ranks (see the module
    docstring); ``model`` is then a model of ``models.build_model``
    (its ``total_stride`` is the row split's unit) and ``device`` this
    rank's card.
    """

    def __init__(self, model, skeleton: SkeletonConfig,
                 params: Optional[InferenceParams] = None,
                 model_params: Optional[InferenceModelParams] = None,
                 bucket: int = 128, compact_topk: int = 64,
                 assembly_pmax: int = 32, device="cuda",
                 fused_tta: bool = True, mesh=None):
        d_params, d_model_params = default_inference_params()
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import axis_sizes, check_mesh
            from ..parallel.spatial import network_stride

            check_mesh(mesh, "Predictor")
            sizes = axis_sizes(mesh)
            if sizes["data"] not in (1, 2):
                raise ValueError(
                    "the ensemble batch is 2 (image + flip): the mesh "
                    f"'data' axis must be 1 or 2, got {sizes}")
            self.shard_stride = network_stride(model)
        self.model = model
        self.skeleton = skeleton
        self.params = params or d_params
        self.model_params = model_params or d_model_params
        self.bucket = max(bucket, self.model_params.max_downsample)
        self.compact_topk = compact_topk
        self.assembly_pmax = assembly_pmax
        self.fused_tta = fused_tta
        # the grid's dispatches, counted where they are issued: 1 an
        # image fused, entries + 1 looped (``cli.tta_bench`` reads it)
        self.dispatch_count = 0
        # (mode, (n, h, w), thre1, spec) of every batch program this
        # predictor has run: the first run of each pays the card's
        # one-off costs (the kernels' build, cuDNN's algorithm choice,
        # the allocator's first blocks); precompile_compact counts and
        # pays them before traffic arrives
        self._warmed: set = set()

    # ------------------------------------------------------------------ #
    def _compact_spec(self, prm: InferenceParams):
        """(thre2, mid_num, offset_radius, top-K, connect_ration): the
        extraction knobs, in the JAX package's spec order."""
        return (prm.thre2, prm.mid_num, prm.offset_radius,
                self.compact_topk, prm.connect_ration)

    def _decode_spec(self, prm: InferenceParams):
        """(compact spec, (p_max, len_rate, connection_tole, remove_recon,
        min_parts, min_mean_score)): the extraction and assembly knobs,
        in the JAX package's spec order."""
        return (self._compact_spec(prm),
                (self.assembly_pmax, prm.len_rate, prm.connection_tole,
                 prm.remove_recon, prm.min_parts, prm.min_mean_score))

    def _merge_flip(self, straight: torch.Tensor, mirrored: torch.Tensor
                    ) -> torch.Tensor:
        """Mirror-lane channel permutation + averaging + paf/heat concat.
        ``mirrored`` must already be width-unflipped."""
        sk = self.skeleton
        dev = straight.device
        flip_paf = device_tensor(tuple(sk.flip_paf_ord), dev)
        flip_heat = device_tensor(tuple(sk.flip_heat_ord), dev)
        paf = (straight[..., :sk.paf_layers]
               + mirrored[..., :sk.paf_layers][..., flip_paf]) / 2
        heat = (straight[..., sk.heat_start:sk.num_layers]
                + mirrored[..., sk.heat_start:sk.num_layers][..., flip_heat]
                ) / 2
        return torch.cat([paf, heat], dim=-1)

    @torch.inference_mode()
    def ensemble_maps(self, imgs: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) float images in [0, 1] on the device -> (N, H, W,
        C) ensembled full-resolution maps: one 2N-lane forward over the
        images and their mirrors, the flip merge, the x stride cubic
        upsample."""
        n = imgs.shape[0]
        both = torch.cat([imgs, imgs.flip(2)], dim=0)
        if self.mesh is None:
            out = self.model(both)[-1][0]       # (2N, H/4, W/4, C) fp32
        else:
            out = self._sharded_forward(both)
        maps = self._merge_flip(out[:n], out[n:].flip(2))
        return upsample_cubic(maps, self.skeleton.stride)

    def _sharded_forward(self, both: torch.Tensor) -> torch.Tensor:
        """The last stack's scale-0 maps of the 2 lanes [image, mirror]
        of one image over the mesh: this rank's lane (both lanes on a
        ``'data'`` axis of 1) on its rows of the row split, the shards
        gathered over ``'model'`` and the lanes over ``'data'``, so every
        rank holds all of (2, H/4, W/4, C)."""
        from ..models.layers import height_sharded
        from ..parallel.mesh import axis_index, axis_sizes
        from ..parallel.spatial import HeightShard, gather_lanes

        if both.shape[0] != 2:
            raise ValueError("a mesh-sharded predictor runs one image a "
                             f"call, got {both.shape[0] // 2}")
        sizes = axis_sizes(self.mesh)
        if sizes["data"] == 2:
            d = axis_index(self.mesh, "data")
            both = both[d:d + 1]
        if sizes["model"] == 1:
            # one rank's shard is the whole height: the plain forward
            out = self.model(both)[-1][0]
        else:
            shard = HeightShard.over(self.mesh, both.shape[1],
                                     self.shard_stride)
            start, end = shard.rows
            with height_sharded(shard):
                out = self.model(both[:, start:end])[-1][0]
            out = shard.gather(out, dim=1)
        return gather_lanes(out, self.mesh.get_group("data"), sizes["data"])

    def _records(self, maps: torch.Tensor, valid_h: torch.Tensor,
                 valid_w: torch.Tensor, thre1: float, compact_spec):
        """Ensembled maps -> (TopKPeaks, LimbCandidates) of every image:
        the compact records, the shared front half of both payloads."""
        sk = self.skeleton
        thre2, mid_num, radius, topk, connect_ration = compact_spec
        kp = maps[..., sk.paf_layers:sk.paf_layers + sk.num_parts]
        paf = maps[..., :sk.paf_layers]
        peaks = topk_peaks(kp, valid_h, valid_w, thre=thre1, k=topk,
                           radius=radius)
        cands = limb_topk_candidates(
            paf, peaks, valid_h,
            limbs_from=tuple(a for a, _ in sk.limbs_conn),
            limbs_to=tuple(b for _, b in sk.limbs_conn),
            num_samples=mid_num, thre2=thre2,
            connect_ration=connect_ration, m_cap=COMPACT_M_FACTOR * topk)
        return peaks, cands

    @torch.inference_mode()
    def compact_maps(self, maps: torch.Tensor, valid_h: torch.Tensor,
                     valid_w: torch.Tensor, thre1: float, compact_spec
                     ) -> torch.Tensor:
        """Ensembled maps -> one packed fp32 row per image: the top-K peak
        records and the accepted limb candidates (layout twin of
        :meth:`_unpack_compact`)."""
        peaks, cands = self._records(maps, valid_h, valid_w, thre1,
                                     compact_spec)
        n = maps.shape[0]
        return torch.cat([f.reshape(n, -1).to(torch.float32)
                          for f in tuple(peaks) + tuple(cands)], dim=1)

    @torch.inference_mode()
    def decode_maps(self, maps: torch.Tensor, valid_h: torch.Tensor,
                    valid_w: torch.Tensor, thre1: float, spec
                    ) -> torch.Tensor:
        """Ensembled maps -> one packed fp32 row per image: the compact
        records, the greedy-assembled person table, its prune mask and
        [n_people, peak/cand/person overflow] (layout twin of
        :meth:`_unpack_decoded`)."""
        sk = self.skeleton
        compact_spec, asm_spec = spec
        p_max, len_rate, connection_tole, remove_recon, min_parts, \
            min_mean_score = asm_spec
        peaks, cands = self._records(maps, valid_h, valid_w, thre1,
                                     compact_spec)
        asm = greedy_assemble(
            peaks, cands, limbs_from=tuple(a for a, _ in sk.limbs_conn),
            limbs_to=tuple(b for _, b in sk.limbs_conn),
            num_parts=sk.num_parts, p_max=p_max, len_rate=len_rate,
            connection_tole=connection_tole, remove_recon=remove_recon,
            min_parts=min_parts, min_mean_score=min_mean_score)
        flags = torch.stack([f.to(torch.float32) for f in (
            asm.n_people, asm.peak_overflow, asm.cand_overflow,
            asm.person_overflow)], dim=1)
        n = maps.shape[0]
        fields = (tuple(peaks) + tuple(cands)
                  + (asm.subset, asm.mask, flags))
        return torch.cat([f.reshape(n, -1).to(torch.float32)
                          for f in fields], dim=1)

    # ------------------------------------------------------------------ #
    def compact_lane_shape(self, image_bgr: np.ndarray,
                           params: Optional[InferenceParams] = None
                           ) -> Tuple[int, int]:
        """Predicted padded input shape for this image under the
        single-scale protocol: the grouping key of compact batching
        (``serve.DynamicBatcher`` buckets requests by it).

        Advisory only: the batch dispatch regroups by the ACTUAL prepared
        shapes, so a rare rounding mismatch with cv2's resize costs a
        split batch, never correctness."""
        oh, ow = image_bgr.shape[:2]
        return self.compact_lane_shape_for(oh, ow, params)

    def compact_lane_shape_for(self, oh: int, ow: int,
                               params: Optional[InferenceParams] = None
                               ) -> Tuple[int, int]:
        """:meth:`compact_lane_shape` from an (H, W) size instead of an
        image."""
        prm = params or self.params
        scale = self._clamp_scale(
            prm.scale_search[0] * self.model_params.boxsize / oh, oh, ow)
        rh, rw = round(oh * scale), round(ow * scale)
        b = self.bucket
        return (rh + (-rh) % b, rw + (-rw) % b)

    def enumerate_bucket_shapes(self, image_sizes: Sequence[Tuple[int, int]],
                                params: Optional[InferenceParams] = None
                                ) -> List[Tuple[int, int]]:
        """Deduplicated, sorted padded lane shapes the given (H, W) image
        sizes bucket into: the shape set a serving deployment warms
        (:meth:`precompile_compact`)."""
        return sorted({self.compact_lane_shape_for(oh, ow, params)
                       for oh, ow in image_sizes})

    def device_replica(self, device) -> "Predictor":
        """A serving replica of this predictor on ``device``: a shallow
        copy sharing the config, whose model is a deep copy moved to
        ``device`` and whose warm set starts empty (each device pays its
        own first-run costs).  ``serve.DynamicBatcher`` sends each batch
        to its least-loaded replica."""
        if self.mesh is not None:
            raise ValueError(
                "device_replica replicates WHOLE devices; a mesh-sharded "
                "predictor already spans devices")
        clone = copy.copy(self)
        clone.device = resolve_device(device)
        clone.model = copy.deepcopy(self.model).to(clone.device)
        clone._warmed = set()
        return clone

    def precompile_compact(self, lane_shapes: Sequence[Tuple[int, int]],
                           batch_sizes: Sequence[int] = (1,),
                           thre1: Optional[float] = None,
                           params: Optional[InferenceParams] = None,
                           decode: bool = False) -> int:
        """Run the compact-batch lane (the fused decode lane with
        ``decode=True``) once on zeros for every (lane shape x batch
        size), and the single-image flush (batch 1) of every shape,
        waiting for each to finish.

        PyTorch compiles nothing ahead, but the first run of a shape
        pays the kernels' build, cuDNN's algorithm choice and the caching
        allocator's first blocks: warming every shape the traffic can hit
        moves those costs to start-up.  Returns the number of
        (shape x batch) combinations this predictor had not run before
        (0 on a fully warm predictor)."""
        self._refuse_mesh_batch("decode" if decode else "compact")
        prm = params or self.params
        if not trivial_grid(prm):
            raise ValueError(
                "precompile_compact covers the single-scale compact-batch "
                "protocol; scale/rotation grids dispatch per image")
        if thre1 is None:
            thre1 = prm.thre1
        mode = "decode" if decode else "compact"
        spec = self._decode_spec(prm) if decode else self._compact_spec(prm)
        fresh = 0
        with self._device_scope():
            for h, w in lane_shapes:
                for n in sorted({1, *map(int, batch_sizes)}):
                    key = (mode, (n, int(h), int(w)), thre1, spec)
                    fresh += key not in self._warmed
                    imgs = np.zeros((n, int(h), int(w), 3), np.float32)
                    valid = np.tile(np.array([[h, w]], np.int32), (n, 1))
                    self._run_chunk(mode, imgs, valid, thre1, spec).cpu()
        return fresh

    # ------------------------------------------------------------------ #
    def _refuse_mesh_batch(self, mode: str) -> None:
        """The batch lanes run no mesh: it is meant for one giant
        input."""
        if self.mesh is not None:
            raise ValueError(f"{mode}_batch does not support the spatial "
                             "sharding mesh (meant for single giant inputs)")

    def _device_scope(self):
        """Makes the predictor's card current on the calling thread (the
        kernels launch on the current device), nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _run_chunk(self, mode: str, imgs: np.ndarray, valid: np.ndarray,
                   thre1: float, spec) -> torch.Tensor:
        """One same-shape chunk through the lane ``mode`` ("compact" or
        "decode"): upload, forward, extraction; (n, P) packed rows on the
        device.  Marks the chunk's program warm; the first run of a
        program not yet warm is reported to ``obs.recompile`` (the port's
        compile event) with the host seconds of its dispatch."""
        key = (mode, tuple(imgs.shape[:3]), thre1, spec)
        first = key not in self._warmed
        t0 = time.perf_counter()
        batch = self._upload(imgs)
        valid_d = self._upload(valid)
        maps = self.ensemble_maps(batch)
        extract = self.decode_maps if mode == "decode" else self.compact_maps
        rows = extract(maps, valid_d[:, 0], valid_d[:, 1], thre1, spec)
        self._warmed.add(key)
        if first:
            from ..obs.recompile import report_first_run

            report_first_run(time.perf_counter() - t0, key=key[:2])
        return rows

    def _packed_batch_async(self, images_bgr: Sequence[np.ndarray],
                            thre1: Optional[float],
                            params: Optional[InferenceParams], mode: str):
        """The batched dispatch shared by the compact and fused-decode
        lanes: images landing on the same padded shape are grouped, each
        group runs as its binary decomposition (chunks of power-of-two
        size, largest first; no padding lanes), the chunks' packed rows
        are concatenated on the device and ``resolve()`` fetches them in
        one copy and returns results in input order.  A scale / rotation
        grid dispatches each image through :meth:`_compact_ms_dispatch`
        and stacks the rows on the device, one fetch as well.  On a CUDA
        device the call only enqueues the device work: nothing is read
        back before ``resolve()``."""
        prm = params or self.params
        if not len(images_bgr):
            return lambda: []
        spec = self._decode_spec(prm) if mode == "decode" \
            else self._compact_spec(prm)

        def unpack(buf, image_size, coord_scale):
            if mode == "decode":
                return self._unpack_decoded(buf, spec, image_size,
                                            coord_scale)
            return self._unpack_compact(buf, spec[3], image_size,
                                        coord_scale)

        if not trivial_grid(prm):
            # a grid cannot share one batched forward: each image runs
            # its own grid dispatch, and the same-length packed rows are
            # stacked on the device so the batch still pays one fetch
            dispatches = [self._compact_ms_dispatch(im, thre1, prm,
                                                    mode=mode)
                          for im in images_bgr]
            with self._device_scope():
                stacked = torch.stack([d[0] for d in dispatches])

            def resolve_grid():
                buf = stacked.cpu().numpy()  # (n, P) -- one fetch
                return [unpack(buf[i], rh0, cs)
                        for i, (_, rh0, cs) in enumerate(dispatches)]

            return resolve_grid
        if thre1 is None:
            thre1 = prm.thre1
        mp = self.model_params

        prepared, sizes = [], []
        for image in images_bgr:
            oh, ow = image.shape[:2]
            scale = prm.scale_search[0] * mp.boxsize / oh
            img, (rh, rw) = self._prepare_input(image, scale)
            prepared.append(img)
            sizes.append((oh, ow, rh, rw))

        groups: Dict[Tuple[int, ...], list] = {}
        for i, p in enumerate(prepared):
            groups.setdefault(p.shape, []).append(i)

        order, bufs = [], []
        with self._device_scope():
            for idxs in groups.values():
                for chunk in _pow2_chunks(idxs):
                    bufs.append(self._run_chunk(
                        mode, np.stack([prepared[i] for i in chunk]),
                        np.array([sizes[i][2:] for i in chunk], np.int32),
                        thre1, spec))
                    order.extend(chunk)
            all_d = torch.cat(bufs, dim=0) if len(bufs) > 1 else bufs[0]

        def resolve():
            buf = all_d.cpu().numpy()  # (n, P) -- one fetch
            results = [None] * len(order)
            for row, i in enumerate(order):
                oh, ow, rh, rw = sizes[i]
                results[i] = unpack(buf[row], rh, (ow / rw, oh / rh))
            return results

        return resolve

    # ------------------------------------------------------------------ #
    def predict_decoded(self, image_bgr: np.ndarray,
                        thre1: Optional[float] = None,
                        params: Optional[InferenceParams] = None
                        ) -> DeviceDecoded:
        """Fused end-to-end decode of one image; feed the result to
        ``infer.decode.decode_device`` when ``.ok``."""
        return self.predict_decoded_async(image_bgr, thre1, params)()

    def predict_decoded_async(self, image_bgr: np.ndarray,
                              thre1: Optional[float] = None,
                              params: Optional[InferenceParams] = None):
        """Dispatch the fused decode of one image (the serving engine's
        singleton flush); returns a ``resolve()`` closure giving its
        ``DeviceDecoded``.  A scale / rotation grid runs through the grid
        dispatch (:meth:`_compact_ms_dispatch`), the assembly on the mean
        maps."""
        resolve = self._packed_batch_async([image_bgr], thre1, params,
                                           mode="decode")
        return lambda: resolve()[0]

    def predict_decoded_batch(self, images_bgr: Sequence[np.ndarray],
                              thre1: Optional[float] = None,
                              params: Optional[InferenceParams] = None
                              ) -> List[DeviceDecoded]:
        """Batched fused decode; list of ``DeviceDecoded`` per image."""
        return self.predict_decoded_batch_async(images_bgr, thre1,
                                                params)()

    def predict_decoded_batch_async(self, images_bgr: Sequence[np.ndarray],
                                    thre1: Optional[float] = None,
                                    params: Optional[InferenceParams] = None):
        """The serving lane: forward, extraction and assembly for every
        image (see :meth:`_packed_batch_async` for the grouping, chunking
        and single-fetch contract); ``resolve()`` returns one
        ``DeviceDecoded`` per image, in input order."""
        self._refuse_mesh_batch("decode")
        return self._packed_batch_async(images_bgr, thre1, params,
                                        mode="decode")

    def predict_compact(self, image_bgr: np.ndarray,
                        thre1: Optional[float] = None,
                        params: Optional[InferenceParams] = None
                        ) -> CompactResult:
        """The compact lane for one image: everything up to the
        sequential decode runs on the device and only the peak records
        and accepted limb candidates are fetched; feed the result to
        ``infer.decode.decode_compact``."""
        return self.predict_compact_async(image_bgr, thre1, params)()

    def predict_compact_async(self, image_bgr: np.ndarray,
                              thre1: Optional[float] = None,
                              params: Optional[InferenceParams] = None):
        """Dispatch the compact lane for one image; returns a
        ``resolve()`` closure giving its ``CompactResult``.  A scale /
        rotation grid runs through the grid dispatch, as
        :meth:`predict_compact_ms_async` does."""
        resolve = self._packed_batch_async([image_bgr], thre1, params,
                                           mode="compact")
        return lambda: resolve()[0]

    def predict_compact_batch(self, images_bgr: Sequence[np.ndarray],
                              thre1: Optional[float] = None,
                              params: Optional[InferenceParams] = None
                              ) -> List[CompactResult]:
        """The compact lane on N images; one ``CompactResult`` each."""
        return self.predict_compact_batch_async(images_bgr, thre1,
                                                params)()

    def predict_compact_batch_async(self, images_bgr: Sequence[np.ndarray],
                                    thre1: Optional[float] = None,
                                    params: Optional[InferenceParams] = None):
        """Batched twin of :meth:`predict_compact_async`, with the
        grouping, chunking and single-fetch contract of
        :meth:`_packed_batch_async` (the serving engine's host-pool
        lane)."""
        self._refuse_mesh_batch("compact")
        return self._packed_batch_async(images_bgr, thre1, params,
                                        mode="compact")

    def predict_fast(self, image_bgr: np.ndarray,
                     thre1: Optional[float] = None,
                     params: Optional[InferenceParams] = None):
        """The full-map lane for one image; see :meth:`predict_fast_async`.

        :returns: (heat, paf, peak_mask, (sx, sy)): maps at the scaled
            resolution; multiply decoded (x, y) by (sx, sy) to land in
            original-image coordinates."""
        return self.predict_fast_async(image_bgr, thre1, params)()

    def predict_fast_async(self, image_bgr: np.ndarray,
                           thre1: Optional[float] = None,
                           params: Optional[InferenceParams] = None):
        """Dispatch the ensemble + ``keypoint_nms`` of one image on the
        device (the JAX package's "peaks" mode: responses outside the
        valid, un-padded region are excluded from the NMS so pad-region
        activations cannot suppress edge peaks) and return a
        ``resolve()`` closure that fetches the valid region's maps and
        peak mask for the host decoder (``infer.decode.decode``).

        Only valid for a 1-entry scale/rotation grid.  As in the JAX
        package, the maps are not resized back to the original image
        size before decoding: peak coordinates are rescaled instead."""
        sk, mp = self.skeleton, self.model_params
        prm = params or self.params
        if not trivial_grid(prm):
            raise ValueError(
                "predict_fast requires a single-entry scale/rotation grid "
                "(grid ensembles: predict_compact / predict_compact_ms "
                "run them on the device; Predictor.predict on the host)")
        if thre1 is None:
            thre1 = prm.thre1
        oh, ow = image_bgr.shape[:2]
        scale = prm.scale_search[0] * mp.boxsize / oh
        img, (rh, rw) = self._prepare_input(image_bgr, scale)
        with self._device_scope(), torch.inference_mode():
            maps = self.ensemble_maps(self._upload(img[None]))[0]
            kp = maps[..., sk.paf_layers:sk.paf_layers + sk.num_parts]
            h, w = kp.shape[:2]
            dev = kp.device
            valid = ((torch.arange(h, device=dev)[:, None, None] < rh)
                     & (torch.arange(w, device=dev)[None, :, None] < rw))
            kp = torch.where(valid, kp, torch.full_like(kp, -1e9))
            peaks_d = keypoint_nms(kp, kernel=3, thre=thre1) > 0
            maps_d = maps[:rh, :rw]
            peaks_d = peaks_d[:rh, :rw]

        def resolve():
            maps = maps_d.cpu().numpy()
            peak_mask = peaks_d.cpu().numpy()
            return (maps[..., sk.paf_layers:], maps[..., :sk.paf_layers],
                    peak_mask, (ow / rw, oh / rh))

        return resolve

    # ------------------------------------------------------------------ #
    # The accuracy tiers: the scale x rotation grid
    def predict_compact_ms(self, image_bgr: np.ndarray,
                           thre1: Optional[float] = None,
                           params: Optional[InferenceParams] = None,
                           fused: Optional[bool] = None) -> CompactResult:
        """The grid's compact lane for one image; see
        :meth:`predict_compact_ms_async`."""
        return self.predict_compact_ms_async(image_bgr, thre1, params,
                                             fused=fused)()

    def predict_compact_ms_async(self, image_bgr: np.ndarray,
                                 thre1: Optional[float] = None,
                                 params: Optional[InferenceParams] = None,
                                 fused: Optional[bool] = None):
        """Dispatch the scale x rotation grid of one image on the device
        (:meth:`_compact_ms_dispatch`) and return a ``resolve()`` closure
        that fetches its one packed compact row.  Decoding happens on the
        largest scale's grid with coordinates rescaled back, as in the
        JAX package (the reference averages at the original resolution
        with cv2 resizes, which :meth:`predict` does).  ``fused`` defaults
        to the predictor's ``fused_tta``."""
        prm = params or self.params
        packed, rh0, coord_scale = self._compact_ms_dispatch(
            image_bgr, thre1, prm, fused=fused)

        def resolve():
            return self._unpack_compact(packed.cpu().numpy(),
                                        self.compact_topk, rh0, coord_scale)

        return resolve

    def _compact_ms_dispatch(self, image_bgr: np.ndarray,
                             thre1: Optional[float], prm: InferenceParams,
                             mode: str = "compact",
                             fused: Optional[bool] = None):
        """Enqueue the (scale x rotation) grid of one image; returns its
        packed row (P,), still on the device, with the decode grid's
        height and the coordinate scale back to the image.  ``mode`` is
        "compact" or "decode" (the fused assembly on the mean maps).

        ``fused`` (default ``fused_tta``): one call uploads each scale's
        image once and adds every entry into one accumulator as it is
        made, scale-major, rotation-minor; looped, each entry is a call
        of its own (its image uploaded again), its map kept, and a last
        call averages them in the same order.  Either way nothing is read
        back before the caller fetches the row.  The first dispatch of a
        (grid, image shape, form) combination is reported to
        ``obs.recompile`` as ``_run_chunk``'s first runs are."""
        if self.mesh is not None:
            raise ValueError(
                "predict_compact_ms does not support the spatial sharding "
                "mesh (use Predictor.predict for mesh-sharded inference)")
        if thre1 is None:
            thre1 = prm.thre1
        if fused is None:
            fused = self.fused_tta
        mp = self.model_params
        oh, ow = image_bgr.shape[:2]
        # decode on the LARGEST scale's grid (finest, and independent of
        # the order of scale_search)
        prepared = [self._prepare_input(image_bgr, s * mp.boxsize / oh)
                    for s in prm.scale_search]
        grid = max((valid for _, valid in prepared),
                   key=lambda v: v[0] * v[1])
        angles = tuple(prm.rotation_search)
        spec = self._decode_spec(prm) if mode == "decode" \
            else self._compact_spec(prm)
        key = ("grid", mode, fused, (oh, ow), tuple(prm.scale_search),
               angles, thre1, spec)
        first = key not in self._warmed
        t0 = time.perf_counter()
        with self._device_scope(), torch.inference_mode():
            if fused:
                self.dispatch_count += 1
                acc = None
                for img, valid in prepared:
                    img_d = self._upload(img[None])
                    for angle in angles:
                        m = self._grid_entry(img_d, valid, grid, angle)
                        acc = m if acc is None else acc + m
                packed = self._grid_extract(
                    acc, len(prepared) * len(angles), grid, thre1, spec,
                    mode)
            else:
                entries = [self._grid_entry(self._upload(img[None]), valid,
                                            grid, angle)
                           for img, valid in prepared for angle in angles]
                self.dispatch_count += len(entries) + 1
                packed = self._grid_average(entries, grid, thre1, spec,
                                            mode)
        self._warmed.add(key)
        if first:
            from ..obs.recompile import report_first_run

            report_first_run(time.perf_counter() - t0, key=key[:4])
        return packed, grid[0], (ow / grid[1], oh / grid[0])

    def _grid_entry(self, img: torch.Tensor, valid: Tuple[int, int],
                    grid: Tuple[int, int], angle: float) -> torch.Tensor:
        """One grid entry: the (1, H, W, 3) padded image on the device ->
        the flip-ensembled maps of its valid region, rotated back when
        ``angle`` is not 0, resized onto ``grid``: (1, grid h, grid w, C).

        A rotated entry rotates the valid region about its centre with a
        zero border (the pad excluded from sampling and filled with the
        pad value again after), runs the ensemble on it and rotates the
        maps back before the regrid.  The centre is the reference's
        (h/2, w/2) passed as (cx, cy) (evaluate.py:108); like the JAX
        package, the pre-pad region is rotated, where the reference
        rotates the padded frame (PARITY.md)."""
        rh, rw = valid
        center = (rh / 2, rw / 2)
        lane = img
        if angle != 0.0:
            pad_norm = self.model_params.pad_value / 255.0
            lane = img.clone()
            lane[:, rh:] = 0.0
            lane[:, :, rw:] = 0.0
            lane = _warp_rotate(lane, angle, center)
            lane[:, rh:] = pad_norm
            lane[:, :, rw:] = pad_norm
        maps = self.ensemble_maps(lane)[:, :rh, :rw]
        if angle != 0.0:
            maps = _warp_rotate(maps, -angle, center)
        return resize_cubic(maps, grid)

    def _grid_average(self, entries: List[torch.Tensor],
                      grid: Tuple[int, int], thre1: float, spec,
                      mode: str) -> torch.Tensor:
        """The looped grid's last call: the entries' kept maps summed in
        order, then :meth:`_grid_extract`."""
        acc = entries[0]
        for m in entries[1:]:
            acc = acc + m
        return self._grid_extract(acc, len(entries), grid, thre1, spec,
                                  mode)

    def _grid_extract(self, acc: torch.Tensor, n_entries: int,
                      grid: Tuple[int, int], thre1: float, spec,
                      mode: str) -> torch.Tensor:
        """The entries' sum -> their mean -> the packed compact (or fused
        decode) row, (P,), with the whole grid as the valid region."""
        valid = self._upload(np.array([grid], np.int32))
        extract = self.decode_maps if mode == "decode" else self.compact_maps
        return extract(acc / n_entries, valid[:, 0], valid[:, 1], thre1,
                       spec)[0]

    def predict(self, image_bgr: np.ndarray,
                params: Optional[InferenceParams] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """The host full-map protocol (reference: evaluate.py:83-166): the
        maps averaged over the scale x rotation grid at the original
        resolution.  Each entry resizes (cv2 ``INTER_CUBIC``) and, when
        rotated, warps the image on the host (``getRotationMatrix2D`` +
        ``warpAffine``), runs :meth:`ensemble_maps` on the padded image
        on the device, fetches its full maps, and unpads, un-rotates and
        resizes them back on the host.

        :param image_bgr: (H, W, 3) uint8, cv2 order
        :returns: (heat (H, W, heat_layers + 2), paf (H, W, paf_layers))
        """
        sk, mp = self.skeleton, self.model_params
        prm = params or self.params
        oh, ow = image_bgr.shape[:2]
        heat_avg = np.zeros((oh, ow, sk.heat_layers + 2), np.float32)
        paf_avg = np.zeros((oh, ow, sk.paf_layers), np.float32)
        multipliers = [s * mp.boxsize / oh for s in prm.scale_search]
        grid = [(s, a) for s in multipliers for a in prm.rotation_search]
        for scale, angle in grid:
            rot_back = None
            if angle != 0:
                scale = self._clamp_scale(scale, oh, ow)
                resized = cv2.resize(image_bgr, (0, 0), fx=scale, fy=scale,
                                     interpolation=cv2.INTER_CUBIC)
                rc = (resized.shape[0] / 2, resized.shape[1] / 2)
                rot = cv2.getRotationMatrix2D(rc, angle, 1)
                rot_back = cv2.getRotationMatrix2D(rc, -angle, 1)
                resized = cv2.warpAffine(resized, rot, (0, 0))
                rh, rw = resized.shape[:2]
                padded, _ = pad_right_down(resized, self.bucket,
                                           mp.pad_value)
                img = padded.astype(np.float32) / 255.0
            else:
                img, (rh, rw) = self._prepare_input(image_bgr, scale)
            with self._device_scope():
                maps = self.ensemble_maps(self._upload(img[None]))[0]
                maps = maps.cpu().numpy()[:rh, :rw]
            if rot_back is not None:
                maps = cv2.warpAffine(maps, rot_back, (0, 0))
            maps = cv2.resize(maps, (ow, oh), interpolation=cv2.INTER_CUBIC)
            paf_avg += maps[..., :sk.paf_layers] / len(grid)
            heat_avg += maps[..., sk.paf_layers:] / len(grid)
        return heat_avg, paf_avg

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the lane's device.  On a CUDA device the copy
        goes through pinned memory asynchronously: a blocking copy would
        make the host wait for the work already queued (an earlier
        chunk's forward and decode)."""
        t = torch.from_numpy(array)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------------------------------------------------------ #
    def _unpack_compact(self, buf: np.ndarray, k: int, image_size: int,
                        coord_scale: Tuple[float, float]) -> CompactResult:
        """Split one packed fp32 compact buffer back into typed records."""
        c = self.skeleton.num_parts
        n_limbs = len(self.skeleton.limbs_conn)
        m = COMPACT_M_FACTOR * k  # candidate cap per limb (device m_cap)
        fields, pos = [], 0
        for shape, dtype in (
                ((c, k), np.int32), ((c, k), np.int32),       # xs, ys
                ((c, k), np.float32), ((c, k), np.float32),   # x/y_ref
                ((c, k), np.float32),                         # score
                ((c, k), bool), ((c,), np.int32),             # valid, count
                ((n_limbs, m), np.int32),                     # slot_a
                ((n_limbs, m), np.int32),                     # slot_b
                ((n_limbs, m), np.float32),                   # prior
                ((n_limbs, m), np.float32),                   # norm
                ((n_limbs, m), bool),                         # valid
                ((n_limbs,), np.int32)):                      # count
            n = int(np.prod(shape))
            chunk = buf[pos:pos + n].reshape(shape)
            fields.append(chunk.astype(dtype) if dtype is not np.float32
                          else chunk)
            pos += n
        if pos != buf.size:
            raise RuntimeError(f"compact payload size mismatch: parsed "
                               f"{pos} of {buf.size} floats")
        return CompactResult(peaks=TopKPeaks(*fields[:7]),
                             stats=LimbCandidates(*fields[7:]),
                             image_size=image_size, coord_scale=coord_scale)

    def _compact_payload_floats(self, k: int) -> int:
        """Length of the packed compact payload for top-K capacity ``k``
        -- the split point of the fused decode buffer."""
        c = self.skeleton.num_parts
        n_limbs = len(self.skeleton.limbs_conn)
        m = COMPACT_M_FACTOR * k
        # TopKPeaks: six (C, K) arrays + (C,) count;
        # LimbCandidates: five (L, M) arrays + (L,) count
        return 6 * c * k + c + 5 * n_limbs * m + n_limbs

    def _unpack_decoded(self, buf: np.ndarray, spec, image_size: int,
                        coord_scale: Tuple[float, float]) -> DeviceDecoded:
        """Split one packed fp32 fused-decode buffer back into a
        ``DeviceDecoded`` (layout twin of :meth:`decode_maps`)."""
        compact_spec, asm_spec = spec
        k, p_max = compact_spec[3], asm_spec[0]
        n_compact = self._compact_payload_floats(k)
        compact = self._unpack_compact(buf[:n_compact], k, image_size,
                                       coord_scale)
        rows = self.skeleton.num_parts + 2
        pos = n_compact
        subset = buf[pos:pos + p_max * rows * 2].reshape(p_max, rows, 2)
        pos += p_max * rows * 2
        mask = buf[pos:pos + p_max] > 0.5
        pos += p_max
        n_people, peak_of, cand_of, person_of = buf[pos:pos + 4]
        if pos + 4 != buf.size:
            # a pack/unpack layout drift would read the overflow flags
            # from wrong offsets: a hard error even under `python -O`
            raise RuntimeError(
                f"fused decode payload size mismatch: parsed {pos + 4} "
                f"of {buf.size} floats")
        return DeviceDecoded(
            subset=subset, mask=mask, n_people=int(n_people),
            peak_overflow=bool(peak_of > 0.5),
            cand_overflow=bool(cand_of > 0.5),
            person_overflow=bool(person_of > 0.5),
            compact=compact)

    def _clamp_scale(self, scale: float, oh: int, ow: int) -> float:
        mp = self.model_params
        if scale * oh > mp.max_height or scale * ow > mp.max_width:
            scale = min(mp.max_height / oh, mp.max_width / ow)
        return scale

    def _prepare_input(self, image_bgr: np.ndarray, scale: float):
        """Clamp scale, cubic resize, bucket pad, normalise to [0, 1];
        returns (image, (valid_h, valid_w))."""
        oh, ow = image_bgr.shape[:2]
        scale = self._clamp_scale(scale, oh, ow)
        resized = cv2.resize(image_bgr, (0, 0), fx=scale, fy=scale,
                             interpolation=cv2.INTER_CUBIC)
        rh, rw = resized.shape[:2]
        padded, _ = pad_right_down(resized, self.bucket,
                                   self.model_params.pad_value)
        return padded.astype(np.float32) / 255.0, (rh, rw)
