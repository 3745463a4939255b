"""Flip-ensemble prediction and the fused device decode (the serve lane).

Counterpart of the batched fused-decode lane of
``improved_body_parts_tpu/infer/predict.py``
(``Predictor.predict_decoded_batch_async``, the program
``_compact_batch_fn(_decode_extract_fn)``).  Per batch of same-shape
images, all on the device:

1. one forward of the IMHN over [images, mirrored images] (2N lanes);
2. the flip merge (mirror-lane channel permutation + average);
3. the x stride cubic upsample (``infer.resize``);
4. per image, peak top-K (``ops.peaks.topk_peaks``), dense limb sampling
   (``limb_pair_stats``), acceptance + top-M ranking
   (``limb_topk_from_stats``) and greedy assembly
   (``ops.assembly.greedy_assemble``);
5. everything packed into one fp32 row per image, fetched once.

The packed row keeps the JAX package's layout exactly, so one unpacker
reads either package's buffers.  Host preprocessing (cubic resize to
``boxsize``, bucket padding) is the JAX package's, with cv2.  Not ported
yet (ROADMAP): the multi-scale / rotation grid and fused TTA, the
``maps`` / ``peaks`` / ``compact`` modes, device replicas and the
spatial mesh.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np
import torch

from .. import resolve_device
from ..config import (
    InferenceModelParams,
    InferenceParams,
    SkeletonConfig,
    default_inference_params,
)
from ..ops.assembly import greedy_assemble
from ..ops.peaks import (
    LimbCandidates,
    TopKPeaks,
    limb_pair_stats,
    limb_topk_from_stats,
    topk_peaks,
)
from .decode import CompactResult, DeviceDecoded
from .resize import upsample_cubic

# candidate cap of the compact payload, as a multiple of the peak top-K:
# m_cap = COMPACT_M_FACTOR * compact_topk accepted pairs ship per limb
COMPACT_M_FACTOR = 2


def trivial_grid(prm: InferenceParams) -> bool:
    """True when the ensemble grid is a single scale and no rotation --
    the protocol the batched decode lane covers."""
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
    """Runs the fused decode lane of ``model`` on ``device`` (``"cuda"``
    unless the caller asks for ``"cpu"``, where the kernels' plain
    versions run).

    ``model`` maps (N, H, W, 3) float images in [0, 1] to ``[stack][scale]``
    NHWC float32 predictions (``models.posenet.PoseNet``) and lies on
    ``device``.  ``compact_topk`` is the per-channel peak capacity,
    ``assembly_pmax`` the person-table capacity; crowds past either set
    an overflow flag in the result (``DeviceDecoded.ok``).
    """

    def __init__(self, model, skeleton: SkeletonConfig,
                 params: Optional[InferenceParams] = None,
                 model_params: Optional[InferenceModelParams] = None,
                 bucket: int = 128, compact_topk: int = 64,
                 assembly_pmax: int = 32, device="cuda"):
        d_params, d_model_params = default_inference_params()
        self.device = resolve_device(device)
        self.model = model
        self.skeleton = skeleton
        self.params = params or d_params
        self.model_params = model_params or d_model_params
        self.bucket = max(bucket, self.model_params.max_downsample)
        self.compact_topk = compact_topk
        self.assembly_pmax = assembly_pmax

    # ------------------------------------------------------------------ #
    def _decode_spec(self, prm: InferenceParams):
        """((thre2, mid_num, offset_radius, top-K, connect_ration),
        (p_max, len_rate, connection_tole, remove_recon, min_parts,
        min_mean_score)): the extraction and assembly knobs, in the JAX
        package's spec order."""
        return ((prm.thre2, prm.mid_num, prm.offset_radius,
                 self.compact_topk, prm.connect_ration),
                (self.assembly_pmax, prm.len_rate, prm.connection_tole,
                 prm.remove_recon, prm.min_parts, prm.min_mean_score))

    def _merge_flip(self, straight: torch.Tensor, mirrored: torch.Tensor
                    ) -> torch.Tensor:
        """Mirror-lane channel permutation + averaging + paf/heat concat.
        ``mirrored`` must already be width-unflipped."""
        sk = self.skeleton
        dev = straight.device
        flip_paf = torch.as_tensor(sk.flip_paf_ord, device=dev)
        flip_heat = torch.as_tensor(sk.flip_heat_ord, device=dev)
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
        out = self.model(both)[-1][0]           # (2N, H/4, W/4, C) fp32
        maps = self._merge_flip(out[:n], out[n:].flip(2))
        return upsample_cubic(maps, self.skeleton.stride)

    @torch.inference_mode()
    def decode_maps(self, maps: torch.Tensor, valid_h: torch.Tensor,
                    valid_w: torch.Tensor, thre1: float, spec
                    ) -> torch.Tensor:
        """Ensembled maps -> one packed fp32 row per image: the compact
        records, the greedy-assembled person table, its prune mask and
        [n_people, peak/cand/person overflow] (layout twin of
        :meth:`_unpack_decoded`)."""
        sk = self.skeleton
        (thre2, mid_num, radius, topk, connect_ration), asm_spec = spec
        p_max, len_rate, connection_tole, remove_recon, min_parts, \
            min_mean_score = asm_spec
        limbs_from = tuple(a for a, _ in sk.limbs_conn)
        limbs_to = tuple(b for _, b in sk.limbs_conn)
        kp = maps[..., sk.paf_layers:sk.paf_layers + sk.num_parts]
        paf = maps[..., :sk.paf_layers]
        peaks = topk_peaks(kp, valid_h, valid_w, thre=thre1, k=topk,
                           radius=radius)
        stats = limb_pair_stats(paf, peaks.x_ref, peaks.y_ref,
                                limbs_from=limbs_from, limbs_to=limbs_to,
                                num_samples=mid_num, thre2=thre2)
        cands = limb_topk_from_stats(stats, peaks, valid_h,
                                     limbs_from=limbs_from,
                                     limbs_to=limbs_to,
                                     connect_ration=connect_ration,
                                     m_cap=COMPACT_M_FACTOR * topk)
        asm = greedy_assemble(
            peaks, cands, limbs_from=limbs_from, limbs_to=limbs_to,
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
    def predict_decoded(self, image_bgr: np.ndarray,
                        thre1: Optional[float] = None,
                        params: Optional[InferenceParams] = None
                        ) -> DeviceDecoded:
        """Fused end-to-end decode of one image; feed the result to
        ``infer.decode.decode_device`` when ``.ok``."""
        return self.predict_decoded_batch([image_bgr], thre1, params)[0]

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
        """The serving lane: images landing on the same padded shape are
        grouped, each group runs as its binary decomposition (chunks of
        power-of-two size, largest first; no padding lanes), the chunks'
        packed rows are concatenated on the device and ``resolve()``
        fetches them in one copy and returns results in input order."""
        prm = params or self.params
        if not trivial_grid(prm):
            raise NotImplementedError(
                "the multi-scale / rotation grid is not ported yet "
                "(ROADMAP.md: grid and fused TTA)")
        if thre1 is None:
            thre1 = prm.thre1
        if not len(images_bgr):
            return lambda: []
        mp = self.model_params
        spec = self._decode_spec(prm)

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
        for idxs in groups.values():
            for chunk in _pow2_chunks(idxs):
                batch = torch.from_numpy(
                    np.stack([prepared[i] for i in chunk])).to(self.device)
                valid = torch.tensor([sizes[i][2:] for i in chunk],
                                     dtype=torch.int32, device=self.device)
                maps = self.ensemble_maps(batch)
                bufs.append(self.decode_maps(maps, valid[:, 0], valid[:, 1],
                                             thre1, spec))
                order.extend(chunk)
        all_d = torch.cat(bufs, dim=0) if len(bufs) > 1 else bufs[0]

        def resolve():
            buf = all_d.cpu().numpy()  # (n, P) -- one fetch
            results = [None] * len(order)
            for row, i in enumerate(order):
                oh, ow, rh, rw = sizes[i]
                results[i] = self._unpack_decoded(buf[row], spec, rh,
                                                  (ow / rw, oh / rh))
            return results

        return resolve

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
