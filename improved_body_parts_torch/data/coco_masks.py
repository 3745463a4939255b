"""Dependency-free COCO segmentation-mask decoding.

A copy of ``improved_body_parts_tpu/data/coco_masks.py``: the port imports nothing
of the JAX package, and its tests hold the two equal.

The reference corpus builder decodes every annotation's segmentation with
pycocotools (reference: data/coco_masks_hdf5.py:6,52-76 ``annToMask``),
which made the full COCO-format user journey (JSON+images → HDF5 → train
→ evaluate) impossible in environments without that Cython package.  This
module implements all three COCO segmentation encodings in NumPy/OpenCV:

- **uncompressed RLE** — ``{"counts": [int, ...], "size": [h, w]}``,
  column-major alternating background/foreground run lengths;
- **compressed RLE** — ``counts`` as an ASCII string: pycocotools'
  5-bits-per-char LEB128 variant with difference coding of every count
  after the third against the count two positions back (the exact
  algorithm of pycocotools ``rleFrString`` — byte-for-byte compatible,
  verified by an encode→decode roundtrip test and golden strings);
- **polygons** — ``[[x0, y0, x1, y1, ...], ...]`` rasterized with
  ``cv2.fillPoly``.

pycocotools is deliberately NOT used even when importable: its polygon
rasterizer (``rleFrPoly``, 5× upsampled boundary walk) differs from
``cv2.fillPoly`` by boundary pixels, so an "optional fast path" would
make corpus content depend on the build environment.  Pure NumPy keeps
corpora bit-identical everywhere; RLE decoding (both kinds) is exact, and
the polygon boundary deviation (≤1 px, documented in PARITY.md) is far
below the 8×-downsampled resolution at which masks enter the loss
(reference: loss_model.py:52-56).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import cv2
import numpy as np


def rle_decode(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    """Uncompressed-RLE → (h, w) uint8 {0,1} mask.

    Runs are column-major (Fortran order) and start with background, per
    the COCO spec (pycocotools ``rleDecode``).
    """
    counts = np.asarray(counts, dtype=np.int64)
    if counts.sum() != h * w:
        raise ValueError(
            f"RLE runs sum to {int(counts.sum())}, expected h*w={h * w}")
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    return np.repeat(vals, counts).reshape((h, w), order="F")


def rle_from_string(s: Union[str, bytes]) -> List[int]:
    """Compressed-RLE counts string → list of run lengths.

    Implements pycocotools ``rleFrString``: 5 data bits per character
    (ASCII offset 48), bit 0x20 = continuation, sign-extension via bit
    0x10 of the final character, and counts[i] for i ≥ 3 stored as a
    difference against counts[i-2].
    """
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def rle_to_string(counts: Sequence[int]) -> str:
    """Run lengths → compressed counts string (pycocotools ``rleToString``).

    The encoder exists so synthetic COCO-format fixtures can exercise the
    compressed decode path without pycocotools; the roundtrip is pinned by
    tests.
    """
    out: List[str] = []
    counts = list(counts)
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5  # Python's >> is arithmetic, matching the C long
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_encode(mask: np.ndarray) -> List[int]:
    """(h, w) {0,1} mask → uncompressed run lengths (column-major)."""
    flat = np.asarray(mask, np.uint8).reshape(-1, order="F")
    if flat.size == 0:
        return []
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0] == 1:  # runs must start with background
        counts = [0] + counts
    return counts


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int
                     ) -> np.ndarray:
    """COCO polygon list → (h, w) uint8 {0,1} mask via ``cv2.fillPoly``.

    Documented deviation: pycocotools rasterizes polygons through a 5×
    upsampled boundary walk (``rleFrPoly``), which can differ from
    ``cv2.fillPoly`` by single boundary pixels.  See module docstring.
    """
    mask = np.zeros((h, w), np.uint8)
    pts = [np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int32)
           for p in polygons if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """One COCO annotation → (h, w) uint8 {0,1} mask.

    Dispatches on the segmentation encoding exactly as pycocotools
    ``annToRLE`` does (reference usage: data/coco_masks_hdf5.py:52-76):
    dict → RLE (string counts = compressed), list → polygons.
    """
    seg = ann.get("segmentation")
    if seg is None:
        raise ValueError(f"annotation {ann.get('id')} has no segmentation")
    if isinstance(seg, dict):
        sh, sw = seg["size"]
        if (sh, sw) != (h, w):
            raise ValueError(
                f"RLE size {(sh, sw)} != image size {(h, w)}")
        counts = seg["counts"]
        if isinstance(counts, (str, bytes)):
            counts = rle_from_string(counts)
        return rle_decode(counts, sh, sw)
    return polygons_to_mask(seg, h, w)
