"""Deterministic synthetic corpus fixture for tests and smoke runs.

The port's copy of ``improved_body_parts_tpu/data/fixture.py``
(``synthetic_person``, ``draw_person``, ``_synth_image``,
``build_fixture``; the COCO-format val/train set writers are not ported
yet), so one seed writes the same records in both packages.

Writes a tiny HDF5 file with the exact schema of the real corpus builder
(see hdf5_corpus.py / reference data/coco_masks_hdf5.py): groups ``dataset`` /
``images`` / ``masks``, per-main-person JSON records.  People are simple stick
figures with plausible COCO-order joints so the GT synthesis produces
non-trivial heatmaps.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .hdf5_corpus import write_record

# rough upright stick figure in a unit box: (x, y) per COCO part
_UNIT_POSE = {
    "nose": (0.50, 0.10), "Leye": (0.55, 0.07), "Reye": (0.45, 0.07),
    "Lear": (0.60, 0.09), "Rear": (0.40, 0.09),
    "Lsho": (0.65, 0.25), "Rsho": (0.35, 0.25),
    "Lelb": (0.70, 0.42), "Relb": (0.30, 0.42),
    "Lwri": (0.72, 0.58), "Rwri": (0.28, 0.58),
    "Lhip": (0.60, 0.55), "Rhip": (0.40, 0.55),
    "Lkne": (0.60, 0.75), "Rkne": (0.40, 0.75),
    "Lank": (0.60, 0.95), "Rank": (0.40, 0.95),
}


def synthetic_person(rng: np.random.Generator, img_w: int, img_h: int,
                     image_size: int, all_visible: bool = False,
                     hard: bool = False):
    """One stick-figure person record.

    ``hard=True`` is the harder benchmark tier (round-5): a wider scale
    range (0.25–0.85 vs 0.4–0.8 of image height) and a per-person
    IN-PLANE ROTATION of the whole figure (uniform ±60°) about its
    centre — beyond the training augmentation's ±40° range
    (configs.TransformParams.max_rotate_degree), so upright-only
    inference degrades and the reference's rotation TTA grid
    (reference: evaluate.py:89-90) has poses where it genuinely pays.
    The bbox/objpos/scale are recomputed from the rotated joints, the
    way COCO boxes follow the person, not the canvas.
    """
    from ..config import COCO_PARTS

    lo, hi = (0.25, 0.85) if hard else (0.4, 0.8)
    h = rng.uniform(lo, hi) * img_h
    w = 0.5 * h
    x0 = rng.uniform(0, max(img_w - w, 1))
    y0 = rng.uniform(0, max(img_h - h, 1))
    joints = np.zeros((len(COCO_PARTS), 3))
    for i, part in enumerate(COCO_PARTS):
        ux, uy = _UNIT_POSE[part]
        joints[i, 0] = x0 + ux * w + rng.normal(0, 2)
        joints[i, 1] = y0 + uy * h + rng.normal(0, 2)
        # stored (internal) visibility: 1 visible, 0 occluded, 2 unlabeled
        joints[i, 2] = 1 if all_visible else rng.choice([0, 1], p=[0.2, 0.8])
    bbox = [x0, y0, w, h]
    if hard:
        theta = np.radians(rng.uniform(-60.0, 60.0))
        c, s = np.cos(theta), np.sin(theta)
        cx, cy = x0 + w / 2, y0 + h / 2
        dx, dy = joints[:, 0] - cx, joints[:, 1] - cy
        joints[:, 0] = cx + c * dx - s * dy
        joints[:, 1] = cy + s * dx + c * dy
        # keep the figure on-canvas after rotation; when it cannot fit
        # (rotated extent wider than the canvas), center it instead —
        # min(lo, hi) ordering matters, np.clip(0, lo, hi) silently
        # returns hi when lo > hi
        for axis, bound in ((0, img_w - 1), (1, img_h - 1)):
            lo = -joints[:, axis].min()          # shift needed at the low edge
            hi = bound - joints[:, axis].max()   # headroom at the high edge
            joints[:, axis] += (lo + hi) / 2 if lo > hi else np.clip(0, lo, hi)
        margin = 0.05 * h
        jx0, jy0 = joints[:, 0].min() - margin, joints[:, 1].min() - margin
        bw = joints[:, 0].max() + margin - jx0
        bh = joints[:, 1].max() + margin - jy0
        bbox = [jx0, jy0, bw, bh]
        x0, y0, w, h = jx0, jy0, bw, bh
    return {
        "objpos": [x0 + w / 2, y0 + h / 2],
        "bbox": bbox,
        "segment_area": w * h,
        "num_keypoints": 17,
        "joint": joints,
        "scale_provided": h / image_size,
    }


# limb segments for RENDERING drawn people (COCO part names); bright
# part/limb colors make the figures genuinely learnable from pixels,
# unlike the noise-background fixture — but mirror counterparts MUST
# share a color (see _canonical) or the flip ensemble self-destructs
_DRAW_LIMBS = [
    ("nose", "Leye"), ("nose", "Reye"), ("Leye", "Lear"), ("Reye", "Rear"),
    ("Lsho", "Rsho"), ("Lsho", "Lelb"), ("Lelb", "Lwri"),
    ("Rsho", "Relb"), ("Relb", "Rwri"), ("Lsho", "Lhip"), ("Rsho", "Rhip"),
    ("Lhip", "Rhip"), ("Lhip", "Lkne"), ("Lkne", "Lank"),
    ("Rhip", "Rkne"), ("Rkne", "Rank"),
]


def _part_color(i: int):
    # fixed, well-separated 8-bit colors (deterministic, no rng)
    return (int((37 + i * 53) % 200 + 55), int((91 + i * 97) % 200 + 55),
            int((13 + i * 151) % 200 + 55))


def _canonical(name: str) -> str:
    """Strip the L/R prefix so mirror-counterpart parts share a color.

    The flip-ensemble (and real human appearance) assumes left/right
    symmetry: a mirrored left shoulder must LOOK like a right shoulder.
    Chiral per-part colors break that — the flipped inference lane then
    contradicts the unflipped one and the ensemble average destroys the
    peaks (measured: heat max 1.0 raw → 0.21 ensembled).  With shared
    colors the model disambiguates left/right from pose geometry, as on
    real people.
    """
    return name[1:] if len(name) > 1 and name[0] in "LR" else name


def _color_index(name: str) -> int:
    order = ["nose", "eye", "ear", "sho", "elb", "wri", "hip", "kne", "ank"]
    return order.index(_canonical(name))


def draw_person(img: np.ndarray, joints: np.ndarray) -> None:
    """Render one stick figure into ``img`` in place.

    Limbs are thick colored lines, joints filled circles with a per-part
    color.  Joints with stored visibility < 2 (visible AND occluded) are
    drawn — the same ``v < 2`` rule the heatmapper uses to synthesize GT
    (heatmapper.py), so every labeled joint has pixel evidence and the
    fixture stays learnable even without ``all_visible``.
    """
    import cv2

    from ..config import COCO_PARTS

    idx = {p: i for i, p in enumerate(COCO_PARTS)}
    for a, b in _DRAW_LIMBS:
        pa, pb = joints[idx[a]], joints[idx[b]]
        if pa[2] < 2 and pb[2] < 2:
            # limb color from the canonical endpoint pair, so mirror
            # limbs (Lsho-Lelb / Rsho-Relb) are identically colored
            ci = 9 + _color_index(a) + 2 * _color_index(b)
            cv2.line(img, (int(pa[0]), int(pa[1])), (int(pb[0]), int(pb[1])),
                     _part_color(ci), thickness=3)
    for i, name in enumerate(COCO_PARTS):
        x, y, v = joints[i]
        if v < 2:
            cv2.circle(img, (int(x), int(y)), 4,
                       _part_color(_color_index(name)), thickness=-1)


def _render_crowd_box(rng: np.random.Generator, img: np.ndarray,
                      image_size: int) -> np.ndarray:
    """Draw a crowd: several overlapping partial stick figures inside a
    box; returns the {0,1} crowd mask (the synthetic stand-in for COCO's
    RLE crowd regions, reference coco_masks_hdf5.py:66-99)."""
    h, w = img.shape[:2]
    bw = int(rng.uniform(0.25, 0.4) * w)
    bh = int(rng.uniform(0.3, 0.5) * h)
    x0 = int(rng.uniform(0, w - bw))
    y0 = int(rng.uniform(0, h - bh))
    for _ in range(3):
        p = synthetic_person(rng, bw, bh, image_size, all_visible=True)
        joints = p["joint"].copy()
        joints[:, 0] += x0
        joints[:, 1] += y0
        draw_person(img, joints)
    mask = np.zeros((h, w), np.uint8)
    mask[y0:y0 + bh, x0:x0 + bw] = 1
    return mask


def _synth_image(rng: np.random.Generator, h: int, w: int,
                 people_per_image: int, image_size: int, drawn: bool,
                 crowd: bool = False, hard: bool = False):
    """One synthetic image + its person records (shared by the corpus and
    val-set builders so train and eval see the same distribution).

    ``crowd=True`` (drawn protocol only) additionally renders, with pixel
    evidence but NO ground truth: an unannotated person (appended to
    ``persons`` with ``num_keypoints=0`` — the corpus rules then exclude
    it from records and zero its region in mask_miss) and/or a crowd box
    of overlapping figures (returned as a crowd mask).  This reproduces
    the structure that makes the reference's miss-mask machinery matter
    (reference: coco_masks_hdf5.py:38-116, loss_model.py:52-56): real
    people in pixels the loss must NOT penalize the model for detecting.

    Returns (img, persons, crowd_masks).
    """
    if drawn:
        # low-amplitude noise background so the rendered figures are the
        # dominant signal — this is the LEARNABLE variant
        img = rng.integers(0, 64, (h, w, 3), dtype=np.uint8)
        persons = [synthetic_person(rng, w, h, image_size, all_visible=True,
                                    hard=hard)
                   for _ in range(people_per_image)]
        for p in persons:
            draw_person(img, p["joint"])
    else:
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        persons = [synthetic_person(rng, w, h, image_size, hard=hard)
                   for _ in range(people_per_image)]
    crowd_masks = []
    if crowd:
        add_unannotated = bool(rng.uniform() < 0.5)
        add_crowd = bool(rng.uniform() < 0.5) or not add_unannotated
        if add_unannotated:
            extra = synthetic_person(rng, w, h, image_size, all_visible=True)
            if drawn:
                draw_person(img, extra["joint"])
            extra["num_keypoints"] = 0  # pixel evidence, no annotation
            persons.append(extra)
        if add_crowd:
            crowd_masks.append(_render_crowd_box(rng, img, image_size))
    return img, persons, crowd_masks


def build_fixture(path: str, num_images: int = 4, img_size: Tuple[int, int]
                  = (240, 320), people_per_image: int = 2,
                  image_size: int = 512, seed: int = 0,
                  drawn: bool = False, crowd: bool = False,
                  mask_extras: bool = True, hard: bool = False) -> int:
    """Write the fixture; returns the number of records.

    ``drawn=True`` renders the stick figures into the images (visible,
    colored limbs/joints on a quiet background) so a model can genuinely
    LEARN detection from pixels and generalize — the default noise images
    carry no pixel signal and only support overfit/protocol tests.

    ``crowd=True`` adds unannotated people and crowd regions with pixel
    evidence but no GT (see ``_synth_image``), producing corpora with
    non-trivial mask_miss — the end-to-end exercise of the reference's
    miss-mask semantics.  ``mask_extras=False`` is the ablation: the SAME
    extras are rendered but mask_miss stays all-ones, so training wrongly
    penalizes the model for detecting them (quantifies what the masking
    machinery buys; tools/synth_ap.py --crowd runs both arms).
    """
    import h5py

    from .hdf5_corpus import build_masks, iter_records

    rng = np.random.default_rng(seed)
    h, w = img_size
    count = 0
    with h5py.File(path, "w") as f:
        grp = f.create_group("dataset")
        img_grp = f.create_group("images")
        mask_grp = f.create_group("masks")
        for image_index in range(num_images):
            img_id = 1000 + image_index
            img, persons, crowd_masks = _synth_image(
                rng, h, w, people_per_image, image_size, drawn, crowd=crowd,
                hard=hard)
            person_masks = []
            for p in persons:
                m = np.zeros((h, w), np.uint8)
                x0, y0, bw, bh = [int(v) for v in p["bbox"]]
                m[max(y0, 0): y0 + bh, max(x0, 0): x0 + bw] = 1
                person_masks.append(m)
            mask_miss, mask_all = build_masks(
                (h, w), person_masks, [p["num_keypoints"] for p in persons],
                crowd_masks=crowd_masks)
            if not mask_extras:
                mask_miss = np.full((h, w), 255, np.uint8)
            image_rec = {"width": w, "height": h}
            for rec in iter_records(image_rec, img_id, image_index, persons,
                                    "SYNTH", is_validation=False):
                write_record(grp, img_grp, mask_grp, rec, count, img,
                             mask_miss, mask_all)
                count += 1
    return count
