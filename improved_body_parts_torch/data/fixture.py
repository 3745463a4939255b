"""Deterministic synthetic corpus fixture for tests and smoke runs.

The port's copy of ``improved_body_parts_tpu/data/fixture.py``
(``synthetic_person``, ``draw_person``, ``_synth_image``,
``build_fixture`` and the COCO-format writers ``build_val_set`` and
``build_coco_train_set``), so one seed writes the same records, images
and annotation JSON in both packages; ``fixture_records`` gives
``build_fixture``'s records in memory, for a host without h5py, and
``save_records`` / ``load_records`` keep them in a NumPy ``.npz`` file
that ``data.dataset.open_corpus`` (and so ``cli.train --train-h5``)
opens as a ``MemoryDataset``.

Writes a tiny HDF5 file with the exact schema of the real corpus builder
(see hdf5_corpus.py / reference data/coco_masks_hdf5.py): groups ``dataset`` /
``images`` / ``masks``, per-main-person JSON records.  People are simple stick
figures with plausible COCO-order joints so the GT synthesis produces
non-trivial heatmaps.
"""
from __future__ import annotations

import json
from typing import Tuple

import numpy as np

from ..obs.events import strict_dump, strict_dumps
from .hdf5_corpus import NUM_COCO_PARTS, write_record

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


def _fixture_images(num_images: int, img_size: Tuple[int, int],
                    people_per_image: int, image_size: int, seed: int,
                    drawn: bool, crowd: bool, mask_extras: bool,
                    hard: bool):
    """Yield (img, mask_miss, mask_all, records) for each fixture image,
    in the order :func:`build_fixture` writes them."""
    from .hdf5_corpus import build_masks, iter_records

    rng = np.random.default_rng(seed)
    h, w = img_size
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
        yield img, mask_miss, mask_all, list(iter_records(
            image_rec, img_id, image_index, persons, "SYNTH",
            is_validation=False))


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

    count = 0
    with h5py.File(path, "w") as f:
        grp = f.create_group("dataset")
        img_grp = f.create_group("images")
        mask_grp = f.create_group("masks")
        for img, mask_miss, mask_all, recs in _fixture_images(
                num_images, img_size, people_per_image, image_size, seed,
                drawn, crowd, mask_extras, hard):
            for rec in recs:
                write_record(grp, img_grp, mask_grp, rec, count, img,
                             mask_miss, mask_all)
                count += 1
    return count


def fixture_records(num_images: int = 4, img_size: Tuple[int, int]
                    = (240, 320), people_per_image: int = 2,
                    image_size: int = 512, seed: int = 0,
                    drawn: bool = False, crowd: bool = False,
                    mask_extras: bool = True, hard: bool = False) -> list:
    """The records :func:`build_fixture` would write for the same
    arguments, in its order, held in memory (no HDF5): each is (img,
    mask_miss, mask_all, COCO joints (n, 17, 3), objpos, scale_provided),
    the input of ``data.dataset.MemoryDataset``."""
    out = []
    for img, mask_miss, mask_all, recs in _fixture_images(
            num_images, img_size, people_per_image, image_size, seed,
            drawn, crowd, mask_extras, hard):
        for rec in recs:
            # the JSON round trip of the HDF5 path, so both give the
            # same numbers
            rec = json.loads(strict_dumps(rec))
            out.append((img, mask_miss, mask_all,
                        np.asarray(rec["joints"]), tuple(rec["objpos"][0]),
                        float(rec["scale_provided"][0])))
    return out


RECORDS_SUFFIX = ".npz"
_RECORD_FIELDS = ("img", "mask_miss", "mask_all", "joints", "objpos",
                  "scale")


def save_records(path: str, records) -> int:
    """Write ``records`` (:func:`fixture_records`' tuples) to the ``.npz``
    file ``path``, arrays as they are (no pickle); returns the count."""
    arrays = {}
    for i, rec in enumerate(records):
        for field, value in zip(_RECORD_FIELDS, rec):
            arrays[f"{i}/{field}"] = np.asarray(value)
    np.savez(path, count=np.int64(len(records)), **arrays)
    return len(records)


def load_records(path: str) -> list:
    """The records :func:`save_records` wrote, in order."""
    with np.load(path, allow_pickle=False) as f:
        out = []
        for i in range(int(f["count"])):
            img, mask_miss, mask_all, joints, objpos, scale = (
                f[f"{i}/{field}"] for field in _RECORD_FIELDS)
            out.append((img, mask_miss, mask_all, joints,
                        tuple(float(v) for v in objpos), float(scale)))
    return out


def _write_coco_set(images_dir: str, anno_path: str, num_images: int,
                    img_size: Tuple[int, int], people_per_image: int,
                    image_size: int, seed: int, drawn: bool, crowd: bool,
                    train_side: bool, hard: bool = False) -> int:
    """Shared emitter behind :func:`build_val_set` /
    :func:`build_coco_train_set` — one per-image loop so the visibility
    recode, crowd-bbox extraction and JSON shape cannot drift between the
    two surfaces.  The only policy differences:

    - ``train_side=True`` writes segmentations (cycling polygon →
      uncompressed RLE → compressed RLE so one corpus build exercises
      every ``coco_masks`` decode path) and keeps unannotated people as
      ``iscrowd=0, num_keypoints=0`` — real COCO's shape for people
      lacking keypoint labels, which the corpus rules route into
      mask_miss;
    - ``train_side=False`` (eval side) writes no segmentations and marks
      unannotated people ``iscrowd=1`` so COCOeval / the OKS proxy
      IGNORES detections landing there (real COCO crowds' treatment);
    - crowd-region ``area``: mask pixel count on the train side (real
      COCO derives crowd area from the RLE) vs bbox area on the eval
      side (the OKS proxy's ignore radius works from the bbox).

    Returns the number of annotated (scored) persons.
    """
    import os

    import cv2

    from .coco_masks import rle_encode, rle_to_string

    os.makedirs(images_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = img_size
    images, annotations = [], []
    encodings = ("polygon", "rle", "crle")
    ann_id = 0
    n_scored = 0
    for image_index in range(num_images):
        img_id = 1 + image_index
        img, persons, crowd_masks = _synth_image(
            rng, h, w, people_per_image, image_size, drawn, crowd=crowd,
            hard=hard)
        name = f"{img_id:012d}.jpg"
        cv2.imwrite(os.path.join(images_dir, name), img)
        images.append({"id": img_id, "file_name": name,
                       "width": w, "height": h})
        for p in persons:
            unannotated = p["num_keypoints"] == 0
            kp = []
            for x, y, v in p["joint"]:
                coco_v = 0 if unannotated else {1: 2, 0: 1, 2: 0}[int(v)]
                kp.extend([0.0, 0.0, 0] if unannotated
                          else [float(x), float(y), coco_v])
            ann_id += 1
            n_scored += 0 if unannotated else 1
            ann = {
                "id": ann_id, "image_id": img_id, "category_id": 1,
                "keypoints": kp, "num_keypoints": p["num_keypoints"],
                "area": float(p["segment_area"]),
                "bbox": [float(v) for v in p["bbox"]],
                "iscrowd": (1 if unannotated and not train_side else 0)}
            if train_side:
                ann["segmentation"] = _rect_segmentation(
                    p["bbox"], h, w, encodings[ann_id % len(encodings)])
            annotations.append(ann)
        for cm in crowd_masks:
            ys, xs = np.nonzero(cm)
            x0, y0 = float(xs.min()), float(ys.min())
            bw, bh = float(xs.max() - x0 + 1), float(ys.max() - y0 + 1)
            ann_id += 1
            ann = {
                "id": ann_id, "image_id": img_id, "category_id": 1,
                "keypoints": [0.0, 0.0, 0] * NUM_COCO_PARTS,
                "num_keypoints": 0,
                "area": float(cm.sum()) if train_side else bw * bh,
                "bbox": [x0, y0, bw, bh], "iscrowd": 1}
            if train_side:
                ann["segmentation"] = {
                    "size": [h, w], "counts": rle_to_string(rle_encode(cm))}
            annotations.append(ann)
    with open(anno_path, "w") as f:
        strict_dump({"images": images, "annotations": annotations,
                     "categories": [{"id": 1, "name": "person"}]}, f)
    return n_scored


def build_val_set(images_dir: str, anno_path: str, num_images: int = 16,
                  img_size: Tuple[int, int] = (240, 320),
                  people_per_image: int = 2, image_size: int = 512,
                  seed: int = 1, drawn: bool = True,
                  crowd: bool = False, hard: bool = False) -> int:
    """Held-out val set on disk: jpgs + a COCO-format keypoint JSON, the
    exact inputs of ``tools/evaluate.py`` (reference: evaluate.py:585-622
    reads COCO annotations + an image dir).  Returns the count of
    NON-ignored person annotations.

    Stored visibility (1=visible, 0=occluded, 2=unlabeled) is re-coded
    back to COCO (2 / 1 / 0) for the annotations file.

    ``crowd=True`` renders the same unannotated-people / crowd-box extras
    as the training corpus and annotates their regions ``iscrowd=1`` with
    zero keypoints — COCOeval (and the OKS proxy's ``k1 == 0`` bbox
    fallback) then IGNORES detections landing there instead of counting
    false positives, exactly real COCO's treatment of crowds.
    """
    return _write_coco_set(images_dir, anno_path, num_images, img_size,
                           people_per_image, image_size, seed, drawn, crowd,
                           train_side=False, hard=hard)


def _rect_mask(bbox, h: int, w: int) -> np.ndarray:
    x0, y0, bw, bh = [int(round(v)) for v in bbox]
    m = np.zeros((h, w), np.uint8)
    m[max(y0, 0): y0 + bh, max(x0, 0): x0 + bw] = 1
    return m


def _rect_segmentation(bbox, h: int, w: int, encoding: str):
    """A rectangle in one of the three COCO segmentation encodings.

    RLE variants encode the exact same pixel set as the fixture's HDF5
    person masks; the polygon variant covers the rect with ``cv2.fillPoly``
    inclusive-boundary semantics (see coco_masks.polygons_to_mask).
    """
    from .coco_masks import rle_encode, rle_to_string

    if encoding == "polygon":
        x0, y0, bw, bh = bbox
        return [[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]]
    counts = rle_encode(_rect_mask(bbox, h, w))
    if encoding == "rle":
        return {"size": [h, w], "counts": counts}
    assert encoding == "crle", encoding
    return {"size": [h, w], "counts": rle_to_string(counts)}


def build_coco_train_set(images_dir: str, anno_path: str,
                         num_images: int = 8,
                         img_size: Tuple[int, int] = (240, 320),
                         people_per_image: int = 2, image_size: int = 512,
                         seed: int = 0, drawn: bool = True,
                         crowd: bool = False, hard: bool = False) -> int:
    """Synthetic TRAIN-side COCO dataset on disk: jpgs + a
    person_keypoints JSON **with segmentations** — the exact inputs of
    ``tools/make_corpus.py`` (reference: data/coco_masks_hdf5.py:304-351
    reads COCO annotations + an image dir), enabling the full COCO-format
    journey (JSON+images → HDF5 → train → evaluate) without any COCO
    download or pycocotools.  See :func:`_write_coco_set` for the
    train-side annotation policy.  Returns the number of annotated
    (scored) persons.
    """
    return _write_coco_set(images_dir, anno_path, num_images, img_size,
                           people_per_image, image_size, seed, drawn, crowd,
                           train_side=True, hard=hard)
