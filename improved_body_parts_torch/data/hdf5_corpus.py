"""The HDF5 training corpus (counterpart of
``improved_body_parts_tpu/data/hdf5_corpus.py``): its schema and the
COCO -> HDF5 builder (``load_coco_annotations``, ``build_coco_corpus``;
the command line is ``cli.make_corpus``).  The builder runs on the host
and needs h5py.

Schema (reference: data/coco_masks_hdf5.py):

- group ``images``: one BGR uint8 image per COCO image id (key ``%012d``)
- group ``masks``:  (H, W, 2) uint8 per image -- channel 0 ``mask_miss``
  (0 = area with people lacking keypoint annotation, excluded from the
  loss), channel 1 ``mask_all`` (255 = any-person area)
- group ``dataset``: one record per *main person* (key ``%07d``), JSON with
  ``image`` key, ``joints``/``objpos``/``scale_provided`` lists (main person
  first, then all other annotated people), full metadata mirrored in the
  ``meta`` attribute

Main-person selection (coco_masks_hdf5.py:165-207): >=5 keypoints, segment
area >= 32^2, and center at least 0.3x(bbox max side) away from every
previously selected main person.  Visibility recode
(coco_masks_hdf5.py:147-158): COCO v=2 (visible) -> 1, v=1 (labeled,
occluded) -> 0, v=0 (unlabeled) -> 2.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def strict_dumps(obj) -> str:
    """``json.dumps`` that refuses NaN and infinities (a bare ``NaN`` token
    in a stored record would surface as a parse error at training time)."""
    return json.dumps(obj, allow_nan=False)


MIN_KEYPOINTS = 5
MIN_AREA = 32 * 32
MAIN_PERSON_MIN_DIST_RATIO = 0.3
NUM_COCO_PARTS = 17


def recode_visibility(v: int) -> int:
    if v == 2:
        return 1  # marked and visible
    if v == 1:
        return 0  # marked but occluded
    return 2      # not labeled for this person


def person_record(ann: Dict, image_size: int) -> Dict:
    """Extract one person's fields (coco_masks_hdf5.py:128-163)."""
    x, y, w, h = ann["bbox"]
    joints = np.zeros((NUM_COCO_PARTS, 3), dtype=np.float64)
    kp = ann["keypoints"]
    for part in range(NUM_COCO_PARTS):
        joints[part, 0] = kp[part * 3]
        joints[part, 1] = kp[part * 3 + 1]
        joints[part, 2] = recode_visibility(kp[part * 3 + 2])
    return {
        "objpos": [x + w / 2, y + h / 2],
        "bbox": list(ann["bbox"]),
        "segment_area": ann["area"],
        "num_keypoints": ann["num_keypoints"],
        "joint": joints,
        # main-person height normalized by the training image size
        "scale_provided": h / image_size,
    }


def select_main_persons(persons: Sequence[Dict]) -> List[int]:
    """Indices of the main persons (coco_masks_hdf5.py:165-207)."""
    mains: List[int] = []
    prev: List[Tuple[float, float, float]] = []  # (cx, cy, max_side)
    for i, pers in enumerate(persons):
        if pers["num_keypoints"] < MIN_KEYPOINTS or \
                pers["segment_area"] < MIN_AREA:
            continue
        cx, cy = pers["objpos"]
        too_close = any(
            np.hypot(cx - px, cy - py) < side * MAIN_PERSON_MIN_DIST_RATIO
            for px, py, side in prev)
        if too_close:
            continue
        mains.append(i)
        prev.append((cx, cy, max(pers["bbox"][2], pers["bbox"][3])))
    return mains


def build_masks(shape: Tuple[int, int], person_masks: Sequence[np.ndarray],
                num_keypoints: Sequence[int],
                crowd_masks: Sequence[np.ndarray] = ()
                ) -> Tuple[np.ndarray, np.ndarray]:
    """mask_miss / mask_all as uint8 {0, 255} (coco_masks_hdf5.py:38-103).

    :param person_masks: binary {0,1} masks of non-crowd people
    :param num_keypoints: per person, aligned with person_masks
    :param crowd_masks: binary masks of crowd regions (RLE-decoded)
    """
    h, w = shape
    mask_all = np.zeros((h, w), dtype=np.uint8)
    unannotated = np.zeros((h, w), dtype=np.uint8)
    for m, nk in zip(person_masks, num_keypoints):
        mask_all |= m
        if nk <= 0:
            unannotated |= m
    for cm in crowd_masks:
        cm = cm - (mask_all & cm)  # subtract overlap with known people
        unannotated |= cm
        mask_all |= cm
    mask_miss = np.logical_not(unannotated).astype(np.uint8) * 255
    return mask_miss, mask_all * 255


def iter_records(image_rec: Dict, img_id: int, image_index: int,
                 persons: Sequence[Dict], dataset_type: str,
                 is_validation: bool) -> Iterator[Dict]:
    """One record per main person; each record centers the image on that
    person and appends every other annotated person
    (coco_masks_hdf5.py:209-257)."""
    mains = select_main_persons(persons)
    base = {
        "dataset": dataset_type,
        "isValidation": 1 if is_validation else 0,
        "img_width": image_rec["width"],
        "img_height": image_rec["height"],
        "image_id": img_id,
        "annolist_index": image_index,
        "img_path": image_rec.get("file_name", "%012d.jpg" % img_id),
    }
    for mi in mains:
        main = persons[mi]
        rec = dict(base)
        rec["objpos"] = [main["objpos"]]
        rec["joints"] = [main["joint"].tolist()]
        rec["scale_provided"] = [main["scale_provided"]]
        rec["people_index"] = mi
        others = 0
        for oi, other in enumerate(persons):
            if oi == mi or other["num_keypoints"] == 0:
                continue
            rec["joints"].append(other["joint"].tolist())
            rec["scale_provided"].append(other["scale_provided"])
            rec["objpos"].append(other["objpos"])
            others += 1
        rec["numOtherPeople"] = others
        yield rec


def write_record(dataset_grp, images_grp, masks_grp, record: Dict, count: int,
                 img: np.ndarray, mask_miss: np.ndarray,
                 mask_all: np.ndarray) -> None:
    """HDF5 writing (schema of coco_masks_hdf5.py:260-299)."""
    record = dict(record)
    record["count"] = count
    img_key = "%012d" % record["image_id"]
    if img_key not in images_grp:
        images_grp.create_dataset(img_key, data=img)
        masks_grp.create_dataset(
            img_key,
            data=np.stack([mask_miss, mask_all], axis=-1))
    required = {
        "image": img_key,
        "joints": record["joints"],
        "objpos": record["objpos"],
        "scale_provided": record["scale_provided"],
    }
    # strict emission (graftlint JGL004): COCO floats are finite today,
    # but a bare-NaN token in a stored record would surface as a parse
    # error at TRAINING time, arbitrarily far from the corpus build
    ds = dataset_grp.create_dataset("%07d" % count,
                                    data=strict_dumps(required))
    ds.attrs["meta"] = strict_dumps(record)


def load_coco_annotations(anno_path: str) -> Tuple[Dict, Dict]:
    """Stdlib parse of a person_keypoints_*.json: (image_id -> image
    record, image_id -> its person annotations), both in file order (in
    place of pycocotools' index, coco_masks_hdf5.py:306-309)."""
    with open(anno_path) as f:
        data = json.load(f)
    person_ids = {c["id"] for c in data.get("categories", [])
                  if c.get("name") == "person"} or {1}
    imgs = {im["id"]: im for im in data["images"]}
    anns: Dict[int, List[Dict]] = {i: [] for i in imgs}
    for ann in data.get("annotations", []):
        if ann.get("category_id", 1) in person_ids:
            anns.setdefault(ann["image_id"], []).append(ann)
    return imgs, anns


def build_coco_corpus(anno_path: str, img_dir: str, out_train: str,
                      out_val: str, image_size: int = 512,
                      val_size: int = 100,
                      limit: Optional[int] = None) -> Tuple[int, int]:
    """COCO annotations + images -> the train and val HDF5 corpora
    (coco_masks_hdf5.py:304-351): the first ``val_size`` images go to the
    val corpus.  Masks are decoded by ``data.coco_masks`` (polygons,
    uncompressed and compressed RLE), so no pycocotools is needed.
    Returns (train_count, val_count)."""
    import cv2
    import h5py

    from .coco_masks import ann_to_mask

    imgs, anns_by_img = load_coco_annotations(anno_path)
    ids = list(imgs.keys())
    if limit is not None:
        ids = ids[:limit]
    tr = h5py.File(out_train, "w")
    va = h5py.File(out_val, "w")
    grps = {f: (f.create_group("dataset"), f.create_group("images"),
                f.create_group("masks")) for f in (tr, va)}
    counts = {tr: 0, va: 0}
    try:
        for image_index, img_id in enumerate(ids):
            anns = anns_by_img.get(img_id, [])
            image_rec = imgs[img_id]
            persons = [person_record(a, image_size) for a in anns
                       if a["iscrowd"] == 0]
            is_val = image_index < val_size
            records = list(iter_records(image_rec, img_id, image_index,
                                        persons, "COCO", is_val))
            if not records:
                continue
            fname = image_rec.get("file_name", "%012d.jpg" % img_id)
            img = cv2.imread(os.path.join(img_dir, fname))
            if img is None:
                raise IOError(f"missing image {fname} in {img_dir}")
            h, w = img.shape[:2]
            person_masks = [ann_to_mask(a, h, w) for a in anns
                            if a["iscrowd"] == 0]
            crowd_masks = [ann_to_mask(a, h, w) for a in anns
                           if a["iscrowd"] == 1]
            nks = [a["num_keypoints"] for a in anns if a["iscrowd"] == 0]
            mask_miss, mask_all = build_masks(img.shape[:2], person_masks,
                                              nks, crowd_masks)
            target = va if is_val else tr
            for rec in records:
                write_record(*grps[target], rec, counts[target], img,
                             mask_miss, mask_all)
                counts[target] += 1
    finally:
        tr.close()
        va.close()
    return counts[tr], counts[va]
