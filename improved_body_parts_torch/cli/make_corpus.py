"""COCO -> HDF5 training corpus (counterpart of ``tools/make_corpus.py``;
reference: data/coco_masks_hdf5.py ``__main__``)::

    python -m improved_body_parts_torch.cli.make_corpus \\
        --anno annotations/person_keypoints_train2017.json \\
        --images train2017 --out-train coco_train_dataset512.h5 \\
        --out-val coco_val_dataset512.h5 --image-size 512

Runs on the host (h5py, cv2, numpy); no device is involved.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="build the training corpus")
    ap.add_argument("--anno", required=True)
    ap.add_argument("--images", required=True)
    ap.add_argument("--out-train", required=True)
    ap.add_argument("--out-val", required=True)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--val-size", type=int, default=100)
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)

    from ..data.hdf5_corpus import build_coco_corpus

    t0 = time.time()
    tr, va = build_coco_corpus(args.anno, args.images, args.out_train,
                               args.out_val, image_size=args.image_size,
                               val_size=args.val_size, limit=args.limit)
    print(f"train records: {tr}, val records: {va} "
          f"({(time.time() - t0) / 60:.1f} min)")
    return tr, va


if __name__ == "__main__":
    main()
