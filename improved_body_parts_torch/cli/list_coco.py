"""List the COCO categories and supercategories of an annotation file
(counterpart of ``tools/list_coco.py``; reference:
data/dataset/see_coco_data.py)::

    python -m improved_body_parts_torch.cli.list_coco \\
        --anno annotations/instances_val2017.json

Prints what the JAX tool prints through pycocotools (the category names
in the file's order, then the sorted supercategories), reading the JSON with
``json``: pycocotools is not needed.  A host-side reader of one file:
it touches no device and takes no ``--device``.
"""
from __future__ import annotations

import argparse
import json


def categories(anno: str):
    """(names in the file's order, sorted supercategories) of the
    instances file ``anno``."""
    with open(anno) as f:
        # the file's order, as pycocotools' getCatIds() lists them
        cats = json.load(f).get("categories", [])
    return ([c["name"] for c in cats],
            sorted({c["supercategory"] for c in cats}))


def main(argv=None):
    ap = argparse.ArgumentParser(description="COCO category lister")
    ap.add_argument("--anno", required=True, help="instances_*.json path")
    args = ap.parse_args(argv)
    names, supers = categories(args.anno)
    print("COCO categories:\n" + " ".join(names) + "\n")
    print("COCO supercategories:\n" + " ".join(supers))
    return names, supers


if __name__ == "__main__":
    main()
