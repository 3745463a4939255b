"""Network introspection and heatmap colorization (counterpart of
``improved_body_parts_tpu/utils/visualize.py``).

- :func:`param_table` and :func:`module_dot` walk a module's
  ``named_parameters()``: a parameter listing with totals, and a Graphviz
  DOT view of the module tree with each subtree's parameter count (the
  reference's ``make_dot``, visulizatoin/draw_net.py:6-56, draws the
  autograd graph instead);
- :func:`colorize_jet`, :func:`train_batch_overlay` and
  :func:`save_batch_overlays`: the jet colormap and the train-batch
  debug overlays of the reference (utils/util.py:12-41, train.py:188-200),
  written headlessly with cv2.

The JAX package's ``export_stablehlo`` and ``export_serialized`` (the
compiled forward as StableHLO text or a ``jax.export`` artifact) have no
counterpart here: the port's forward is eager PyTorch, not one compiled
program.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def param_table(model, max_rows: Optional[int] = None) -> str:
    """Human-readable parameter listing of ``model`` with the total."""
    rows = []
    total = 0
    named = list(model.named_parameters())
    for name, p in named:
        n = int(p.numel())
        total += n
        rows.append(f"{name:<80s} {str(tuple(p.shape)):>20s} {n:>12,d}")
    if max_rows is not None:
        rows = rows[:max_rows] + [f"... ({len(named) - max_rows} more)"]
    rows.append(f"{'TOTAL':<80s} {'':>20s} {total:>12,d}")
    return "\n".join(rows)


def module_dot(model, max_depth: Optional[int] = None) -> str:
    """Graphviz DOT of ``model``'s module tree, each node labelled with
    its subtree's parameter count.  Render with ``dot -Tpng``."""
    counts: dict = {}
    for name, p in model.named_parameters():
        keys = name.split(".")
        n = int(p.numel())
        for d in range(1, len(keys) + 1):
            prefix = "/".join(keys[:d])
            counts[prefix] = counts.get(prefix, 0) + n

    def node_id(prefix: str) -> str:
        # a quoted ID: any module name is legal, distinct prefixes never
        # merge
        escaped = prefix.replace("\\", "\\\\").replace('"', '\\"')
        return f'"n/{escaped}"'

    total = sum(v for k, v in counts.items() if "/" not in k)
    lines = ["digraph model {", "  rankdir=LR;",
             "  node [shape=box, fontsize=10];",
             f'  root [label="params\\n{total:,}"];']
    for prefix in sorted(counts):
        depth = prefix.count("/") + 1
        if max_depth is not None and depth > max_depth:
            continue
        label = prefix.rsplit("/", 1)[-1]
        lines.append(
            f'  {node_id(prefix)} [label="{label}\\n{counts[prefix]:,}"];')
        parent = ("root" if "/" not in prefix
                  else node_id(prefix.rsplit("/", 1)[0]))
        lines.append(f"  {parent} -> {node_id(prefix)};")
    lines.append("}")
    return "\n".join(lines)


def train_batch_overlay(image: np.ndarray, maps: np.ndarray,
                        channel: int, alpha: float = 0.5) -> np.ndarray:
    """One train sample's debug overlay: the image resized to the label
    grid with a jet-colorized map channel alpha-blended on top, as BGR
    uint8.

    :param image: (H, W, 3) float [0, 1] or uint8, BGR (pipeline order)
    :param maps: (h, w, C) labels or predictions at stride resolution
    :param channel: the map channel to overlay (``bkg_start`` for the
        person mask, ``heat_start + k`` for a keypoint)
    """
    import cv2

    h, w = maps.shape[:2]
    img = image.astype(np.float32)
    if img.max() > 1.5:  # uint8 range
        img = img / 255.0
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    heat = colorize_jet(np.asarray(maps[..., channel], np.float32)) / 255.0
    out = (1 - alpha) * np.clip(img, 0, 1) + alpha * heat
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def save_batch_overlays(path: str, images: np.ndarray, maps: np.ndarray,
                        channels, alpha: float = 0.5) -> str:
    """Tile the first batch element's overlays over ``channels`` side by
    side and write a PNG; returns the path."""
    import cv2

    tiles = [train_batch_overlay(images[0], maps[0], c, alpha)
             for c in channels]
    cv2.imwrite(path, np.concatenate(tiles, axis=1))
    return path


def colorize_jet(gray: np.ndarray) -> np.ndarray:
    """Jet colormap of values in [0, 1] → float BGR in [0, 255]
    (reference: utils/util.py:12-41, vectorized)."""
    v = np.clip(gray, 0.0, 1.0)
    out = np.zeros((*v.shape, 3))
    b, g, r = out[..., 0], out[..., 1], out[..., 2]
    seg0 = v < 0.125
    seg1 = (v >= 0.125) & (v < 0.375)
    seg2 = (v >= 0.375) & (v < 0.625)
    seg3 = (v >= 0.625) & (v < 0.875)
    seg4 = v >= 0.875
    b[seg0] = 256 * (0.5 + v[seg0] * 4)
    b[seg1] = 255
    g[seg1] = 256 * (v[seg1] - 0.125) * 4
    b[seg2] = 256 * (-4 * v[seg2] + 2.5)
    g[seg2] = 255
    r[seg2] = 256 * (4 * (v[seg2] - 0.375))
    g[seg3] = 256 * (-4 * v[seg3] + 3.5)
    r[seg3] = 255
    r[seg4] = 256 * (-4 * v[seg4] + 4.5)
    return np.clip(out, 0, 255)
