"""Bounding-box / attention visualizers (C24; the port's own copy of
``graphvqa_tpu/eval/visualize.py``).

Matplotlib equivalents of the reference's viewers (Constants.py:122-152)
with two fixes: image locations are explicit arguments instead of a
hard-coded home directory, and figures can be saved headlessly (``save_path``)
instead of only ``plt.show()``. Also adds ``show_attention`` — renders the
model's per-object pooling gate (the grounding attention the official scorer
consumes) as box opacities.

Matplotlib/PIL are imported lazily so the core package never depends on them.
A figure that is saved is drawn off screen on a bare ``Figure`` (matplotlib's
Agg canvas), without pyplot or a display; one without ``save_path`` is shown
with pyplot.
"""
from __future__ import annotations

import pathlib
from typing import Optional, Sequence


def _load_image(image):
    """Accept a path or an array-like; return an ndarray."""
    import numpy as np
    if hasattr(image, "shape"):
        return np.asarray(image)
    from PIL import Image
    return np.asarray(Image.open(pathlib.Path(image)))


def _axes(save_path):
    """(figure, axes): a bare Agg-drawn Figure to save, else pyplot's."""
    if save_path is not None:
        from matplotlib.figure import Figure
        fig = Figure()
        return fig, fig.subplots(1)
    import matplotlib.pyplot as plt
    return plt.subplots(1)


def _finish(fig, save_path):
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
        return None
    import matplotlib.pyplot as plt
    plt.show()
    return fig


def show_box(image, x, y, w, h, title: str = "",
             save_path: Optional[str] = None):
    """One box in pixel xywh coordinates (reference show_im,
    Constants.py:122-135)."""
    from matplotlib import patches

    im = _load_image(image)
    fig, ax = _axes(save_path)
    ax.imshow(im)
    ax.add_patch(patches.Rectangle((x, y), w, h, linewidth=1,
                                   edgecolor="r", facecolor="none"))
    ax.set_title(title)
    return _finish(fig, save_path)


def show_boxes(image, coordinates: Sequence[Sequence[float]],
               title: str = "", save_path: Optional[str] = None):
    """Many boxes in normalized x1y1x2y2 (reference show_im_bboxes,
    Constants.py:138-152); colors cycle deterministically."""
    from matplotlib import patches

    im = _load_image(image)
    height, width = im.shape[0], im.shape[1]
    fig, ax = _axes(save_path)
    ax.imshow(im)
    colors = ["red", "yellow", "black", "blue", "orange", "grey", "cyan",
              "green", "purple"]
    for i, c in enumerate(coordinates):
        x, y = c[0] * width, c[1] * height
        w, h = (c[2] - c[0]) * width, (c[3] - c[1]) * height
        ax.add_patch(patches.Rectangle(
            (x, y), w, h, linewidth=1,
            edgecolor=colors[i % len(colors)], facecolor="none"))
    ax.set_title(title)
    return _finish(fig, save_path)


def show_attention(image, attention_rows: Sequence[Sequence[float]],
                   title: str = "", save_path: Optional[str] = None):
    """Render dump_attentions rows [x0, y0, x1, y1, att] (normalized) with
    box opacity/width proportional to attention — a visual check of the
    grounding metric's input (eval/scorer.py, reference eval.py:316-338)."""
    from matplotlib import patches

    im = _load_image(image)
    height, width = im.shape[0], im.shape[1]
    fig, ax = _axes(save_path)
    ax.imshow(im)
    peak = max((r[4] for r in attention_rows), default=1.0) or 1.0
    for x0, y0, x1, y1, att in attention_rows:
        rel = att / peak
        ax.add_patch(patches.Rectangle(
            (x0 * width, y0 * height),
            (x1 - x0) * width, (y1 - y0) * height,
            linewidth=0.5 + 2.5 * rel, edgecolor=(1.0, 0.2, 0.1, 0.25 + 0.75 * rel),
            facecolor="none"))
        ax.text(x0 * width, y0 * height, f"{att:.2f}", fontsize=6,
                color="red")
    ax.set_title(title)
    return _finish(fig, save_path)
