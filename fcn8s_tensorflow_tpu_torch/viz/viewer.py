"""Dataset / result browser (headless). Port of
``fcn8s_tensorflow_tpu/viz/viewer.py``.

The capability of the reference's PyQt4 ``cityscapesViewer`` (browse
images with label overlays) for headless training machines: *contact
sheets* (PNG grids) and a static HTML gallery. Each panel shows image / GT
overlay / optional prediction overlay / optional disparity side by side.
The interactive browser viewer is ``viz/serve.py``.

``disparity_to_rgb`` colours through a plasma table held here (the JAX
package builds it with matplotlib, which the card's installation lacks).
"""

from __future__ import annotations

import html
import os
from glob import glob

import numpy as np
from PIL import Image

from ..labels.cityscapes import TRAINIDS_TO_RGBA_DICT
from .overlay import print_segmentation_onto_image


def load_prediction(image_path: str, results_dir: str):
    """Locate + load the predicted id-map PNG matching a source image (by
    Cityscapes core name). Deterministic: candidates sorted, an exact
    ``<core>.png`` preferred over suffixed variants. Returns (H, W) array
    or None. Shared by the static gallery and the interactive viewer."""
    from ..utils.cs_helpers import get_core_image_file_name

    core = get_core_image_file_name(image_path)
    candidates = sorted(glob(os.path.join(results_dir, f"{core}*.png")))
    exact = [c for c in candidates if os.path.basename(c) == f"{core}.png"]
    pick = exact[0] if exact else (candidates[0] if candidates else None)
    return np.asarray(Image.open(pick)) if pick else None


def load_disparity(image_path: str, disparity_root: str | None = None):
    """Locate + load the ``*_disparity.png`` matching a left image, following
    the reference's search convention (``cityscapesViewer.py:1062-1075``:
    same city/sequence/frame core name + ``_disparity.png`` under the
    disparity tree). ``disparity_root`` defaults to replacing the
    ``leftImg8bit`` path component. Returns a (H, W) integer array or None."""
    if disparity_root is None:
        if "leftImg8bit" not in image_path:
            return None
        candidate = image_path.replace("leftImg8bit", "disparity")
    else:
        from ..utils.cs_helpers import get_core_image_file_name

        core = get_core_image_file_name(image_path)
        hits = sorted(glob(os.path.join(disparity_root, "**", f"{core}_disparity.png"),
                           recursive=True))
        candidate = hits[0] if hits else ""
    if not candidate or not os.path.isfile(candidate):
        return None
    return np.asarray(Image.open(candidate))


# matplotlib's plasma colormap through ``Normalize(vmin=3, vmax=100)``:
# ``(ScalarMappable(norm, cm.plasma).to_rgba(i)[:3] * 255).astype(uint8)``
# for i in 3..100, the 98 colours it takes; below 3 the colormap's first
# colour, above 100 its last, so PLASMA_LUT[i] is exactly the JAX package's
# table for every uint8 i (tests/test_torch_viewer.py holds it on all 65,536
# uint16 disparities).
_PLASMA_3_TO_100 = np.frombuffer(bytes.fromhex(
    "0c07861306891b068c1f058e2505912b05942f04953404983a049a3d039b42039d47029f4a02a04f02a2"
    "5201a35701a45c00a55f00a66400a76800a76c00a87000a87500a87801a87c02a77f03a78405a68807a5"
    "8b09a48f0da39310a19612a09a159e9e199ca01b9ba41e98a82296aa2494ae2791b02a8fb42d8db7308a"
    "b93388bc3685bf3982c13c80c43f7ec7427bc94579cc4876ce4a75d14e72d3516fd5536dd7576bda5a68"
    "dc5d66de6064e06461e26660e46a5de56c5be87059ea7356eb7654ed7952ef7d4ff0804df2844bf38748"
    "f48a47f68e44f79241f89540f9993dfa9c3bfaa039fba436fca735fcac32fdb030fdb32efdb82cfdbc2a"
    "fdc029fdc427fcc726fccc25fbd124fad524f9d924f8df24f7e225f5e726f3ec26f2f026f0f525eff821"
), np.uint8).reshape(98, 3)
PLASMA_LUT = _PLASMA_3_TO_100[np.clip(np.arange(256), 3, 100) - 3]  # (256, 3) uint8


def disparity_to_rgb(disp, *, colormapped: bool = True) -> np.ndarray:
    """Render a raw Cityscapes disparity map (16-bit PNG values) as an RGB
    visualization with the reference viewer's exact semantics
    (``cityscapesViewer.py:555-569``): values floor-divided by 128 to uint8
    (the reference's py2 in-place ``/=`` on an int array; its unassigned
    ``.round()`` is a no-op), then mapped through matplotlib's *plasma*
    colormap normalized to [3, 100] (``:144-146``; ``PLASMA_LUT``). Values
    above 255 after the division are clipped rather than wrapped (divergence
    from the reference's silent uint8 overflow). ``colormapped=False``
    returns the grayscale uint8 map replicated to RGB."""
    d8 = np.clip(np.asarray(disp, np.int64) // 128, 0, 255).astype(np.uint8)
    if not colormapped:
        return np.repeat(d8[..., None], 3, axis=-1)
    return PLASMA_LUT[d8]


def render_panel(image, gt_ids=None, pred_ids=None, color_map=None,
                 disparity=None) -> np.ndarray:
    """One horizontal panel: [image | GT overlay | prediction overlay |
    disparity]."""
    color_map = color_map or TRAINIDS_TO_RGBA_DICT
    image = np.asarray(image)
    parts = [image]
    if gt_ids is not None:
        parts.append(print_segmentation_onto_image(image, np.asarray(gt_ids), color_map))
    if pred_ids is not None:
        parts.append(print_segmentation_onto_image(image, np.asarray(pred_ids), color_map))
    if disparity is not None:
        parts.append(disparity_to_rgb(disparity))
    return np.concatenate(parts, axis=1)


def contact_sheet(panels: list[np.ndarray], columns: int = 1, pad: int = 4) -> np.ndarray:
    """Stack panels into a grid with black padding."""
    if not panels:
        raise ValueError("no panels")
    h = max(p.shape[0] for p in panels)
    w = max(p.shape[1] for p in panels)
    rows = -(-len(panels) // columns)
    canvas = np.zeros((rows * (h + pad) - pad, columns * (w + pad) - pad, 3), np.uint8)
    for i, panel in enumerate(panels):
        r, c = divmod(i, columns)
        y, x = r * (h + pad), c * (w + pad)
        canvas[y : y + panel.shape[0], x : x + panel.shape[1]] = panel
    return canvas


def build_gallery(
    out_dir: str,
    image_paths: list[str],
    gt_loader=None,
    pred_loader=None,
    color_map=None,
    *,
    disp_loader=None,
    max_images: int | None = None,
    resize_to=None,
    title: str = "fcn8s_tensorflow_tpu viewer",
) -> str:
    """Render per-image panels + an ``index.html`` gallery into ``out_dir``.

    ``gt_loader`` / ``pred_loader``: optional callables
    ``image_path -> (H, W) id map or None``. ``disp_loader``:
    ``image_path -> raw disparity map or None`` (adds a plasma-colormapped
    depth column, the reference viewer's disparity visualization).
    Returns the index.html path.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = image_paths[:max_images] if max_images else image_paths
    entries = []
    for path in paths:
        image = np.asarray(Image.open(path).convert("RGB"))
        if resize_to is not None:
            image = np.asarray(
                Image.fromarray(image).resize((resize_to[1], resize_to[0]), Image.BILINEAR)
            )
        gt = gt_loader(path) if gt_loader else None
        pred = pred_loader(path) if pred_loader else None
        disp = disp_loader(path) if disp_loader else None
        if disp is not None and resize_to is not None:
            disp = np.asarray(Image.fromarray(np.asarray(disp)).resize(
                (resize_to[1], resize_to[0]), Image.NEAREST))
        panel = render_panel(image, gt, pred, color_map, disparity=disp)
        name = os.path.splitext(os.path.basename(path))[0] + "_panel.png"
        Image.fromarray(panel).save(os.path.join(out_dir, name))
        entries.append((os.path.basename(path), name))

    cols = ("image | GT overlay" + (" | prediction" if pred_loader else "")
            + (" | disparity" if disp_loader else ""))
    rows = "\n".join(
        f'<figure><img src="{html.escape(panel)}" loading="lazy">'
        f"<figcaption>{html.escape(src)}</figcaption></figure>"
        for src, panel in entries
    )
    index = os.path.join(out_dir, "index.html")
    with open(index, "w") as f:
        f.write(
            f"<!doctype html><meta charset='utf-8'><title>{html.escape(title)}</title>"
            "<style>body{background:#111;color:#eee;font:14px sans-serif;margin:2em}"
            "img{max-width:100%;display:block;margin:.5em 0}figure{margin:0 0 2em}</style>"
            f"<h1>{html.escape(title)}</h1><p>panels: {html.escape(cols)}</p>{rows}"
        )
    return index


def view_cityscapes_split(
    cityscapes_root: str,
    split: str = "val",
    out_dir: str = "viewer_out",
    results_dir: str | None = None,
    *,
    max_images: int = 20,
    gt_type: str = "gtFine",
) -> str:
    """Browse a Cityscapes split: left images + labelTrainIds overlays
    (+ predictions from ``results_dir`` if given). Returns index.html."""
    image_paths = sorted(
        glob(os.path.join(cityscapes_root, "leftImg8bit", split, "*", "*_leftImg8bit.png"))
    )
    if not image_paths:
        raise ValueError(f"no images under {cityscapes_root}/leftImg8bit/{split}")

    def gt_loader(path):
        base = path.replace("leftImg8bit", gt_type, 1).replace("_leftImg8bit.png", "")
        train_ids_path = f"{base}_{gt_type}_labelTrainIds.png"
        if os.path.isfile(train_ids_path):
            return np.asarray(Image.open(train_ids_path))
        label_ids_path = f"{base}_{gt_type}_labelIds.png"
        if os.path.isfile(label_ids_path):
            from ..labels.cityscapes import IDS_TO_TRAINIDS_ARRAY

            return IDS_TO_TRAINIDS_ARRAY[np.asarray(Image.open(label_ids_path))]
        return None

    pred_loader = None
    if results_dir:
        def pred_loader(path):
            return load_prediction(path, results_dir)

    # disparity maps ride along when the dataset ships them (the reference
    # viewer's optional depth channel)
    disp_loader = None
    if os.path.isdir(os.path.join(cityscapes_root, "disparity", split)):
        disp_loader = load_disparity

    return build_gallery(
        out_dir, image_paths, gt_loader, pred_loader, disp_loader=disp_loader,
        max_images=max_images, title=f"Cityscapes {split}",
    )
