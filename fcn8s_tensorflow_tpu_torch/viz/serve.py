"""Interactive browser-based dataset/result viewer. Port of
``fcn8s_tensorflow_tpu/viz/serve.py``; the page is the JAX package's, byte
for byte.

The reference ships a PyQt4 desktop GUI (``cityscapesViewer.py``) with
image browsing, overlay toggling and zoom. Training machines are headless,
so this keeps the *interactivity* but moves it to the browser:
``build_interactive_viewer`` renders per-image layers (raw / GT overlay /
prediction overlay / disparity) plus a single self-contained
``viewer.html`` (vanilla JS, no dependencies, works over SSH port
forwarding), and ``serve_viewer`` hosts it with the stdlib HTTP server.

Feature parity with the PyQt viewer's core loop:
* next/previous image        -> arrow keys or on-screen buttons
* toggle label overlay       -> 'g' (GT), 'p' (prediction)
* toggle disparity overlay   -> 'd' (the Qt viewer's shortcut,
                                cityscapesViewer.py:225), 'm' switches
                                plasma-colormapped <-> grayscale rendering
* overlay transparency       -> slider (the Qt tool's alpha slider)
* zoom                       -> mouse wheel / trackpad, drag to pan
* image name + progress      -> header bar
* slideshow / play-through   -> play button or space (1/2/5 s interval)
* PNG screenshot export      -> 's' or the screenshot button: downloads the
                                CURRENT composited view (visible layers at
                                the chosen alpha) as <name>_screenshot.png

The static gallery (``viz/viewer.py``) remains for contact-sheet workflows.
"""

from __future__ import annotations

import html
import json
import os

import numpy as np
from PIL import Image

from ..labels.cityscapes import TRAINIDS_TO_RGBA_DICT
from .overlay import print_segmentation_onto_image

_VIEWER_HTML = """<!doctype html>
<meta charset="utf-8">
<title>{title}</title>
<style>
  body {{ background:#111; color:#eee; font:14px sans-serif; margin:0; }}
  #bar {{ padding:.6em 1em; background:#1c1c1c; display:flex; gap:1em;
         align-items:center; position:sticky; top:0; }}
  #stage {{ overflow:hidden; position:relative; height:calc(100vh - 3.2em); }}
  #stack {{ position:absolute; transform-origin:0 0; }}
  #stack img {{ position:absolute; left:0; top:0; image-rendering:pixelated; }}
  button {{ background:#333; color:#eee; border:1px solid #555; padding:.2em .8em; }}
  .on {{ background:#2a6; }}
  kbd {{ background:#333; border-radius:3px; padding:0 .35em; }}
</style>
<div id="bar">
  <button id="prev">&larr;</button>
  <span id="name"></span>
  <button id="next">&rarr;</button>
  <button id="gt">GT (g)</button>
  <button id="pred">pred (p)</button>
  <button id="disp">disp (d)</button>
  <button id="dmode">gray (m)</button>
  <label>alpha <input id="alpha" type="range" min="0" max="100" value="100"></label>
  <button id="play" title="slideshow">&#9654; play (space)</button>
  <select id="pint"><option value="1">1s</option><option value="2" selected>2s</option>
    <option value="5">5s</option></select>
  <button id="shot">screenshot (s)</button>
  <span style="opacity:.6">wheel: zoom &middot; drag: pan &middot; <kbd>&larr;</kbd><kbd>&rarr;</kbd> navigate</span>
</div>
<div id="stage"><div id="stack">
  <img id="L_img"><img id="L_gt"><img id="L_pred"><img id="L_disp">
</div></div>
<script>
const ENTRIES = {entries_json};
let i = 0, showGt = true, showPred = true, showDisp = false, dispGray = false,
    scale = 1, ox = 0, oy = 0;
const $ = id => document.getElementById(id);
function render() {{
  const e = ENTRIES[i];
  $('name').textContent = `${{e.name}}  (${{i + 1}}/${{ENTRIES.length}})`;
  $('L_img').src = e.img;
  $('L_gt').src = e.gt || ''; $('L_gt').style.display = (e.gt && showGt) ? '' : 'none';
  $('L_pred').src = e.pred || ''; $('L_pred').style.display = (e.pred && showPred) ? '' : 'none';
  const dsrc = dispGray ? e.disp_gray : e.disp;
  $('L_disp').src = dsrc || '';
  $('L_disp').style.display = (dsrc && showDisp) ? '' : 'none';
  $('gt').className = showGt ? 'on' : ''; $('pred').className = showPred ? 'on' : '';
  $('disp').className = showDisp ? 'on' : ''; $('dmode').className = dispGray ? 'on' : '';
  const hasDisp = ENTRIES.some(x => x.disp);
  $('disp').style.display = hasDisp ? '' : 'none';
  $('dmode').style.display = hasDisp ? '' : 'none';
  const a = $('alpha').value / 100;
  $('L_gt').style.opacity = a; $('L_pred').style.opacity = a; $('L_disp').style.opacity = a;
  $('stack').style.transform = `translate(${{ox}}px,${{oy}}px) scale(${{scale}})`;
}}
$('prev').onclick = () => {{ i = (i - 1 + ENTRIES.length) % ENTRIES.length; render(); }};
$('next').onclick = () => {{ i = (i + 1) % ENTRIES.length; render(); }};
$('gt').onclick = () => {{ showGt = !showGt; render(); }};
$('pred').onclick = () => {{ showPred = !showPred; render(); }};
$('disp').onclick = () => {{ showDisp = !showDisp; render(); }};
$('dmode').onclick = () => {{ dispGray = !dispGray; render(); }};
$('alpha').oninput = render;
// slideshow / play-through (the Qt viewer's play loop) + PNG screenshot
// export of the CURRENT composited view (layers, toggles, alpha)
let playing = null;
function togglePlay() {{
  if (playing) {{ clearInterval(playing); playing = null; }}
  else playing = setInterval($('next').onclick, +$('pint').value * 1000);
  $('play').className = playing ? 'on' : '';
}}
$('play').onclick = togglePlay;
$('pint').onchange = () => {{ if (playing) {{ togglePlay(); togglePlay(); }} }};
function screenshot() {{
  const base = $('L_img');
  const c = document.createElement('canvas');
  c.width = base.naturalWidth; c.height = base.naturalHeight;
  const g = c.getContext('2d'); g.drawImage(base, 0, 0);
  g.globalAlpha = $('alpha').value / 100;
  for (const id of ['L_gt', 'L_pred', 'L_disp']) {{
    const el = $(id);
    if (el.getAttribute('src') && el.style.display !== 'none') g.drawImage(el, 0, 0);
  }}
  const a = document.createElement('a');
  a.download = ENTRIES[i].name.replace(/\\.[^.]*$/, '') + '_screenshot.png';
  a.href = c.toDataURL('image/png'); a.click();
}}
$('shot').onclick = screenshot;
document.onkeydown = ev => {{
  if (ev.key === 'ArrowLeft') $('prev').onclick();
  else if (ev.key === 'ArrowRight') $('next').onclick();
  else if (ev.key === 'g') $('gt').onclick();
  else if (ev.key === 'p') $('pred').onclick();
  else if (ev.key === 'd') $('disp').onclick();
  else if (ev.key === 'm') $('dmode').onclick();
  else if (ev.key === ' ') {{ ev.preventDefault(); togglePlay(); }}
  else if (ev.key === 's') screenshot();
}};
$('stage').onwheel = ev => {{
  ev.preventDefault();
  const f = ev.deltaY < 0 ? 1.15 : 1 / 1.15;
  ox = ev.clientX - (ev.clientX - ox) * f; oy = ev.clientY - (ev.clientY - oy) * f;
  scale *= f; render();
}};
let drag = null;
$('stage').onmousedown = ev => drag = [ev.clientX - ox, ev.clientY - oy];
window.onmousemove = ev => {{ if (drag) {{ ox = ev.clientX - drag[0]; oy = ev.clientY - drag[1]; render(); }} }};
window.onmouseup = () => drag = null;
render();
</script>
"""


def build_interactive_viewer(
    out_dir: str,
    image_paths: list[str],
    gt_loader=None,
    pred_loader=None,
    color_map=None,
    *,
    disp_loader=None,
    max_images: int | None = None,
    title: str = "fcn8s_tensorflow_tpu viewer",
) -> str:
    """Render layer PNGs + ``viewer.html`` into ``out_dir``; returns the
    html path. ``gt_loader`` / ``pred_loader``: ``image_path -> (H, W) id
    map or None`` (same contract as ``viz.viewer.build_gallery``).
    ``disp_loader``: ``image_path -> (H, W) raw disparity values or None``
    (e.g. ``viz.viewer.load_disparity``); renders both the reference's
    plasma-colormapped depth visualization and a grayscale variant,
    toggled in the browser ('d' / 'm' — cityscapesViewer.py:222-230)."""
    from .viewer import disparity_to_rgb

    color_map = color_map or TRAINIDS_TO_RGBA_DICT
    os.makedirs(out_dir, exist_ok=True)
    paths = image_paths[:max_images] if max_images else image_paths
    if not paths:
        raise ValueError("no images")
    entries = []
    for path in paths:
        image = np.asarray(Image.open(path).convert("RGB"))
        stem = os.path.splitext(os.path.basename(path))[0]
        entry = {"name": os.path.basename(path), "img": f"{stem}_img.png",
                 "gt": None, "pred": None, "disp": None, "disp_gray": None}
        Image.fromarray(image).save(os.path.join(out_dir, entry["img"]))
        gt = gt_loader(path) if gt_loader else None
        if gt is not None:
            entry["gt"] = f"{stem}_gt.png"
            Image.fromarray(
                print_segmentation_onto_image(image, np.asarray(gt), color_map)
            ).save(os.path.join(out_dir, entry["gt"]))
        pred = pred_loader(path) if pred_loader else None
        if pred is not None:
            entry["pred"] = f"{stem}_pred.png"
            Image.fromarray(
                print_segmentation_onto_image(image, np.asarray(pred), color_map)
            ).save(os.path.join(out_dir, entry["pred"]))
        disp = disp_loader(path) if disp_loader else None
        if disp is not None:
            entry["disp"] = f"{stem}_disp.png"
            entry["disp_gray"] = f"{stem}_dispgray.png"
            Image.fromarray(disparity_to_rgb(disp)).save(
                os.path.join(out_dir, entry["disp"]))
            Image.fromarray(disparity_to_rgb(disp, colormapped=False)).save(
                os.path.join(out_dir, entry["disp_gray"]))
        entries.append(entry)

    out = os.path.join(out_dir, "viewer.html")
    with open(out, "w") as f:
        f.write(_VIEWER_HTML.format(
            title=html.escape(title), entries_json=json.dumps(entries)
        ))
    return out


def serve_viewer(directory: str, host: str = "127.0.0.1", port: int = 8008,
                 *, open_browser: bool = False, blocking: bool = True):
    """Serve a built viewer directory over HTTP (stdlib, threaded).

    ``blocking=False`` returns the live server (call ``.shutdown()``);
    otherwise serves until interrupted. Typical remote workflow::

        ssh -L 8008:localhost:8008 <host>  # then open http://localhost:8008/viewer.html
    """
    import functools
    import http.server
    import threading
    import webbrowser

    handler = functools.partial(
        http.server.SimpleHTTPRequestHandler, directory=directory
    )
    server = http.server.ThreadingHTTPServer((host, port), handler)
    url = f"http://{host}:{server.server_address[1]}/viewer.html"
    print(f"viewer at {url}")
    if open_browser:
        webbrowser.open(url)
    if blocking:
        try:
            server.serve_forever()
        finally:
            server.server_close()
        return None
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
