"""Browser-based polygon annotation editor (the label tool). Port of
``fcn8s_tensorflow_tpu/prep/label_tool.py``; the page is the JAX package's,
byte for byte.

The reference ships a 2,785-line PyQt4 desktop editor
(``cityscapesLabelTool.py``) for creating/correcting the polygon ground
truth. Training machines are headless, so, like the viewer
(``viz/serve.py``), the tool lives in the browser: a stdlib HTTP server
plus one self-contained vanilla-JS canvas page, workable over SSH port
forwarding.

Capability map to the Qt tool's core loop:

* browse the image list, see which images already have annotations;
* draw a new polygon (click vertices, double-click/Enter to close, pick a
  label from the registry with its legend color);
* select a polygon (click inside), drag its vertices, delete it;
* insert a vertex mid-edge (select mode: click on an edge of the selected
  polygon — the browser twin of ``annotation.CsObject.insert_vertex``);
* undo (button / 'z' / Ctrl+Z) — snapshot history of every mutating edit
  (vertex add, polygon close, vertex drag, vertex insert, delete,
  correction-box edits);
* correction mode ('c') — the Qt tool's review workflow
  (`cityscapesLabelTool.py:149-234`): drag typed rectangles
  (to-correct/to-review/resolved/question, 't' cycles, 'e' edits the
  note) over the annotation; saved through ``prep.corrections`` as the
  reference's LabelMe-style XML, one ``<image>.xml`` per image;
* save — the server round-trips the result through
  ``prep.annotation.Annotation`` so what lands on disk is exactly the
  Cityscapes ``*_polygons.json`` schema the rasterizers
  (``prep/rasterize.py``, ``prep/create_gt_imgs.py``) consume;
* rasterized preview (``/api/preview``) — the saved polygons drawn through
  the REAL ``create_label_image`` path, alpha-composited on the image, so
  what you see is what training will get;
* magnifier zoom-window ('m') — the Qt tool's drawing aid: a fixed 4x
  inset following the cursor with a crosshair at the would-be vertex,
  active while drawing;
* PNG screenshot export (``/api/screenshot/<idx>`` / the screenshot
  button) — the composited review view (image + rasterized annotation +
  typed correction boxes with notes) as one archivable PNG, rendered
  server-side (the Qt tools' screenshot action).

Server-side editing stays available programmatically via
``prep.annotation`` (add/move/delete vertex, relabel, reorder); this tool
is the interactive front end over the same model. The annotate -> save ->
rasterize -> trainIds chain is covered by tests/test_torch_prep.py.

Run:  python -m fcn8s_tensorflow_tpu_torch.prep.label_tool <image_dir> [port]
then  ssh -L 8010:localhost:8010 <host>  and open http://localhost:8010/
"""

from __future__ import annotations

import io
import json
import os
from glob import glob

import numpy as np
from PIL import Image

from ..labels.cityscapes import labels as _labels
from .annotation import Annotation
from .rasterize import create_label_image

_POLY_SUFFIX = "_polygons.json"


class AnnotationTool:
    """Filesystem and editing logic, separable from the HTTP layer for tests."""

    def __init__(self, image_dir: str, annotation_dir: str | None = None,
                 image_file_extension: str = "png", user: str = "",
                 corrections_dir: str | None = None):
        self.image_dir = image_dir
        self.annotation_dir = annotation_dir or image_dir
        self.corrections_dir = corrections_dir or self.annotation_dir
        self.user = user
        os.makedirs(self.annotation_dir, exist_ok=True)
        os.makedirs(self.corrections_dir, exist_ok=True)
        self.image_paths = sorted(
            glob(os.path.join(image_dir, f"*.{image_file_extension}")))
        if not self.image_paths:
            raise ValueError(f"no .{image_file_extension} images in {image_dir}")

    def annotation_path(self, index: int) -> str:
        """Cityscapes-compatible name: ``<city>_<seq>_<frame>_gtFine_polygons.json``
        — the exact pattern ``prep/create_gt_imgs.py`` discovers
        (``*_gt*_polygons.json``), so point ``annotation_dir`` at
        ``<root>/gtFine/<split>/<city>/`` and the batch rasterizers pick the
        tool's output up directly."""
        stem = os.path.splitext(os.path.basename(self.image_paths[index]))[0]
        # Cityscapes pairing: strip the image-type suffix if present
        for t in ("_leftImg8bit",):
            if stem.endswith(t):
                stem = stem[: -len(t)]
        if not stem.endswith(("_gtFine", "_gtCoarse")):
            stem += "_gtFine"
        return os.path.join(self.annotation_dir, stem + _POLY_SUFFIX)

    def list_images(self) -> list[dict]:
        return [
            {"name": os.path.basename(p),
             "annotated": os.path.isfile(self.annotation_path(i))}
            for i, p in enumerate(self.image_paths)
        ]

    def labels_payload(self) -> list[dict]:
        # one entry per distinct name, registry order (drawing legend)
        return [
            {"name": l.name, "color": list(l.color), "hasInstances": l.hasInstances}
            for l in _labels if l.id >= 0
        ]

    def image_bytes(self, index: int) -> bytes:
        with open(self.image_paths[index], "rb") as f:
            return f.read()

    def image_size(self, index: int) -> tuple[int, int]:
        with Image.open(self.image_paths[index]) as im:
            return im.size  # (W, H)

    def get_annotation(self, index: int) -> dict:
        """Simplified editing payload: {imgWidth, imgHeight, objects:
        [{id, label, polygon: [[x, y], ...]}]} (deleted objects omitted)."""
        w, h = self.image_size(index)
        path = self.annotation_path(index)
        objects = []
        if os.path.isfile(path):
            ann = Annotation()
            ann.from_json_file(path)
            w, h = ann.imgWidth, ann.imgHeight
            objects = [
                {"id": o.id, "label": o.label,
                 "polygon": [[p.x, p.y] for p in o.polygon]}
                for o in ann.objects if not o.deleted
            ]
        return {"imgWidth": w, "imgHeight": h, "objects": objects}

    def save_annotation(self, index: int, payload: dict) -> str:
        """Persist the editing payload as schema-exact Cityscapes JSON by
        rebuilding through ``Annotation`` (labels validated against the
        registry incl. the 'group' fallback). Returns the file path."""
        from .rasterize import _resolve_label

        w, h = self.image_size(index)
        ann = Annotation()
        ann.imgWidth, ann.imgHeight = int(payload.get("imgWidth", w)), int(payload.get("imgHeight", h))
        for obj in payload.get("objects", []):
            label = str(obj["label"])
            _resolve_label(label)  # raises on unknown labels
            polygon = [(float(x), float(y)) for x, y in obj["polygon"]]
            if len(polygon) < 3:
                raise ValueError(f"polygon for '{label}' needs >= 3 vertices")
            ann.add_object(label, polygon, user=self.user)
        path = self.annotation_path(index)
        ann.to_json_file(path)
        return path

    def correction_path(self, index: int) -> str:
        """Reference scheme (cityscapesLabelTool.py:2743-2768): the image
        basename with the extension swapped to ``.xml``, in the corrections
        directory (a ``gtFine_corrections`` mirror in the reference's
        layout; here ``corrections_dir``, defaulting to the annotation
        dir)."""
        stem = os.path.splitext(os.path.basename(self.image_paths[index]))[0]
        return os.path.join(self.corrections_dir, stem + ".xml")

    def get_corrections(self, index: int) -> dict:
        from .corrections import CorrectionSheet

        path = self.correction_path(index)
        if not os.path.isfile(path):
            w, h = self.image_size(index)
            return {"nrows": h, "ncols": w, "boxes": []}
        sheet = CorrectionSheet.from_xml_file(path)
        return {"nrows": sheet.nrows, "ncols": sheet.ncols,
                "boxes": [b.to_payload() for b in sheet.boxes]}

    def save_corrections(self, index: int, payload: dict) -> str:
        """Persist the editing payload as the reference's XML schema.
        Saving an empty box list removes the file (an all-resolved sheet
        should not leave a stale review marker behind)."""
        from .corrections import CorrectionBox, CorrectionSheet

        path = self.correction_path(index)
        boxes = [CorrectionBox.from_payload(b)
                 for b in payload.get("boxes", [])]
        if not boxes:
            if os.path.isfile(path):
                os.remove(path)
            return path
        w, h = self.image_size(index)
        name = os.path.basename(self.image_paths[index])
        # reference folder header: "StereoDataset/<city>" (city = first
        # underscore-separated token of the Cityscapes filename)
        sheet = CorrectionSheet(filename=name,
                                folder="StereoDataset/" + name.split("_")[0],
                                nrows=h, ncols=w, boxes=boxes)
        sheet.to_xml_file(path)
        return path

    def preview_png(self, index: int, alpha: float = 0.5) -> bytes:
        """The saved annotation rasterized through the real GT path
        (create_label_image 'color') composited on the image."""
        image = np.asarray(Image.open(self.image_paths[index]).convert("RGB"), np.float32)
        path = self.annotation_path(index)
        if os.path.isfile(path):
            ann = Annotation()
            ann.from_json_file(path)
            color = np.asarray(create_label_image(ann, "color"), np.float32)[..., :3]
            mask = (color.sum(-1, keepdims=True) > 0).astype(np.float32) * alpha
            image = image * (1 - mask) + color * mask
        buf = io.BytesIO()
        Image.fromarray(image.astype(np.uint8)).save(buf, format="PNG")
        return buf.getvalue()

    # correction-box type -> outline RGB (matches the editor's CORR_COLORS)
    _CORR_RGB = {1: (255, 0, 0), 2: (255, 255, 0),
                 3: (0, 255, 0), 4: (34, 136, 255)}

    def screenshot_png(self, index: int, alpha: float = 0.5) -> bytes:
        """PNG export of the composited review view: image + rasterized
        saved annotation (the preview composite) + correction boxes drawn
        in their type colors with notes — the Qt tools' screenshot action
        (`cityscapesViewer.py:204-257` screenshot/save-view machinery),
        server-side so a headless workflow can archive review states
        (``GET /api/screenshot/<idx>`` or the editor's screenshot
        button)."""
        from PIL import ImageDraw

        base = Image.open(io.BytesIO(self.preview_png(index, alpha))).convert("RGB")
        draw = ImageDraw.Draw(base)
        for b in self.get_corrections(index)["boxes"]:
            col = self._CORR_RGB.get(int(b["type"]), (255, 0, 0))
            x0, y0 = int(b["x"]), int(b["y"])
            draw.rectangle([x0, y0, x0 + int(b["width"]), y0 + int(b["height"])],
                           outline=col, width=2)
            if b.get("annotation"):
                draw.text((x0 + 2, max(0, y0 - 12)), str(b["annotation"]),
                          fill=col)
        buf = io.BytesIO()
        base.save(buf, format="PNG")
        return buf.getvalue()


_EDITOR_HTML = """<!doctype html>
<meta charset="utf-8">
<title>fcn8s_tensorflow_tpu label tool</title>
<style>
  body { background:#111; color:#eee; font:14px sans-serif; margin:0; }
  #bar { padding:.5em 1em; background:#1c1c1c; display:flex; gap:.8em;
         align-items:center; position:sticky; top:0; flex-wrap:wrap; }
  #stage { overflow:hidden; position:relative; height:calc(100vh - 3.4em); }
  canvas { position:absolute; transform-origin:0 0; cursor:crosshair; }
  button, select { background:#333; color:#eee; border:1px solid #555; padding:.2em .6em; }
  .on { background:#2a6; }
  #status { opacity:.7 }
</style>
<div id="bar">
  <button id="prev">&larr;</button><span id="name"></span><button id="next">&rarr;</button>
  <button id="draw" class="on">draw (d)</button>
  <button id="select">select (s)</button>
  <button id="correct">correct (c)</button>
  <select id="label"></select>
  <button id="del">delete poly (Del)</button>
  <button id="undo">undo (z)</button>
  <button id="save">save (w)</button>
  <button id="preview">preview raster</button>
  <button id="magbtn" class="on">magnifier (m)</button>
  <button id="shot">screenshot</button>
  <span id="status"></span>
  <span id="corrhint" style="opacity:.6;display:none">drag box · t: cycle type · e: edit note</span>
</div>
<div id="stage"><canvas id="cv"></canvas></div>
<canvas id="mag" width="200" height="200"
  style="position:fixed;right:12px;top:60px;border:1px solid #555;background:#000;display:none;pointer-events:none;z-index:5"></canvas>
<script>
let IMAGES=[], LABELS=[], idx=0, ann={objects:[]}, img=new Image(), mode="draw";
let current=[], selected=-1, dragV=null, scale=1, ox=0, oy=0, panning=null, dirty=false;
let corr={boxes:[]}, selCorr=-1, boxDrag=null;  // correction layer (reference correction mode)
const CORR_COLORS={1:"#f00",2:"#ff0",3:"#0f0",4:"#28f"};  // to-correct/review/resolved/question
let history=[];
function snap(){history.push(JSON.stringify({objects:ann.objects,current,boxes:corr.boxes}));
  if(history.length>200)history.shift();}
function undo(){if(!history.length)return;
  const s=JSON.parse(history.pop());ann.objects=s.objects;current=s.current;
  corr.boxes=s.boxes||corr.boxes;
  selected=-1;selCorr=-1;dragV=null;dirty=true;draw();}
const cv=document.getElementById("cv"), cx=cv.getContext("2d");
const colorOf=n=>{const l=LABELS.find(l=>l.name===n);return l?`rgb(${l.color})`:"#fff";};
async function j(u,o){const r=await fetch(u,o); if(!r.ok) throw new Error(await r.text()); return r.json();}
async function init(){
  IMAGES=await j("/api/images"); LABELS=await j("/api/labels");
  const sel=document.getElementById("label");
  for(const l of LABELS){const o=document.createElement("option");o.value=l.name;
    o.textContent=l.name;o.style.background=colorOf(l.name);sel.appendChild(o);}
  sel.value="car"; load(0);
}
async function load(i){
  if(dirty&&!confirm("Discard unsaved changes?"))return;
  idx=(i+IMAGES.length)%IMAGES.length; ann=await j(`/api/annotation/${idx}`);
  corr=await j(`/api/corrections/${idx}`);
  current=[]; selected=-1; selCorr=-1; dirty=false; history=[];
  img=new Image(); img.onload=()=>{cv.width=img.width; cv.height=img.height; draw();};
  img.src=`/api/image/${idx}?` + Date.now();
  document.getElementById("name").textContent=
    `${IMAGES[idx].name} (${idx+1}/${IMAGES.length})` + (IMAGES[idx].annotated?" ✓":"");
}
function draw(previewSrc){
  cx.clearRect(0,0,cv.width,cv.height); cx.drawImage(img,0,0);
  ann.objects.forEach((o,i)=>{
    cx.beginPath(); o.polygon.forEach(([x,y],k)=>k?cx.lineTo(x,y):cx.moveTo(x,y));
    cx.closePath(); cx.fillStyle=colorOf(o.label); cx.globalAlpha=i===selected?0.55:0.35;
    cx.fill(); cx.globalAlpha=1; cx.lineWidth=i===selected?2.5:1.2;
    cx.strokeStyle=i===selected?"#fff":colorOf(o.label); cx.stroke();
    if(i===selected) for(const [x,y] of o.polygon){cx.fillStyle="#fff";cx.fillRect(x-3,y-3,6,6);}
  });
  if(current.length){
    cx.beginPath(); current.forEach(([x,y],k)=>k?cx.lineTo(x,y):cx.moveTo(x,y));
    cx.strokeStyle="#ff0"; cx.lineWidth=1.5; cx.stroke();
    for(const [x,y] of current){cx.fillStyle="#ff0";cx.fillRect(x-2.5,y-2.5,5,5);}
  }
  corr.boxes.forEach((b,i)=>{
    cx.strokeStyle=CORR_COLORS[b.type]||"#f00"; cx.lineWidth=i===selCorr?3:1.8;
    cx.setLineDash(i===selCorr?[]:[6,4]);
    cx.strokeRect(b.x,b.y,b.width,b.height); cx.setLineDash([]);
    if(b.annotation){cx.font="12px sans-serif";cx.fillStyle=CORR_COLORS[b.type]||"#f00";
      cx.fillText(b.annotation,b.x+2,Math.max(10,b.y-3));}
  });
  if(boxDrag&&boxDrag.cur){
    cx.strokeStyle="#f00"; cx.lineWidth=1.5; cx.setLineDash([4,3]);
    cx.strokeRect(Math.min(boxDrag.x0,boxDrag.cur[0]),Math.min(boxDrag.y0,boxDrag.cur[1]),
      Math.abs(boxDrag.cur[0]-boxDrag.x0),Math.abs(boxDrag.cur[1]-boxDrag.y0));
    cx.setLineDash([]);
  }
  cv.style.transform=`translate(${ox}px,${oy}px) scale(${scale})`;
}
function pos(e){const r=cv.getBoundingClientRect();
  return [(e.clientX-r.left)*cv.width/r.width,(e.clientY-r.top)*cv.height/r.height];}
function inPoly(p,poly){let c=false;
  for(let i=0,k=poly.length-1;i<poly.length;k=i++){
    const [xi,yi]=poly[i],[xk,yk]=poly[k];
    if(((yi>p[1])!=(yk>p[1]))&&(p[0]<(xk-xi)*(p[1]-yi)/(yk-yi)+xi)) c=!c;}
  return c;}
function edgeHit(p,poly){ // nearest edge within tolerance -> insertion point
  const tol=5/scale+2; let best=null;
  for(let i=0;i<poly.length;i++){
    const a=poly[i],b=poly[(i+1)%poly.length];
    const dx=b[0]-a[0],dy=b[1]-a[1],len2=dx*dx+dy*dy||1e-9;
    const t=Math.max(0,Math.min(1,((p[0]-a[0])*dx+(p[1]-a[1])*dy)/len2));
    const qx=a[0]+t*dx,qy=a[1]+t*dy,d=Math.hypot(p[0]-qx,p[1]-qy);
    if(d<tol&&(!best||d<best.d)) best={i,d,pt:[Math.round(qx),Math.round(qy)]};
  }
  return best;
}
cv.addEventListener("mousedown",e=>{
  const p=pos(e);
  if(e.button===1||e.shiftKey){panning=[e.clientX-ox,e.clientY-oy];return;}
  if(mode==="correct"){
    selCorr=corr.boxes.findIndex(b=>p[0]>=b.x&&p[0]<=b.x+b.width&&p[1]>=b.y&&p[1]<=b.y+b.height);
    if(selCorr<0) boxDrag={x0:Math.round(p[0]),y0:Math.round(p[1]),cur:null};
    draw();return;}
  if(mode==="draw"){snap();current.push([Math.round(p[0]),Math.round(p[1])]);dirty=true;draw();return;}
  if(selected>=0){ // vertex hit?
    const poly=ann.objects[selected].polygon;
    for(let i=0;i<poly.length;i++){const[x,y]=poly[i];
      if(Math.abs(x-p[0])<6/scale+3&&Math.abs(y-p[1])<6/scale+3){snap();dragV=i;return;}}
    // edge hit -> insert a vertex there (annotation.CsObject.insert_vertex)
    const hit=edgeHit(p,poly);
    if(hit){snap();poly.splice(hit.i+1,0,hit.pt);dragV=hit.i+1;dirty=true;draw();return;}}
  selected=ann.objects.findIndex(o=>inPoly(p,o.polygon)); draw();
});
// magnifier zoom-window (the Qt label tool's drawing aid): a fixed 4x
// inset following the cursor while drawing, with a crosshair at the
// would-be vertex. Toggle 'm'; draw-mode only.
let magOn=true, lastMouse=null;
const mag=document.getElementById("mag"), mg=mag.getContext("2d");
function drawMag(){
  if(!magOn||mode!=="draw"||!lastMouse){mag.style.display="none";return;}
  mag.style.display="";
  const R=25;  // 50px source window -> 200px inset = 4x
  mg.imageSmoothingEnabled=false;
  mg.fillStyle="#000";mg.fillRect(0,0,200,200);
  mg.drawImage(cv,lastMouse[0]-R,lastMouse[1]-R,2*R,2*R,0,0,200,200);
  mg.strokeStyle="#ff0";mg.beginPath();
  mg.moveTo(100,0);mg.lineTo(100,200);mg.moveTo(0,100);mg.lineTo(200,100);mg.stroke();
}
cv.addEventListener("mousemove",e=>{
  lastMouse=pos(e);
  if(panning){ox=e.clientX-panning[0];oy=e.clientY-panning[1];draw();return;}
  if(boxDrag){boxDrag.cur=pos(e).map(Math.round);draw();drawMag();return;}
  if(dragV!=null&&selected>=0){const p=pos(e);
    ann.objects[selected].polygon[dragV]=[Math.round(p[0]),Math.round(p[1])];dirty=true;draw();}
  drawMag();
});
cv.addEventListener("mouseleave",()=>{lastMouse=null;drawMag();});
addEventListener("mouseup",()=>{
  if(boxDrag){
    const d=boxDrag; boxDrag=null;
    if(d.cur&&Math.abs(d.cur[0]-d.x0)>=3&&Math.abs(d.cur[1]-d.y0)>=3){
      snap();
      corr.boxes.push({x:Math.min(d.x0,d.cur[0]),y:Math.min(d.y0,d.cur[1]),
        width:Math.abs(d.cur[0]-d.x0),height:Math.abs(d.cur[1]-d.y0),
        type:1,annotation:prompt("correction note:","")||""});
      selCorr=corr.boxes.length-1;dirty=true;}
    draw();}
  dragV=null;panning=null;});
cv.addEventListener("dblclick",e=>{e.preventDefault();closePoly();});
cv.addEventListener("wheel",e=>{e.preventDefault();
  scale=Math.min(16,Math.max(0.2,scale*(e.deltaY<0?1.15:0.87)));draw();},{passive:false});
function closePoly(){
  if(current.length>=3){
    snap();
    ann.objects.push({label:document.getElementById("label").value,polygon:current});
    selected=ann.objects.length-1;}
  current=[];draw();
}
function setMode(m){mode=m;
  if(m!=="correct"){selCorr=-1;boxDrag=null;}  // no hidden-box edits from other modes
  document.getElementById("draw").classList.toggle("on",m==="draw");
  document.getElementById("select").classList.toggle("on",m==="select");
  document.getElementById("correct").classList.toggle("on",m==="correct");
  document.getElementById("corrhint").style.display=m==="correct"?"":"none";
  draw();drawMag();}
async function save(){
  await j(`/api/annotation/${idx}`,{method:"POST",body:JSON.stringify(ann)});
  await j(`/api/corrections/${idx}`,{method:"POST",body:JSON.stringify(corr)});
  IMAGES[idx].annotated=true;dirty=false;
  document.getElementById("status").textContent="saved";
  setTimeout(()=>document.getElementById("status").textContent="",1200);
}
document.getElementById("prev").onclick=()=>load(idx-1);
document.getElementById("next").onclick=()=>load(idx+1);
document.getElementById("draw").onclick=()=>setMode("draw");
document.getElementById("select").onclick=()=>setMode("select");
document.getElementById("correct").onclick=()=>setMode("correct");
document.getElementById("del").onclick=()=>{
  if(selected>=0){snap();ann.objects.splice(selected,1);selected=-1;dirty=true;draw();}};
document.getElementById("undo").onclick=undo;
document.getElementById("save").onclick=save;
document.getElementById("preview").onclick=()=>{
  const p=new Image();p.onload=()=>{cx.drawImage(p,0,0);};p.src=`/api/preview/${idx}?`+Date.now();};
function toggleMag(){magOn=!magOn;
  document.getElementById("magbtn").classList.toggle("on",magOn);drawMag();}
document.getElementById("magbtn").onclick=toggleMag;
document.getElementById("shot").onclick=()=>{
  const a=document.createElement("a");
  a.href=`/api/screenshot/${idx}?`+Date.now();
  a.download=IMAGES[idx].name.replace(/\\.[^.]*$/,"")+"_screenshot.png";a.click();};
addEventListener("keydown",e=>{
  if(e.key==="ArrowRight")load(idx+1); else if(e.key==="ArrowLeft")load(idx-1);
  else if(e.key==="d")setMode("draw"); else if(e.key==="s")setMode("select");
  else if(e.key==="c")setMode("correct");
  else if(e.key==="m")toggleMag();
  else if(e.key==="t"&&mode==="correct"&&selCorr>=0){snap();
    corr.boxes[selCorr].type=corr.boxes[selCorr].type%4+1;dirty=true;draw();}
  else if(e.key==="e"&&mode==="correct"&&selCorr>=0){snap();
    corr.boxes[selCorr].annotation=prompt("correction note:",corr.boxes[selCorr].annotation)
      ??corr.boxes[selCorr].annotation;dirty=true;draw();}
  else if(e.key==="Enter")closePoly(); else if(e.key==="Escape"){current=[];boxDrag=null;draw();}
  else if(e.key==="w")save();
  else if(e.key==="z"||(e.ctrlKey&&e.key==="Z")){e.preventDefault();undo();}
  else if(e.key==="Delete"&&mode==="correct"&&selCorr>=0){
    snap();corr.boxes.splice(selCorr,1);selCorr=-1;dirty=true;draw();}
  else if(e.key==="Delete"&&selected>=0){snap();ann.objects.splice(selected,1);selected=-1;dirty=true;draw();}
});
init();
</script>
"""


def make_server(tool: AnnotationTool, host: str = "127.0.0.1", port: int = 8010):
    """Build (not start) the editor's ThreadingHTTPServer."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = self.path.split("?")[0]
            try:
                if path in ("/", "/index.html"):
                    self._send(200, _EDITOR_HTML.encode(), "text/html")
                elif path == "/api/images":
                    self._json(tool.list_images())
                elif path == "/api/labels":
                    self._json(tool.labels_payload())
                elif path.startswith("/api/image/"):
                    self._send(200, tool.image_bytes(int(path.rsplit("/", 1)[1])), "image/png")
                elif path.startswith("/api/annotation/"):
                    self._json(tool.get_annotation(int(path.rsplit("/", 1)[1])))
                elif path.startswith("/api/corrections/"):
                    self._json(tool.get_corrections(int(path.rsplit("/", 1)[1])))
                elif path.startswith("/api/preview/"):
                    self._send(200, tool.preview_png(int(path.rsplit("/", 1)[1])), "image/png")
                elif path.startswith("/api/screenshot/"):
                    self._send(200, tool.screenshot_png(int(path.rsplit("/", 1)[1])),
                               "image/png")
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as exc:  # noqa: BLE001 — editor must not die
                self._json({"error": str(exc)}, 500)

        def do_POST(self):
            path = self.path.split("?")[0]
            try:
                if path.startswith("/api/annotation/"):
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    saved = tool.save_annotation(int(path.rsplit("/", 1)[1]), payload)
                    self._json({"saved": os.path.basename(saved)})
                elif path.startswith("/api/corrections/"):
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    saved = tool.save_corrections(int(path.rsplit("/", 1)[1]), payload)
                    self._json({"saved": os.path.basename(saved)})
                else:
                    self._json({"error": "not found"}, 404)
            except (ValueError, KeyError) as exc:  # bad payload -> 400
                self._json({"error": str(exc)}, 400)
            except Exception as exc:  # noqa: BLE001
                self._json({"error": str(exc)}, 500)

    return http.server.ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    tool = AnnotationTool(argv[0])
    port = int(argv[1]) if len(argv) > 1 else 8010
    server = make_server(tool, port=port)
    print(f"label tool for {argv[0]} at http://127.0.0.1:{server.server_address[1]}/")
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
