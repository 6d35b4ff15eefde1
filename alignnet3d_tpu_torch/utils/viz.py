"""Offline scene visualization: render a registration pair + predicted
alignment to a PNG.

Replacement for the reference's pythreejs notebook viewer
(reference tp_utils/pointcloud.py:1322-1485, VisualizationScene) — the
same inspection capability (two clouds, centers, predicted vs GT motion)
as headless matplotlib figures instead of an interactive widget.

The port's own copy of ``alignnet3d_tpu/utils/viz.py``.
"""

from __future__ import annotations

import numpy as np

from alignnet3d_tpu_torch.geometry import get_mat_angle, transform_points


def render_pair(
    pc1: np.ndarray,
    pc2: np.ndarray,
    pred_translation=None,
    pred_angle=None,
    pred_center=None,
    gt_translation=None,
    gt_angle=None,
    gt_center=None,
    out_path: str | None = None,
    title: str = "",
):
    """Top-down (xy) + side (xz) scatter of the pair; optionally overlays
    pc1 moved by the predicted and/or GT motion. Returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    views = [("top view (x-y)", 0, 1), ("side view (x-z)", 0, 2)]

    layers = [(pc1, "tab:blue", "pc1"), (pc2, "tab:red", "pc2")]
    if pred_translation is not None:
        moved = transform_points(
            pc1,
            get_mat_angle(
                pred_translation, pred_angle,
                np.zeros(3) if pred_center is None else pred_center,
            ),
        )
        layers.append((moved, "tab:green", "pc1 @ prediction"))
    if gt_translation is not None:
        moved = transform_points(
            pc1,
            get_mat_angle(
                gt_translation, gt_angle,
                np.zeros(3) if gt_center is None else gt_center,
            ),
        )
        layers.append((moved, "tab:orange", "pc1 @ ground truth"))

    for ax, (name, i, j) in zip(axes, views):
        for pts, color, label in layers:
            pts = np.asarray(pts)
            if len(pts):
                ax.scatter(pts[:, i], pts[:, j], s=2, c=color, label=label,
                           alpha=0.6)
        ax.set_title(name)
        ax.set_aspect("equal")
        ax.legend(loc="best", fontsize=8)
    fig.suptitle(title)
    fig.tight_layout()
    if out_path is not None:
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
    return fig


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:rgba(0,0,0,.6);padding:8px 10px;
      border-radius:6px;user-select:none}
 #hud label{display:block;cursor:pointer;margin:2px 0}
 #hud .sw{display:inline-block;width:10px;height:10px;margin-right:6px;
      border-radius:2px}
 canvas{display:block}
</style></head><body>
<div id="hud"><b>__TITLE__</b><div id="layers"></div>
<small>drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</small></div>
<canvas id="c"></canvas>
<script>
const LAYERS = __LAYERS__;
const cv = document.getElementById('c'), gl = cv.getContext('webgl');
const vs = `attribute vec3 p;uniform mat4 mvp;uniform float ps;
 void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;}`;
const fs = `precision mediump float;uniform vec3 col;
 void main(){vec2 d=gl_PointCoord-vec2(.5);
 if(dot(d,d)>.25)discard;gl_FragColor=vec4(col,.85);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
 gl.compileShader(o);return o;}
const pr=gl.createProgram();
gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(pr);gl.useProgram(pr);
const locP=gl.getAttribLocation(pr,'p'),locM=gl.getUniformLocation(pr,'mvp'),
      locC=gl.getUniformLocation(pr,'col'),locS=gl.getUniformLocation(pr,'ps');
let ctr=[0,0,0],n=0;
for(const L of LAYERS){const a=L.pts;L.buf=gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER,L.buf);
 gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(a.flat()),gl.STATIC_DRAW);
 L.n=a.length;L.on=true;
 for(const q of a){ctr[0]+=q[0];ctr[1]+=q[1];ctr[2]+=q[2];n++;}}
if(n){ctr=ctr.map(x=>x/n);}
let az=.6,el=.4,dist=8,panX=0,panY=0;
function mat(){
 const w=cv.width,h=cv.height,asp=w/h,f=1/Math.tan(.4);
 const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
 // camera position on orbit sphere around ctr (z-up)
 const ex=ctr[0]+dist*ce*ca,ey=ctr[1]+dist*ce*sa,ez=ctr[2]+dist*se;
 let zx=ex-ctr[0],zy=ey-ctr[1],zz=ez-ctr[2];
 const zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
 // camera right = up x z with up=(0,0,1): (-zy, zx, 0)
 let xx=-zy,xy=zx,xz=0;
 const xl=Math.hypot(xx,xy,xz)||1;xx/=xl;xy/=xl;xz/=xl;
 const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 const tx=-(xx*ex+xy*ey+xz*ez)+panX,ty=-(yx*ex+yy*ey+yz*ez)+panY,
       tz=-(zx*ex+zy*ey+zz*ez);
 const nr=.01,fr=1000,A=(fr+nr)/(nr-fr),B=2*fr*nr/(nr-fr);
 return [
  f/asp*xx, f*yx, zx*A, -zx,
  f/asp*xy, f*yy, zy*A, -zy,
  f/asp*xz, f*yz, zz*A, -zz,
  f/asp*tx, f*ty, tz*A+B, -tz];
}
function draw(){
 cv.width=innerWidth;cv.height=innerHeight;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(.07,.07,.07,1);gl.clear(gl.COLOR_BUFFER_BIT);
 const m=mat();gl.uniformMatrix4fv(locM,false,new Float32Array(m));
 for(const L of LAYERS){if(!L.on||!L.n)continue;
  gl.bindBuffer(gl.ARRAY_BUFFER,L.buf);
  gl.enableVertexAttribArray(locP);
  gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  gl.uniform3fv(locC,L.color);gl.uniform1f(locS,L.size||3);
  gl.drawArrays(gl.POINTS,0,L.n);}
}
let drag=false,px=0,py=0;
cv.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
 if(e.shiftKey){panX+=dx*.01*dist*.1;panY-=dy*.01*dist*.1;}
 else{az-=dx*.008;el=Math.max(-1.5,Math.min(1.5,el+dy*.008));}
 draw();};
cv.onwheel=e=>{e.preventDefault();dist*=Math.exp(e.deltaY*.001);draw();};
window.onresize=draw;
const hud=document.getElementById('layers');
for(const L of LAYERS){
 const lab=document.createElement('label');
 const cb=document.createElement('input');cb.type='checkbox';cb.checked=true;
 cb.onchange=()=>{L.on=cb.checked;draw();};
 const sw=document.createElement('span');sw.className='sw';
 sw.style.background=`rgb(${L.color.map(x=>x*255|0)})`;
 lab.append(cb,sw,`${L.name} (${L.n})`);hud.append(lab);}
draw();
</script></body></html>
"""

_LAYER_COLORS = {
    "pc1": (0.25, 0.55, 1.0),
    "pc2": (1.0, 0.35, 0.3),
    "pc1 @ prediction": (0.3, 0.9, 0.4),
    "pc1 @ ground truth": (1.0, 0.75, 0.2),
    "centers": (1.0, 1.0, 1.0),
}


def export_html_scene(
    pc1: np.ndarray,
    pc2: np.ndarray,
    out_path: str,
    pred_translation=None,
    pred_angle=None,
    pred_center=None,
    gt_translation=None,
    gt_angle=None,
    gt_center=None,
    title: str = "alignnet3d scene",
    extra_layers=None,
):
    """Write a self-contained interactive 3D viewer to ``out_path``.

    Equivalent of the reference's pythreejs ``VisualizationScene``
    (reference tp_utils/pointcloud.py:1322-1485): orbit/zoom/pan camera,
    per-layer visibility toggles, the pair plus predicted/GT overlays as
    colored point layers. Implemented as one standalone HTML file with an
    inline WebGL renderer — no notebook kernel, no external JS, viewable
    in any browser (the headless analogue of a live widget:
    artifacts are produced headless on the host and inspected anywhere).

    ``extra_layers``: optional list of (name, (M,3) array) appended as
    additional toggleable layers.
    """
    import json as _json

    layers = [("pc1", np.asarray(pc1)), ("pc2", np.asarray(pc2))]
    if pred_translation is not None:
        layers.append((
            "pc1 @ prediction",
            transform_points(
                np.asarray(pc1),
                get_mat_angle(
                    pred_translation, pred_angle,
                    np.zeros(3) if pred_center is None else pred_center,
                ),
            ),
        ))
    if gt_translation is not None:
        layers.append((
            "pc1 @ ground truth",
            transform_points(
                np.asarray(pc1),
                get_mat_angle(
                    gt_translation, gt_angle,
                    np.zeros(3) if gt_center is None else gt_center,
                ),
            ),
        ))
    centers = [c for c in (pred_center, gt_center) if c is not None]
    if centers:
        layers.append(("centers", np.asarray(centers, np.float32)))
    for name, pts in (extra_layers or []):
        layers.append((str(name), np.asarray(pts)))

    palette = list(_LAYER_COLORS.values())
    blobs = []
    for i, (name, pts) in enumerate(layers):
        color = _LAYER_COLORS.get(name, palette[i % len(palette)])
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        blobs.append({
            "name": name,
            "color": list(color),
            "size": 6 if name == "centers" else 3,
            "pts": [[round(float(v), 4) for v in p] for p in pts],
        })
    html = (
        _HTML_TEMPLATE
        .replace("__TITLE__", title)
        .replace("__LAYERS__", _json.dumps(blobs))
    )
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def render_eval_samples(cfg, eval_dir: str, sample_indices, out_dir: str,
                        dataset=None, html: bool = False):
    """Render prediction overlays for chosen val samples from a completed
    eval directory's artifacts. With ``html=True`` an interactive
    standalone viewer (export_html_scene) is written next to each PNG."""
    import os

    from alignnet3d_tpu_torch.data.provider import PackedDataset, getDataFiles

    if dataset is None:
        dataset = PackedDataset(cfg.data.basepath)
    val_idxs = getDataFiles(f"{cfg.data.basepath}/split/val.txt")
    pred_t = np.load(f"{eval_dir}/pred_translations.npy")
    pred_a = np.load(f"{eval_dir}/pred_angles.npy")
    pred_c = np.load(f"{eval_dir}/pred_s2_pc1centers.npy")
    os.makedirs(out_dir, exist_ok=True)
    rows = dataset.rows(val_idxs)
    for pos in sample_indices:
        row = rows[pos]
        o1, c1 = dataset.offsets1[row], dataset.counts1[row]
        o2, c2 = dataset.offsets2[row], dataset.counts2[row]
        pc1 = dataset.points1[o1: o1 + c1]
        pc2 = dataset.points2[o2: o2 + c2]
        kwargs = dict(
            pred_translation=pred_t[pos], pred_angle=float(pred_a[pos]),
            pred_center=pred_c[pos],
            gt_translation=dataset.translations[row],
            gt_angle=float(dataset.rel_angles[row, 0]),
            gt_center=dataset.pc1centers[row],
            title=f"val sample {val_idxs[pos]}",
        )
        stem = os.path.join(out_dir, f"sample_{val_idxs[pos]:08d}")
        render_pair(pc1, pc2, out_path=stem + ".png", **kwargs)
        if html:
            export_html_scene(pc1, pc2, stem + ".html", **kwargs)
