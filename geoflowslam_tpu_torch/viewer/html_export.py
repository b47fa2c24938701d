"""Interactive 3D map export: one self-contained HTML file (port of
geoflowslam_tpu/viewer/html_export.py; host numpy, the MapState and poses
read from any device).

The reference's Viewer thread gives the operator a pan/rotate/zoom OpenGL
view of the map (Pangolin render loop, src/Viewer.cc:159;
MapDrawer::DrawMapPoints/DrawKeyFrames/DrawCurrentCamera). A headless run
writes the same content — map points, keyframe frusta, the camera
trajectory, the current camera — into a single HTML file with an embedded zero-dependency canvas renderer: orbit
(drag), pan (right-drag / shift-drag), zoom (wheel), point-size and
layer toggles. Open in any browser; nothing to install, no network.

Data volume: points are decimated to <= max_points (the viewer's job is
orientation, not storage — the full cloud lives in globalMap.pcd / npz
checkpoints).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>geoflowslam-tpu map</title>
<style>
 body{margin:0;background:#111;color:#ccc;font:12px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:rgba(0,0,0,.55);
      padding:6px 9px;border-radius:4px;line-height:1.6}
 #hud label{margin-right:10px;cursor:pointer}
 canvas{display:block}
</style></head><body>
<div id="hud">
 <b>geoflowslam-tpu</b> — drag: orbit · right/shift-drag: pan · wheel: zoom<br>
 <span id="stats"></span><br>
 <label><input type="checkbox" id="tpts" checked> points</label>
 <label><input type="checkbox" id="tkfs" checked> keyframes</label>
 <label><input type="checkbox" id="ttraj" checked> trajectory</label>
 <label>size <input type="range" id="psz" min="1" max="5" value="2"
   style="width:60px;vertical-align:middle"></label>
</div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
resize(); addEventListener('resize', ()=>{resize(); draw();});

// ---- camera state: orbit around target ------------------------------------
const pts = DATA.points, kfs = DATA.keyframes, traj = DATA.trajectory;
let ctr=[0,0,0];
if (pts.length){ for(const p of pts){ctr[0]+=p[0];ctr[1]+=p[1];ctr[2]+=p[2];}
  ctr=ctr.map(v=>v/pts.length); }
let r0=1e-3; for(const p of pts){const d=Math.hypot(p[0]-ctr[0],p[1]-ctr[1],
  p[2]-ctr[2]); if(d>r0) r0=d;}
let yaw=0.6, pitch=-0.45, dist=2.4*r0, tgt=ctr.slice(), fl=1.2;

function basis(){
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  // camera axes in world coords (y-down world, SLAM convention)
  const fwd=[sy*cp, sp, cy*cp];
  const right=[cy, 0, -sy];
  const up=[ -sy*sp, cp, -cy*sp ];
  const eye=[tgt[0]-fwd[0]*dist, tgt[1]-fwd[1]*dist, tgt[2]-fwd[2]*dist];
  return {fwd, right, up, eye};
}
function project(p, B){
  const x=p[0]-B.eye[0], y=p[1]-B.eye[1], z=p[2]-B.eye[2];
  const cz=x*B.fwd[0]+y*B.fwd[1]+z*B.fwd[2];
  if (cz<1e-4) return null;
  const cx=x*B.right[0]+y*B.right[1]+z*B.right[2];
  const cyv=x*B.up[0]+y*B.up[1]+z*B.up[2];
  const s=fl*H/cz;
  return [W/2+cx*s, H/2-cyv*s, cz];
}
function seg(a,b,B,color,w){
  const pa=project(a,B), pb=project(b,B);
  if(!pa||!pb) return;
  ctx.strokeStyle=color; ctx.lineWidth=w;
  ctx.beginPath(); ctx.moveTo(pa[0],pa[1]); ctx.lineTo(pb[0],pb[1]);
  ctx.stroke();
}
const FR=[[0,0,0],[-1,-.75,1.5],[1,-.75,1.5],[1,.75,1.5],[-1,.75,1.5]];
const FE=[[0,1],[0,2],[0,3],[0,4],[1,2],[2,3],[3,4],[4,1]];
function frustum(rwc,c,scale,B,color,w){
  const wpts=FR.map(p=>{const q=[p[0]*scale,p[1]*scale,p[2]*scale];
    return [rwc[0][0]*q[0]+rwc[0][1]*q[1]+rwc[0][2]*q[2]+c[0],
            rwc[1][0]*q[0]+rwc[1][1]*q[1]+rwc[1][2]*q[2]+c[1],
            rwc[2][0]*q[0]+rwc[2][1]*q[1]+rwc[2][2]*q[2]+c[2]];});
  for(const [a,b] of FE) seg(wpts[a],wpts[b],B,color,w);
}
function draw(){
  ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
  const B=basis(), sz=+document.getElementById('psz').value;
  if(document.getElementById('tpts').checked){
    ctx.fillStyle='#9ad';
    for(const p of pts){ const q=project(p,B); if(!q) continue;
      const s=Math.max(.7, sz*2.2/Math.sqrt(q[2]/r0+.3));
      ctx.globalAlpha=Math.min(1,.25+ .9*r0/(q[2]+r0));
      ctx.fillRect(q[0]-s/2, q[1]-s/2, s, s); }
    ctx.globalAlpha=1;
  }
  if(document.getElementById('ttraj').checked && traj.length>1){
    for(let i=1;i<traj.length;i++)
      seg(traj[i-1],traj[i],B,'#e66',1.4);
  }
  if(document.getElementById('tkfs').checked){
    for(const k of kfs) frustum(k.r,k.c,0.06*r0,B,'#4c7',0.8);
  }
  if (DATA.current) frustum(DATA.current.r,DATA.current.c,0.1*r0,B,'#fd5',1.6);
  document.getElementById('stats').textContent =
    pts.length+' pts · '+kfs.length+' KFs · '+traj.length+' poses';
}
// ---- interaction -----------------------------------------------------------
let drag=null;
cv.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,
  pan:e.button===2||e.shiftKey};});
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{
  if(!drag) return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
  drag.x=e.clientX; drag.y=e.clientY;
  if(drag.pan){ const B=basis(), s=dist/(fl*H);
    tgt[0]-=(B.right[0]*dx-B.up[0]*dy)*s; tgt[1]-=(B.right[1]*dx-B.up[1]*dy)*s;
    tgt[2]-=(B.right[2]*dx-B.up[2]*dy)*s;
  } else { yaw+=dx*0.008; pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008)); }
  draw();
});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);
  dist=Math.max(r0*0.05, Math.min(r0*40, dist)); draw(); e.preventDefault();},
  {passive:false});
cv.addEventListener('contextmenu',e=>e.preventDefault());
for(const id of ['tpts','tkfs','ttraj','psz'])
  document.getElementById(id).addEventListener('input',draw);
draw();
</script></body></html>
"""


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def export_html(ms, trajectory: Optional[Sequence[Tuple[float, np.ndarray]]]
                = None, cur_rot=None, cur_t=None, path: str = "map.html",
                max_points: int = 60000) -> str:
    """Write the interactive map view. `ms` is a MapState (or None),
    `trajectory` the SlamSystem.trajectory list of (t, T_wc)."""
    pts = np.zeros((0, 3), np.float32)
    kfs = []
    if ms is not None:
        mv = _host(ms.mp_valid)
        pts = _host(ms.mp_pos)[mv].astype(np.float32)
        if len(pts) > max_points:
            sel = np.random.default_rng(0).choice(len(pts), max_points,
                                                  replace=False)
            pts = pts[sel]
        kf_valid = _host(ms.kf_valid)
        rots = _host(ms.kf_rot)
        ts = _host(ms.kf_t)
        for k in np.flatnonzero(kf_valid):
            rwc = rots[k].T
            c = -rwc @ ts[k]
            kfs.append({"r": np.round(rwc, 5).tolist(),
                        "c": np.round(c, 4).tolist()})
    traj = []
    if trajectory:
        for _, twc in trajectory:
            twc = np.asarray(twc)
            traj.append(np.round(twc[:3, 3], 4).tolist())
    current = None
    if cur_rot is not None and cur_t is not None:
        rwc = _host(cur_rot).T
        c = -rwc @ _host(cur_t)
        current = {"r": np.round(rwc, 5).tolist(),
                   "c": np.round(c, 4).tolist()}
    data = {"points": np.round(pts, 4).tolist(), "keyframes": kfs,
            "trajectory": traj, "current": current}
    html = _TEMPLATE.replace("__DATA__", json.dumps(data,
                                                    separators=(",", ":")))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
