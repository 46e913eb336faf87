"""Interactive HTML graph viewer (port of ndt_feature_graph_tpu/viz/html.py).

`export_html(path, slam, gt=None)` writes ONE self-contained HTML file
(no external assets, works offline): canvas rendering of the stitched
occupancy map, graph nodes and loop-closure links, estimated and
ground-truth trajectories, with mouse pan, wheel zoom, layer toggles and
a time slider that replays the trajectory.  The data is embedded as
compact JSON (cell centres rounded to cm); for the same graph the
payload is the reference's.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.viz.plot import _np


def _graph_payload(slam, gt=None, max_cells_per_node=4000):
    """A JSON-serializable scene description of an NDTFeatureGraphSLAM
    (frozen nodes and the current state).  A node with more than
    `max_cells_per_node` occupied cells keeps a sample of them drawn with
    numpy's default_rng(0), as the reference draws it."""
    res = slam.params.fuser.ndt.resolution
    nodes = []
    for nd, T in zip(slam.nodes, slam.node_T):
        ys, xs = np.nonzero(_np(nd.occ) > 0.5)
        if len(ys) > max_cells_per_node:
            sel = np.random.default_rng(0).choice(
                len(ys), max_cells_per_node, replace=False)
            ys, xs = ys[sel], xs[sel]
        origin = _np(nd.occ_origin)
        centers = np.stack(
            [origin[0] + (xs + 0.5) * res, origin[1] + (ys + 0.5) * res], -1)
        if len(centers):
            world = se2.transform_points(
                torch.as_tensor(_np(T), dtype=torch.float32),
                torch.as_tensor(centers, dtype=torch.float32)).numpy()
        else:
            world = centers
        nodes.append({"pose": [round(float(v), 4) for v in _np(T)],
                      "cells": np.round(world, 2).tolist()})

    # loop_links rows: (i, j, T_rel, cov, ...): draw i <-> j.
    links = [[int(ln[0]), int(ln[1])] for ln in getattr(slam, "loop_links",
                                                         [])]
    payload = {
        "resolution": res,
        "nodes": nodes,
        "links": links,
        "traj": np.round(np.stack(slam.trajectory), 3).tolist(),
    }
    if gt is not None:
        payload["gt"] = np.round(_np(gt), 3).tolist()
    return payload


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ndt_feature_graph_tpu viewer</title>
<style>
 body{margin:0;font:13px sans-serif;background:#16181d;color:#cfd3dc}
 #bar{padding:6px 10px;display:flex;gap:14px;align-items:center;
      background:#1f232b;user-select:none;flex-wrap:wrap}
 #bar label{cursor:pointer}
 canvas{display:block;cursor:grab}
 #slider{width:260px}
 .sw{display:inline-block;width:10px;height:10px;margin-right:4px;
     border-radius:2px;vertical-align:-1px}
</style></head><body>
<div id="bar">
 <b>ndt_feature_graph_tpu</b>
 <label><input type="checkbox" id="Lmap" checked>
   <span class="sw" style="background:#8a93a6"></span>map</label>
 <label><input type="checkbox" id="Lgraph" checked>
   <span class="sw" style="background:#4da3ff"></span>graph</label>
 <label><input type="checkbox" id="Llinks" checked>
   <span class="sw" style="background:#ffd34d"></span>closures</label>
 <label><input type="checkbox" id="Ltraj" checked>
   <span class="sw" style="background:#ff5d5d"></span>estimate</label>
 <label><input type="checkbox" id="Lgt" checked>
   <span class="sw" style="background:#5dd98a"></span>ground truth</label>
 <input type="range" id="slider" min="1" value="0">
 <span id="tlab"></span>
 <span style="opacity:.6">drag to pan &middot; wheel to zoom</span>
</div>
<canvas id="cv"></canvas>
<script>
const D = __DATA__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const slider = document.getElementById('slider');
slider.max = D.traj.length; slider.value = D.traj.length;
let view = {x:0, y:0, s:40};   // world->screen: s px per metre
function fit(){
  let xs=[], ys=[];
  for (const n of D.nodes) for (const c of n.cells){xs.push(c[0]);ys.push(c[1]);}
  for (const p of D.traj){xs.push(p[0]);ys.push(p[1]);}
  if(!xs.length){xs=[0];ys=[0];}
  const x0=Math.min(...xs), x1=Math.max(...xs),
        y0=Math.min(...ys), y1=Math.max(...ys);
  const w=cv.width, h=cv.height;
  view.s = Math.min(w/(x1-x0+2), h/(y1-y0+2));
  view.x = (x0+x1)/2; view.y=(y0+y1)/2;
}
function sx(x){return cv.width/2 + (x-view.x)*view.s;}
function sy(y){return cv.height/2 - (y-view.y)*view.s;}
function draw(){
  ctx.fillStyle='#16181d'; ctx.fillRect(0,0,cv.width,cv.height);
  const t = +slider.value;
  document.getElementById('tlab').textContent = t+' / '+D.traj.length;
  if (document.getElementById('Lmap').checked){
    ctx.fillStyle='#8a93a6';
    const r=Math.max(1, D.resolution*view.s*0.8);
    for (const n of D.nodes) for (const c of n.cells)
      ctx.fillRect(sx(c[0])-r/2, sy(c[1])-r/2, r, r);
  }
  if (document.getElementById('Lgt').checked && D.gt){
    ctx.strokeStyle='#5dd98a'; ctx.lineWidth=1.5; ctx.beginPath();
    D.gt.forEach((p,i)=>i?ctx.lineTo(sx(p[0]),sy(p[1]))
                         :ctx.moveTo(sx(p[0]),sy(p[1])));
    ctx.stroke();
  }
  if (document.getElementById('Ltraj').checked){
    ctx.strokeStyle='#ff5d5d'; ctx.lineWidth=1.5; ctx.beginPath();
    D.traj.slice(0,t).forEach((p,i)=>i?ctx.lineTo(sx(p[0]),sy(p[1]))
                                      :ctx.moveTo(sx(p[0]),sy(p[1])));
    ctx.stroke();
    if (t>0){ const p=D.traj[t-1];
      ctx.fillStyle='#ff5d5d'; ctx.beginPath();
      ctx.arc(sx(p[0]),sy(p[1]),4,0,7); ctx.fill();
      ctx.strokeStyle='#fff'; ctx.beginPath();
      ctx.moveTo(sx(p[0]),sy(p[1]));
      ctx.lineTo(sx(p[0]+0.6*Math.cos(p[2])), sy(p[1]+0.6*Math.sin(p[2])));
      ctx.stroke(); }
  }
  if (document.getElementById('Llinks').checked){
    ctx.strokeStyle='#ffd34d'; ctx.lineWidth=1.2;
    for (const [i,j] of D.links){
      if (i>=D.nodes.length || j>=D.nodes.length) continue;
      const a=D.nodes[i].pose, b=D.nodes[j].pose;
      ctx.beginPath(); ctx.moveTo(sx(a[0]),sy(a[1]));
      ctx.lineTo(sx(b[0]),sy(b[1])); ctx.stroke();
    }
  }
  if (document.getElementById('Lgraph').checked){
    ctx.strokeStyle='#4da3ff'; ctx.lineWidth=1; ctx.beginPath();
    D.nodes.forEach((n,i)=>i?ctx.lineTo(sx(n.pose[0]),sy(n.pose[1]))
                            :ctx.moveTo(sx(n.pose[0]),sy(n.pose[1])));
    ctx.stroke();
    ctx.fillStyle='#4da3ff';
    for (const n of D.nodes){
      ctx.beginPath(); ctx.arc(sx(n.pose[0]),sy(n.pose[1]),3.5,0,7);
      ctx.fill();
    }
  }
}
function resize(){
  cv.width=innerWidth; cv.height=innerHeight-document.getElementById('bar').offsetHeight;
  draw();
}
let drag=null;
cv.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY];cv.style.cursor='grabbing';});
addEventListener('mouseup',()=>{drag=null;cv.style.cursor='grab';});
addEventListener('mousemove',e=>{ if(!drag) return;
  view.x-=(e.clientX-drag[0])/view.s; view.y+=(e.clientY-drag[1])/view.s;
  drag=[e.clientX,e.clientY]; draw(); });
cv.addEventListener('wheel',e=>{ e.preventDefault();
  view.s*=Math.pow(1.0015,-e.deltaY); draw(); },{passive:false});
slider.addEventListener('input',draw);
for (const id of ['Lmap','Lgraph','Llinks','Ltraj','Lgt'])
  document.getElementById(id).addEventListener('change',draw);
addEventListener('resize',resize);
resize(); fit(); draw();
</script></body></html>
"""


def export_html(path, slam, gt=None):
    """Write a self-contained interactive viewer for a SLAM run."""
    payload = _graph_payload(slam, gt)
    html = _TEMPLATE.replace(
        "__DATA__", json.dumps(payload, separators=(",", ":")))
    with open(path, "w") as f:
        f.write(html)
    return path
