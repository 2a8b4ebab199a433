"""Self-contained interactive HTML map viewer.

Counterpart of ``viz/webviewer.py`` of the JAX package: the same payload
(``_map_payload``) in the same page.
Replaces the reference's Pangolin GL thread (reference: src/Viewer.cc,
src/MapDrawer.cc — map points, keyframe frusta, covisibility graph,
current-pose trail) with a dependency-free artifact: `export_html` writes
ONE .html file embedding the map as JSON plus a small canvas renderer
(drag = orbit, shift-drag = pan, wheel = zoom, keys toggle layers).
Headless-friendly: nothing to install, open in any browser.
"""
from __future__ import annotations

import json

import numpy as np


def _map_payload(m, max_points: int, max_edges: int) -> dict:
    pts = m.pt_xyz[m.pt_valid]
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[sel]
    kfs = m.kf_ids()
    centers, axes = [], []
    for k in kfs:
        R_wc = m.kf_R[k].T
        centers.append(-R_wc @ m.kf_t[k])
        axes.append(R_wc)
    # covisibility edges (weight >= 15, like KeyFrame::UpdateConnections)
    edges = []
    if len(kfs):
        cov = m.covisibility_matrix()[np.ix_(kfs, kfs)]
        ii, jj = np.where(np.triu(cov, 1) >= 15)
        for a, b in zip(ii[:max_edges], jj[:max_edges]):
            edges.append([int(a), int(b)])
    return {
        "points": np.round(np.asarray(pts, np.float64), 4).tolist(),
        "kf_centers": np.round(np.asarray(centers, np.float64)
                               .reshape(-1, 3), 4).tolist(),
        "kf_axes": np.round(np.asarray(axes, np.float64)
                            .reshape(-1, 9), 4).tolist(),
        "covis": edges,
    }


def export_html(target, path: str, trajectory=None,
                max_points: int = 150_000, max_edges: int = 4000,
                title: str = "tpu-slam map"):
    """Write an interactive viewer for `target` (a System, Atlas, or
    MapStore) to `path`. `trajectory` optionally overrides the frame
    trajectory ([T, 3] positions); a System provides its own."""
    maps = None
    if hasattr(target, "atlas"):                      # System
        maps = [m for m in target.atlas.maps if m.n_kf > 0]
        if trajectory is None and hasattr(target, "trajectory_tum"):
            rows = target.trajectory_tum()
            trajectory = np.asarray([r[1:4] for r in rows], np.float64)
    elif hasattr(target, "maps"):                     # Atlas
        maps = [m for m in target.maps if m.n_kf > 0]
    else:                                             # MapStore
        maps = [target]

    payload = {
        "title": title,
        "maps": [_map_payload(m, max_points, max_edges) for m in maps],
        "traj": (np.round(np.asarray(trajectory, np.float64), 4).tolist()
                 if trajectory is not None and len(trajectory) else []),
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpu-slam viewer</title>
<style>
 html,body{margin:0;height:100%;background:#10131a;color:#cfd6e4;
  font:12px/1.4 system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;pointer-events:none;
  text-shadow:0 1px 2px #000}
 #hud b{color:#fff}
 canvas{display:block}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const MAP_COLORS=["#6fb3ff","#ffb36f","#8fe08f","#e08fe0","#e0e08f","#8fe0e0"];
const cv=document.getElementById("c"),ctx=cv.getContext("2d");
let yaw=-0.6,pitch=-0.5,zoom=1,panX=0,panY=0,show={pts:1,kf:1,cov:1,traj:1};
// center + scale from all points
let all=[];for(const m of DATA.maps)all=all.concat(m.points);
if(!all.length)for(const m of DATA.maps)all=all.concat(m.kf_centers);
let c=[0,0,0];for(const p of all){c[0]+=p[0];c[1]+=p[1];c[2]+=p[2];}
if(all.length){c=c.map(v=>v/all.length);}
let rad=1e-6;for(const p of all){const d=Math.hypot(p[0]-c[0],p[1]-c[1],p[2]-c[2]);if(d>rad)rad=d;}
function proj(p){
 const x=p[0]-c[0],y=p[1]-c[1],z=p[2]-c[2];
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const x1=cy*x+sy*z, z1=-sy*x+cy*z;
 const y2=cp*y-sp*z1, z2=sp*y+cp*z1;
 const s=zoom*Math.min(cv.width,cv.height)*0.42/rad;
 return [cv.width/2+panX+x1*s, cv.height/2+panY-y2*s, z2];
}
function frustum(ctr,ax,size){
 // ax: row-major R_wc; camera looks along +z column
 const X=[ax[0],ax[3],ax[6]],Y=[ax[1],ax[4],ax[7]],Z=[ax[2],ax[5],ax[8]];
 const s=size,w=0.8*s,h=0.5*s,pts=[[0,0,0]];
 for(const[a,b]of[[-w,-h],[w,-h],[w,h],[-w,h]])
  pts.push([a*X[0]+b*Y[0]+s*Z[0],a*X[1]+b*Y[1]+s*Z[1],a*X[2]+b*Y[2]+s*Z[2]]);
 return pts.map(p=>proj([ctr[0]+p[0],ctr[1]+p[1],ctr[2]+p[2]]));
}
function draw(){
 cv.width=innerWidth;cv.height=innerHeight;
 ctx.fillStyle="#10131a";ctx.fillRect(0,0,cv.width,cv.height);
 let np=0,nk=0;
 DATA.maps.forEach((m,mi)=>{
  const col=MAP_COLORS[mi%MAP_COLORS.length];
  if(show.cov){ctx.strokeStyle="rgba(130,150,190,0.25)";ctx.lineWidth=1;
   ctx.beginPath();
   for(const[a,b]of m.covis){const p=proj(m.kf_centers[a]),q=proj(m.kf_centers[b]);
    ctx.moveTo(p[0],p[1]);ctx.lineTo(q[0],q[1]);}
   ctx.stroke();}
  if(show.pts){ctx.fillStyle=col;
   for(const p of m.points){const q=proj(p);ctx.fillRect(q[0],q[1],1.6,1.6);}
   np+=m.points.length;}
  if(show.kf){ctx.strokeStyle="#ff5f7a";ctx.lineWidth=1;
   const size=rad*0.035;
   m.kf_centers.forEach((ctr,i)=>{
    const f=frustum(ctr,m.kf_axes[i],size);
    ctx.beginPath();
    for(let j=1;j<=4;j++){ctx.moveTo(f[0][0],f[0][1]);ctx.lineTo(f[j][0],f[j][1]);
     const k=j===4?1:j+1;ctx.lineTo(f[k][0],f[k][1]);}
    ctx.stroke();});
   nk+=m.kf_centers.length;}
 });
 if(show.traj&&DATA.traj.length){ctx.strokeStyle="#ffd166";ctx.lineWidth=1.5;
  ctx.beginPath();DATA.traj.forEach((p,i)=>{const q=proj(p);
   i?ctx.lineTo(q[0],q[1]):ctx.moveTo(q[0],q[1]);});ctx.stroke();}
 document.getElementById("hud").innerHTML=
  `<b>${DATA.title}</b> &mdash; ${DATA.maps.length} map(s), ${nk} KFs, `+
  `${np} points, ${DATA.traj.length} trajectory poses<br>`+
  `drag orbit &middot; shift-drag pan &middot; wheel zoom &middot; `+
  `keys: [p]oints [k]eyframes [c]ovisibility [t]rajectory`;
}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){panX+=dx;panY+=dy;}else{yaw+=dx*0.008;pitch+=dy*0.008;}
 drag=[e.clientX,e.clientY,drag[2]];draw();};
onmouseup=()=>drag=null;
onwheel=e=>{zoom*=Math.exp(-e.deltaY*0.001);draw();};
onkeydown=e=>{const k={p:"pts",k:"kf",c:"cov",t:"traj"}[e.key];
 if(k){show[k]^=1;draw();}};
onresize=draw;draw();
</script></body></html>
"""
