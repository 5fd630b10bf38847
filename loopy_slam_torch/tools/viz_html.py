"""Interactive 3-D viewer as one self-contained WebGL HTML file (port of
loopy_slam_tpu/tools/viz_html.py, numpy only).

The reference ships an Open3D window with live submap re-anchoring. The
headless counterpart is an HTML file, raw WebGL with no external
dependency, that any browser opens: orbit / pan / zoom over the
reconstructed point cloud, the estimated and ground-truth trajectories, a
frame slider that moves the camera frustum along the trajectory, and a
toggle to the last before-PGO trajectory snapshot. It reads run
directories of either package (checkpoints through utils/io.load_checkpoint)
and writes the JAX tool's bytes for the same run (the page, its title
included, is the same template).

CLI: python -m loopy_slam_torch.tools.viz_html --output <run_dir>
         [--max_points 200000] [--out scene.html]
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os

import numpy as np


def _pack(arr: np.ndarray, dtype) -> str:
    return base64.b64encode(np.ascontiguousarray(
        arr.astype(dtype)).tobytes()).decode("ascii")


def export_html(output_dir: str, out_path: str = None,
                max_points: int = 200000) -> str:
    """Build the viewer from a run's final checkpoint (+ optional
    final_point_cloud.npy colors and PGO snapshots). Returns the path."""
    from ..utils.io import load_checkpoint

    ckpts = [c for c in sorted(glob.glob(
        os.path.join(output_dir, "ckpts", "[0-9]*.pkl")))
        if "pgo" not in c]
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {output_dir}/ckpts")
    ck = load_checkpoint(ckpts[-1])
    n = int(ck["idx"]) + 1
    est = np.asarray(ck["estimate_c2w_list"][:n], np.float32)
    gt = np.asarray(ck["gt_c2w_list"][:n], np.float32)

    # point cloud: prefer the exported sensor cloud (has RGB); fall back
    # to the checkpoint's neural points (colored by height)
    pc_path = os.path.join(output_dir, "final_point_cloud.npy")
    if os.path.exists(pc_path):
        pc = np.load(pc_path)
        pts, rgb = pc[:, :3], pc[:, 3:6] / 255.0
    else:
        pts = np.asarray(ck.get("map", {}).get("pos",
                                               np.zeros((0, 3))))
        h = (pts[:, 1] - pts[:, 1].min()) / max(
            np.ptp(pts[:, 1]), 1e-6) if len(pts) else np.zeros(0)
        rgb = np.stack([h, 0.5 * np.ones_like(h), 1.0 - h], -1)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts, rgb = pts[sel], rgb[sel]

    # PGO snapshots: the LAST correction event, for the toggle
    befores = sorted(glob.glob(os.path.join(output_dir, "ckpts",
                                            "*_before_pgo.pkl")))
    traj_before = None
    if befores:
        bk = load_checkpoint(befores[-1])
        tb = np.asarray(bk["estimate_c2w_list"][:n], np.float32)
        # the snapshot's trajectory array is preallocated zeros past the
        # PGO event's frame — drawing those rows would clump points at
        # the origin. Keep only the filled prefix, padded with the
        # final trajectory so both buffers stay n frames long (the JS
        # draws a single fixed-length trajectory).
        filled = np.abs(tb).reshape(len(tb), -1).sum(1) > 0
        n_valid = int(filled.argmin()) if not filled.all() else len(tb)
        traj_before = est[:, :3, 3].copy()
        traj_before[:n_valid] = tb[:n_valid, :3, 3]

    data = {
        "pts": _pack(pts, np.float32),
        "rgb": _pack(np.clip(rgb, 0, 1) * 255, np.uint8),
        "n_pts": int(len(pts)),
        "est": _pack(est[:, :3, 3], np.float32),
        "gt": _pack(gt[:, :3, 3], np.float32),
        "cams": _pack(est[:, :3, :3].reshape(n, 9), np.float32),
        "n_frames": n,
        "before": (_pack(traj_before, np.float32) if traj_before is not None
                   else None),
        "title": os.path.basename(os.path.abspath(output_dir)),
    }
    html = _HTML.replace("__DATA__", json.dumps(data))
    out_path = out_path or os.path.join(output_dir, "viewer.html")
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


_HTML = r"""<!doctype html><html><head><meta charset="utf-8">
<title>loopy_slam_tpu viewer</title><style>
 body{margin:0;background:#101014;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#0008;padding:8px 12px;border-radius:6px}
 #hud label{margin-right:10px}
 input[type=range]{vertical-align:middle;width:220px}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b id="title"></b><br>
 <label><input id="showpts" type="checkbox" checked> cloud</label>
 <label><input id="showgt" type="checkbox" checked> gt</label>
 <label id="pgolbl" style="display:none"><input id="pgo" type="checkbox"> pre-PGO</label><br>
 frame <input id="frame" type="range" min="0" value="0"> <span id="fno"></span><br>
 <span style="opacity:.6">drag: orbit &middot; shift-drag: pan &middot; wheel: zoom</span>
</div>
<script>
const D = __DATA__;
const b64f = s => new Float32Array(Uint8Array.from(atob(s), c=>c.charCodeAt(0)).buffer);
const b64u = s => Uint8Array.from(atob(s), c=>c.charCodeAt(0));
const pts = b64f(D.pts), rgb = b64u(D.rgb), est = b64f(D.est), gt = b64f(D.gt);
const cams = b64f(D.cams), before = D.before ? b64f(D.before) : null;
document.getElementById('title').textContent = D.title + '  (' + D.n_pts + ' pts, ' + D.n_frames + ' frames)';
if (before) document.getElementById('pgolbl').style.display='inline';
const cv = document.getElementById('c'), gl = cv.getContext('webgl');
const vs = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp; uniform float ps;
 varying vec3 vc; void main(){gl_Position=mvp*vec4(p,1.); gl_PointSize=ps; vc=col;}`;
const fs = `precision mediump float; varying vec3 vc; void main(){gl_FragColor=vec4(vc,1.);}`;
function prog(){const P=gl.createProgram();
 for(const [t,s] of [[gl.VERTEX_SHADER,vs],[gl.FRAGMENT_SHADER,fs]]){
  const sh=gl.createShader(t); gl.shaderSource(sh,s); gl.compileShader(sh); gl.attachShader(P,sh);}
 gl.linkProgram(P); return P;}
const P = prog(); gl.useProgram(P);
const aP = gl.getAttribLocation(P,'p'), aC = gl.getAttribLocation(P,'col');
const uM = gl.getUniformLocation(P,'mvp'), uS = gl.getUniformLocation(P,'ps');
function buf(data){const b=gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW); return b;}
const rgbF = new Float32Array(rgb.length); for(let i=0;i<rgb.length;i++) rgbF[i]=rgb[i]/255;
const bP=buf(pts), bC=buf(rgbF), bE=buf(est), bG=buf(gt);
const bB = before ? buf(before) : null;
function solid(n,r,g,b){const a=new Float32Array(n*3);
 for(let i=0;i<n;i++){a[3*i]=r;a[3*i+1]=g;a[3*i+2]=b;} return buf(a);}
const cE=solid(D.n_frames,0.3,0.7,1), cG=solid(D.n_frames,0.4,0.4,0.4);
// scene center/scale from the cloud (or trajectory)
let mn=[1e9,1e9,1e9],mx=[-1e9,-1e9,-1e9];
const src = D.n_pts? pts : est;
for(let i=0;i<src.length;i+=3) for(let k=0;k<3;k++){
 mn[k]=Math.min(mn[k],src[i+k]); mx[k]=Math.max(mx[k],src[i+k]);}
const ctr=[0,1,2].map(k=>(mn[k]+mx[k])/2);
let dist=Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2])*1.5||5;
let yaw=0.6, pitch=0.4, panX=0, panY=0;
function mat(){
 const a=Math.cos(yaw),b=Math.sin(yaw),c=Math.cos(pitch),d=Math.sin(pitch);
 const eye=[ctr[0]+dist*b*c, ctr[1]+dist*d, ctr[2]+dist*a*c];
 const f=norm3([ctr[0]-eye[0],ctr[1]-eye[1],ctr[2]-eye[2]]);
 const r=norm3(cross(f,[0,1,0])), u=cross(r,f);
 const tx=-dot(r,eye)+panX, ty=-dot(u,eye)+panY, tz=dot(f,eye);
 const n=0.01*dist, fa=40*dist, asp=cv.width/cv.height, t=Math.tan(0.4);
 // column-major: proj * view
 const v=[r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0, tx,ty,tz,1];
 const p=[1/(t*asp),0,0,0, 0,1/t,0,0, 0,0,-(fa+n)/(fa-n),-1, 0,0,-2*fa*n/(fa-n),0];
 return mul4(p,v);}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function dot(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;return [a[0]/l,a[1]/l,a[2]/l];}
function mul4(a,b){const o=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k]; o[i*4+j]=s;} return o;}
const slider=document.getElementById('frame'); slider.max=D.n_frames-1;
function frustumVerts(fi){
 const t=[est[3*fi],est[3*fi+1],est[3*fi+2]];
 const R=cams.slice(9*fi,9*fi+9); const s=dist*0.03;
 const cn=[[-1,-0.6,-1.5],[1,-0.6,-1.5],[1,0.6,-1.5],[-1,0.6,-1.5]].map(v=>
  [t[0]+s*(R[0]*v[0]+R[1]*v[1]+R[2]*v[2]), t[1]+s*(R[3]*v[0]+R[4]*v[1]+R[5]*v[2]),
   t[2]+s*(R[6]*v[0]+R[7]*v[1]+R[8]*v[2])]);
 const L=[]; for(let i=0;i<4;i++){L.push(t,cn[i],cn[i],cn[(i+1)%4]);}
 return new Float32Array(L.flat());}
let bF=gl.createBuffer();
function draw(){
 cv.width=innerWidth; cv.height=innerHeight; gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.06,0.06,0.08,1); gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.enable(gl.DEPTH_TEST);
 const M=mat(); gl.uniformMatrix4fv(uM,false,M);
 function attach(bp,bc){gl.bindBuffer(gl.ARRAY_BUFFER,bp);
  gl.enableVertexAttribArray(aP); gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,bc); gl.enableVertexAttribArray(aC);
  gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);}
 if(document.getElementById('showpts').checked && D.n_pts){
  gl.uniform1f(uS,2.0); attach(bP,bC); gl.drawArrays(gl.POINTS,0,D.n_pts);}
 const usePre = before && document.getElementById('pgo').checked;
 gl.uniform1f(uS,3.5); attach(usePre?bB:bE,cE);
 gl.drawArrays(gl.POINTS,0,D.n_frames);
 if(document.getElementById('showgt').checked){
  attach(bG,cG); gl.drawArrays(gl.POINTS,0,D.n_frames);}
 const fi=+slider.value; document.getElementById('fno').textContent=fi;
 const fv=frustumVerts(fi);
 gl.bindBuffer(gl.ARRAY_BUFFER,yelBuf); gl.enableVertexAttribArray(aC);
 gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bF);
 gl.bufferData(gl.ARRAY_BUFFER,fv,gl.DYNAMIC_DRAW);
 gl.enableVertexAttribArray(aP); gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.LINES,0,fv.length/3);
 requestAnimationFrame(draw);}
const yelBuf=solid(16,1,0.85,0.2);  // frustum: 16 line verts, fixed color
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return; const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){panX+=dx*dist*0.002; panY-=dy*dist*0.002;}
 else{yaw-=dx*0.008; pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.008));}
 drag=[e.clientX,e.clientY,drag[2]];};
onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);};
draw();
</script></body></html>
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--max_points", type=int, default=200000)
    args = ap.parse_args(argv)
    p = export_html(args.output, args.out, args.max_points)
    print(f"wrote {p}")
    return p


if __name__ == "__main__":
    main()
