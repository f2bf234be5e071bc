"""Self-contained HTML point-cloud + camera-frusta viewer (port of
``tpusfm/io/viewer.py``; the page is the reference's, byte for byte).

Capability parity with the reference's interactive inspection viewer
(WorldStructure::show — a PCL visualizer rendering the cloud with
per-camera coordinate frames, src/world/WorldStructure.h:108-155).  Here
the artifact is a single HTML file with an inline WebGL renderer and the
scene data embedded as base64 — it opens OFFLINE (no CDN, no server) and
is also served by the HTTP service at /files/viewer.html.

Controls: drag = orbit, wheel = zoom, shift-drag = pan, double-click =
reset.
"""

from __future__ import annotations

import base64
from pathlib import Path

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpusfm viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#101014;color:#ccc;
  font:12px system-ui,sans-serif}
 #hud{position:fixed;left:10px;top:8px;opacity:.8;pointer-events:none}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud">__TITLE__ &mdash; drag: orbit &middot; wheel: zoom &middot;
 shift-drag: pan &middot; dblclick: reset</div>
<canvas id="c"></canvas>
<script>
"use strict";
const PTS_B64="__PTS__", COL_B64="__COLS__", CAM_B64="__CAMS__";
function f32(b64){const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
function u8(b64){const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a;}
const pts=f32(PTS_B64), cols=u8(COL_B64), camLines=f32(CAM_B64);
const N=pts.length/3, NC=camLines.length/3;

const cv=document.getElementById("c");
const gl=cv.getContext("webgl",{antialias:true});
const VS=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
 uniform float psz;varying vec3 vc;
 void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=psz;vc=col;}`;
const FS=`precision mediump float;varying vec3 vc;
 void main(){gl_FragColor=vec4(vc,1.0);}`;
function shader(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
 gl.compileShader(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,shader(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,shader(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const locP=gl.getAttribLocation(prog,"p"),locC=gl.getAttribLocation(prog,"col");
const locM=gl.getUniformLocation(prog,"mvp"),locS=gl.getUniformLocation(prog,"psz");

function buf(data){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b;}
const colsF=new Float32Array(N*3);
for(let i=0;i<N*3;i++)colsF[i]=cols[i]/255.0;
const bP=buf(pts), bC=buf(colsF), bCam=buf(camLines);
const camColF=new Float32Array(NC*3);
for(let i=0;i<NC;i++){camColF[3*i]=0.2;camColF[3*i+1]=1.0;camColF[3*i+2]=0.35;}
const bCamC=buf(camColF);

// scene bounds -> initial camera
let cx=0,cy=0,cz=0;
for(let i=0;i<N;i++){cx+=pts[3*i];cy+=pts[3*i+1];cz+=pts[3*i+2];}
if(N){cx/=N;cy/=N;cz/=N;}
let rad=1e-6;
for(let i=0;i<N;i++){const dx=pts[3*i]-cx,dy=pts[3*i+1]-cy,dz=pts[3*i+2]-cz;
 rad=Math.max(rad,Math.hypot(dx,dy,dz));}
const home={theta:0.6,phi:0.8,dist:rad*2.5,tx:cx,ty:cy,tz:cz};
let v={...home};

function mat(){
 const w=cv.width,h=cv.height,asp=w/h,f=1.0/Math.tan(0.4);
 const near=rad*0.01,far=rad*40.0;
 const P=[f/asp,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
          0,0,2*far*near/(near-far),0];
 const ex=v.tx+v.dist*Math.cos(v.phi)*Math.sin(v.theta);
 const ey=v.ty+v.dist*Math.sin(v.phi);
 const ez=v.tz+v.dist*Math.cos(v.phi)*Math.cos(v.theta);
 let zx=ex-v.tx,zy=ey-v.ty,zz=ez-v.tz;const zl=Math.hypot(zx,zy,zz);
 zx/=zl;zy/=zl;zz/=zl;
 let xx=zz*0-1*zy, xy=1*zx-0*zz, xz=0*zy-0*zx; // up=(0,1,0) cross z
 xx=1*zz-0*zy; xy=0*zx-0*zz; xz=0*zy-1*zx;
 const xl=Math.hypot(xx,xy,xz)||1;xx/=xl;xy/=xl;xz/=xl;
 const yx=zy*xz-zz*xy, yy=zz*xx-zx*xz, yz=zx*xy-zy*xx;
 const V=[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0,
  -(xx*ex+xy*ey+xz*ez),-(yx*ex+yy*ey+yz*ez),-(zx*ex+zy*ey+zz*ez),1];
 // P*V (column major)
 const M=new Float32Array(16);
 for(let c0=0;c0<4;c0++)for(let r0=0;r0<4;r0++){let s=0;
  for(let k=0;k<4;k++)s+=P[k*4+r0]*V[c0*4+k];M[c0*4+r0]=s;}
 return M;
}
function draw(){
 const dpr=window.devicePixelRatio||1;
 cv.width=cv.clientWidth*dpr;cv.height=cv.clientHeight*dpr;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.063,0.063,0.078,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.enable(gl.DEPTH_TEST);
 const M=mat();gl.uniformMatrix4fv(locM,false,M);
 gl.uniform1f(locS,Math.max(1.5,2.2*dpr));
 gl.bindBuffer(gl.ARRAY_BUFFER,bP);gl.enableVertexAttribArray(locP);
 gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bC);gl.enableVertexAttribArray(locC);
 gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.POINTS,0,N);
 gl.bindBuffer(gl.ARRAY_BUFFER,bCam);
 gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bCamC);
 gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.LINES,0,NC);
}
let drag=null;
cv.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};});
window.addEventListener("mouseup",()=>drag=null);
window.addEventListener("mousemove",e=>{
 if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.shift){const s=v.dist*0.002;
  v.tx-=dx*s*Math.cos(v.theta);v.tz+=dx*s*Math.sin(v.theta);v.ty+=dy*s;}
 else{v.theta-=dx*0.008;v.phi=Math.min(1.5,Math.max(-1.5,v.phi+dy*0.008));}
 draw();});
cv.addEventListener("wheel",e=>{e.preventDefault();
 v.dist*=Math.exp(e.deltaY*0.0012);draw();},{passive:false});
cv.addEventListener("dblclick",()=>{v={...home};draw();});
window.addEventListener("resize",draw);
draw();
</script></body></html>
"""


def write_viewer_html(path: str | Path, points: np.ndarray,
                      colors: np.ndarray | None = None,
                      cam_rotations: np.ndarray | None = None,
                      cam_centers: np.ndarray | None = None,
                      intr: np.ndarray | None = None,
                      title: str = "tpusfm reconstruction",
                      max_points: int = 400_000) -> Path:
    """Write the self-contained viewer next to the other artifacts.

    points (N, 3) f32; colors (N, 3) u8 (grey when None);
    cam_rotations (V, 3, 3) world->cam + cam_centers (V, 3) draw a frustum
    per camera (scaled by the scene radius)."""
    path = Path(path)
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    fin = np.isfinite(pts).all(axis=1)
    pts = pts[fin]
    if colors is not None:
        cols = np.asarray(colors, np.uint8).reshape(-1, 3)[fin]
    else:
        cols = np.full((len(pts), 3), 200, np.uint8)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts, cols = pts[sel], cols[sel]

    lines = np.zeros((0, 3), np.float32)
    if cam_centers is not None and len(cam_centers):
        C = np.asarray(cam_centers, np.float32)
        scale = 0.05 * (np.linalg.norm(pts.std(axis=0)) if len(pts) else 1.0) \
            * 6.0 or 0.1
        segs = []
        for v in range(len(C)):
            c = C[v]
            if cam_rotations is not None:
                R = np.asarray(cam_rotations[v], np.float32)
                # Frustum corners in camera frame (z forward).
                z = scale
                corners = np.array([[-z, -z * 0.75, 2 * z], [z, -z * 0.75, 2 * z],
                                    [z, z * 0.75, 2 * z], [-z, z * 0.75, 2 * z]])
                wc = corners @ R + c  # R^T^T: rows are cam axes; x_w = R^T x_c + c
                for k in range(4):
                    segs.append([c, wc[k]])
                    segs.append([wc[k], wc[(k + 1) % 4]])
            else:
                for ax in np.eye(3, dtype=np.float32):
                    segs.append([c, c + ax * scale])
        lines = np.asarray(segs, np.float32).reshape(-1, 3)

    def b64(arr):
        return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()

    html = (_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__PTS__", b64(pts))
            .replace("__COLS__", b64(cols))
            .replace("__CAMS__", b64(lines)))
    path.write_text(html)
    return path


def write_scene_viewer(path: str | Path, scene, title="tpusfm reconstruction"):
    """Viewer from a Scene (any device): active points + registered-camera
    frusta."""
    pm = scene.point_mask.cpu().numpy()
    reg = scene.cam_mask.cpu().numpy()
    R = scene.rotations().cpu().numpy()[reg]
    centers = scene.camera_centers().cpu().numpy()[reg]
    cols = scene.colors.cpu().numpy()[pm] if scene.colors is not None else None
    return write_viewer_html(
        path, scene.points.cpu().numpy()[pm], cols,
        cam_rotations=R, cam_centers=centers, title=title)
