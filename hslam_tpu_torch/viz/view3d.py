"""Live 3D map viewer: WebGL point clouds + frusta + trajectory (a copy of
hslam_tpu/viz/view3d.py; stdlib only, over the metrics stream that
`hslam_tpu_torch.models.system.SLAMSystem(metrics_path=...)` writes with the
JAX package's record schema).

Capability equivalent of the reference's Pangolin 3D view
(reference: Src/Display.cpp:333-441 — per-keyframe GL point clouds
refreshed on change, camera frusta, full trajectory, follow camera;
GUI::UploadKeyFrame, Include/Display.h:126-141). Instead of an OpenGL
window on the host, the live map is streamed out-of-process: the system
writes "map"/"frame" records to its metrics JSONL, and `MapServer`
serves a self-contained WebGL page (zero external assets) that polls the
stream and re-renders. Works over SSH port-forwarding, needs no GUI
stack in the SLAM process, and the JSONL doubles as a replayable map log.

Usage:
    srv = MapServer("/path/run.jsonl", port=8642)
    srv.start()          # -> http://localhost:8642
    ...
    srv.stop()

The page renders:
  * the decimated window point cloud, grey-scaled by intensity ("map"
    records; poses/depths refresh as BA updates them — RefreshPC
    semantics, Display.cpp:382-441);
  * camera frusta for the active window keyframes (worldToCam R, t in
    the record; inverted client-side);
  * the full trajectory polyline + current camera ("frame" records,
    keyframes marked);
  * drag = orbit, wheel = zoom, right-drag / shift-drag = pan,
    F = toggle follow-camera (SetPointOfView semantics, Display.cpp:250).
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

HTML_PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>hslam_tpu_torch live map</title>
<style>
 body{margin:0;background:#101014;color:#cfd2d6;font:12px monospace;overflow:hidden}
 #hud{position:absolute;top:8px;left:10px;pointer-events:none;white-space:pre}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud"></div><canvas id="gl"></canvas>
<script>
"use strict";
const canvas=document.getElementById("gl");
const gl=canvas.getContext("webgl",{antialias:true});
const hud=document.getElementById("hud");
const VS=`attribute vec3 aPos;attribute vec3 aCol;uniform mat4 uMVP;
uniform float uPtSize;varying vec3 vCol;
void main(){gl_Position=uMVP*vec4(aPos,1.0);gl_PointSize=uPtSize;vCol=aCol;}`;
const FS=`precision mediump float;varying vec3 vCol;
void main(){gl_FragColor=vec4(vCol,1.0);}`;
function mkShader(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
 gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
 throw gl.getShaderInfoLog(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,mkShader(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,mkShader(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const aPos=gl.getAttribLocation(prog,"aPos");
const aCol=gl.getAttribLocation(prog,"aCol");
const uMVP=gl.getUniformLocation(prog,"uMVP");
const uPtSize=gl.getUniformLocation(prog,"uPtSize");

// ---- tiny mat4 helpers (column-major) ----
function mat4Mul(a,b){const o=new Float32Array(16);
 for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s;}return o;}
function persp(fovy,asp,n,f){const t=1/Math.tan(fovy/2);
 return new Float32Array([t/asp,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1,
  0,0,2*f*n/(n-f),0]);}
function lookAt(eye,ctr,up){
 let z=[eye[0]-ctr[0],eye[1]-ctr[1],eye[2]-ctr[2]];
 const zl=Math.hypot(...z);z=z.map(v=>v/zl);
 let x=[up[1]*z[2]-up[2]*z[1],up[2]*z[0]-up[0]*z[2],up[0]*z[1]-up[1]*z[0]];
 const xl=Math.hypot(...x)||1;x=x.map(v=>v/xl);
 const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
 return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0,
  x[2],y[2],z[2],0, -(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),
  -(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
  -(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]),1]);}

// ---- state from the stream ----
let cloud=new Float32Array(0), cloudCol=new Float32Array(0);
let frusta=new Float32Array(0);           // line list
let traj=[], trajKf=[], cur=[0,0,0];
let nextOffset=0, nFrames=0, nKfs=0, nLoops=0;

// camera
let yaw=-0.8,pitch=0.5,dist=4.0,target=[0,0,1],follow=true;
canvas.addEventListener("mousedown",e=>{
 const pan=e.button===2||e.shiftKey;const sx=e.clientX,sy=e.clientY;
 const y0=yaw,p0=pitch,t0=target.slice();
 function mv(ev){const dx=ev.clientX-sx,dy=ev.clientY-sy;
  if(pan){const s=dist*0.002;
   target=[t0[0]-dx*s*Math.cos(y0)-dy*s*Math.sin(y0)*Math.sin(p0),
           t0[1]-dy*s*Math.cos(p0),
           t0[2]+dx*s*Math.sin(y0)-dy*s*Math.cos(y0)*Math.sin(p0)];
   follow=false;}
  else{yaw=y0+dx*0.008;pitch=Math.max(-1.5,Math.min(1.5,p0+dy*0.008));}}
 function up(){window.removeEventListener("mousemove",mv);
  window.removeEventListener("mouseup",up);}
 window.addEventListener("mousemove",mv);window.addEventListener("mouseup",up);});
canvas.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*0.001);
 dist=Math.max(0.2,Math.min(100,dist));e.preventDefault();});
canvas.addEventListener("contextmenu",e=>e.preventDefault());
window.addEventListener("keydown",e=>{if(e.key==="f"||e.key==="F")follow=!follow;});

function frustumLines(R,t,scale){
 // R,t are worldToCam; invert: C = -R^T t, dirs = R^T * corner
 const Rt=[[R[0],R[3],R[6]],[R[1],R[4],R[7]],[R[2],R[5],R[8]]];
 const C=[-(Rt[0][0]*t[0]+Rt[0][1]*t[1]+Rt[0][2]*t[2]),
          -(Rt[1][0]*t[0]+Rt[1][1]*t[1]+Rt[1][2]*t[2]),
          -(Rt[2][0]*t[0]+Rt[2][1]*t[1]+Rt[2][2]*t[2])];
 const s=scale;const corners=[[-s,-s*0.75,s*1.5],[s,-s*0.75,s*1.5],
  [s,s*0.75,s*1.5],[-s,s*0.75,s*1.5]].map(c=>[
   C[0]+Rt[0][0]*c[0]+Rt[0][1]*c[1]+Rt[0][2]*c[2],
   C[1]+Rt[1][0]*c[0]+Rt[1][1]*c[1]+Rt[1][2]*c[2],
   C[2]+Rt[2][0]*c[0]+Rt[2][1]*c[1]+Rt[2][2]*c[2]]);
 const L=[];
 for(let i=0;i<4;i++){L.push(C,corners[i]);L.push(corners[i],corners[(i+1)%4]);}
 return L;}

async function poll(){
 try{
  const r=await fetch("/data?from="+nextOffset);
  const j=await r.json();
  nextOffset=j.next;
  for(const rec of j.records){
   if(rec.t==="frame"){traj.push(rec.p);cur=rec.p;nFrames++;
    if(rec.kf)trajKf.push(rec.p);}
   else if(rec.t==="kf"){nKfs++;}
   else if(rec.t==="loop"){nLoops++;}
   else if(rec.t==="map"){
    const n=rec.pts.length;
    cloud=new Float32Array(n*3);cloudCol=new Float32Array(n*3);
    for(let i=0;i<n;i++){const p=rec.pts[i];
     cloud[3*i]=p[0];cloud[3*i+1]=p[1];cloud[3*i+2]=p[2];
     const c=(p[3]||180)/255;
     cloudCol[3*i]=0.35+0.6*c;cloudCol[3*i+1]=0.5+0.45*c;cloudCol[3*i+2]=0.4+0.3*c;}
    const L=[];
    for(const k of rec.kfs)L.push(...frustumLines(k.R,k.t,0.08));
    frusta=new Float32Array(L.length*3);
    L.forEach((p,i)=>{frusta[3*i]=p[0];frusta[3*i+1]=p[1];frusta[3*i+2]=p[2];});
   }
  }
 }catch(e){}
 setTimeout(poll,400);}
poll();

const bufP=gl.createBuffer(),bufC=gl.createBuffer(),
      bufL=gl.createBuffer(),bufLC=gl.createBuffer();
function draw(){
 const w=canvas.clientWidth,h=canvas.clientHeight;
 if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
 gl.viewport(0,0,w,h);gl.clearColor(0.063,0.063,0.078,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);gl.enable(gl.DEPTH_TEST);
 if(follow)target=[cur[0],cur[1],cur[2]];
 const eye=[target[0]+dist*Math.sin(yaw)*Math.cos(pitch),
            target[1]+dist*Math.sin(pitch),
            target[2]-dist*Math.cos(yaw)*Math.cos(pitch)];
 const mvp=mat4Mul(persp(0.9,w/h,0.01,500),lookAt(eye,target,[0,-1,0]));
 gl.uniformMatrix4fv(uMVP,false,mvp);
 gl.enableVertexAttribArray(aPos);gl.enableVertexAttribArray(aCol);
 function drawArr(pos,col,mode,ptsz){
  if(pos.length===0)return;
  gl.bindBuffer(gl.ARRAY_BUFFER,bufP);
  gl.bufferData(gl.ARRAY_BUFFER,pos,gl.DYNAMIC_DRAW);
  gl.vertexAttribPointer(aPos,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,bufC);
  gl.bufferData(gl.ARRAY_BUFFER,col,gl.DYNAMIC_DRAW);
  gl.vertexAttribPointer(aCol,3,gl.FLOAT,false,0,0);
  gl.uniform1f(uPtSize,ptsz);gl.drawArrays(mode,0,pos.length/3);}
 // point cloud
 drawArr(cloud,cloudCol,gl.POINTS,2.0);
 // frusta (cyan lines)
 if(frusta.length){const fc=new Float32Array(frusta.length);
  for(let i=0;i<frusta.length;i+=3){fc[i]=0.2;fc[i+1]=0.8;fc[i+2]=0.9;}
  drawArr(frusta,fc,gl.LINES,1);}
 // trajectory polyline (orange)
 if(traj.length>1){const tp=new Float32Array((traj.length)*3),
  tc=new Float32Array(traj.length*3);
  traj.forEach((p,i)=>{tp[3*i]=p[0];tp[3*i+1]=p[1];tp[3*i+2]=p[2];
   tc[3*i]=0.95;tc[3*i+1]=0.6;tc[3*i+2]=0.2;});
  drawArr(tp,tc,gl.LINE_STRIP,1);}
 // keyframe markers (red points) + current camera (white)
 if(trajKf.length){const kp=new Float32Array(trajKf.length*3),
  kc=new Float32Array(trajKf.length*3);
  trajKf.forEach((p,i)=>{kp[3*i]=p[0];kp[3*i+1]=p[1];kp[3*i+2]=p[2];
   kc[3*i]=0.95;kc[3*i+1]=0.25;kc[3*i+2]=0.25;});
  drawArr(kp,kc,gl.POINTS,5.0);}
 drawArr(new Float32Array(cur),new Float32Array([1,1,1]),gl.POINTS,8.0);
 hud.textContent=`frames ${nFrames}  kfs ${nKfs}  loops ${nLoops}  `+
  `cloud ${cloud.length/3} pts   [drag orbit / wheel zoom / F follow:${follow?"on":"off"}]`;
 requestAnimationFrame(draw);}
requestAnimationFrame(draw);
</script></body></html>
"""


class MapServer:
    """Serves the live-map page + incremental JSONL reads.

    GET /            -> the WebGL page
    GET /data?from=N -> {"next": byte_offset, "records": [parsed JSONL
                         records from byte N on]} (only complete lines)
    """

    def __init__(self, jsonl_path: str, port: int = 8642,
                 host: str = "127.0.0.1"):
        self.jsonl_path = jsonl_path
        self.port = port
        self.host = host
        self._httpd = None
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def read_records(self, offset: int):
        """Complete JSONL records from byte `offset`; returns
        (records, next_offset). Skips records that fail to parse
        (truncated tail lines stay pending until complete)."""
        records = []
        next_off = offset
        try:
            with open(self.jsonl_path, "rb") as f:
                f.seek(offset)
                data = f.read()
        except OSError:
            return records, next_off
        end = data.rfind(b"\n")
        if end < 0:
            return records, next_off
        for line in data[: end + 1].splitlines():
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                pass
        next_off = offset + end + 1
        return records, next_off

    def start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # quiet
                pass

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path == "/":
                    body = HTML_PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif parsed.path == "/data":
                    q = parse_qs(parsed.query)
                    off = int(q.get("from", ["0"])[0])
                    records, nxt = server.read_records(off)
                    body = json.dumps(
                        {"next": nxt, "records": records}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]   # resolve port 0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
