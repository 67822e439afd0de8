"""Interactive trajectory/policy viewer: the GUI-app analog.

Counterpart of humanoid_mujoco_tpu/viz/viewer.py. The reference's
interactive surfaces are the GLFW MJPC app (mujoco_mpc/mjpc/app.cc)
and the MuJoCo viewer in its rl/visualize_policy.py. Without a GL
stack, interactivity moves to the browser: `export_html` writes
ONE self-contained HTML file — trajectory embedded as JSON, a canvas-2d
sphere renderer in vanilla JS (the same painter's-algorithm camera math
as viz/render.py), orbit/zoom with the mouse, play/pause/scrub/speed
controls. `serve` hosts it on localhost; the CLI rolls out a policy
checkpoint and opens the result, mirroring visualize_policy.py's loop.

No dependencies beyond the standard library, numpy and the port's
kinematics; works over SSH port-forwarding, survives being copied
anywhere (single file). `--live` runs the plan-in-the-loop surface
instead (viz/live.py: the physics loop on the CPU, the async plan loop
on `--device`, weight sliders and pushes).
"""

from __future__ import annotations

import argparse
import http.server
import json
import threading

import numpy as np

from ..physics.model import Model
from .render import hfield, to_host, world_centers


def trajectory_scene(m: Model, qpos_traj, dt: float | None = None,
                     stride: int = 1, name: str = "trajectory") -> dict:
    """Precompute per-frame world sphere centers for the JS renderer.

    qpos_traj: (T, nq). stride: keep every k-th frame (500 Hz control
    -> stride 10 gives 50 fps playback data)."""
    qpos_traj = np.asarray(qpos_traj)[::stride]
    frames = np.round(world_centers(m, qpos_traj), 4).tolist()
    hdata = hfield(m)
    return dict(
        name=name,
        dt=(float(m.dt) if dt is None else dt) * stride,
        radii=to_host(m.sph_radius).tolist(),
        bodies=[int(b) for b in m.struct.sph_body],
        floor_z=float(to_host(m.floor_z)),
        hfield=(hdata.tolist() if np.any(hdata) else None),
        hfield_halfsize=to_host(m.hfield_halfsize).tolist(),
        frames=frames,
    )


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>humanoid_mujoco_torch viewer</title>
<style>
 body{margin:0;background:#1b1e23;color:#ddd;font:13px sans-serif;
      display:flex;flex-direction:column;height:100vh}
 #bar{padding:6px 10px;display:flex;gap:10px;align-items:center}
 canvas{flex:1;min-height:0}
 input[type=range]{flex:1}
 button{background:#333;color:#ddd;border:1px solid #555;padding:3px 10px;
        border-radius:3px;cursor:pointer}
</style></head><body>
<div id="bar">
 <button id="play">&#9654;</button>
 <input type="range" id="scrub" min="0" value="0" step="1">
 <span id="t"></span>
 <label>speed <select id="speed">
  <option>0.1</option><option>0.25</option><option selected>1</option>
  <option>2</option></select></label>
 <span style="opacity:.6">drag: orbit &middot; wheel: zoom &middot;
  shift-drag: pan</span>
</div>
<canvas id="cv"></canvas>
<script>
const S = __SCENE__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const scrub = document.getElementById('scrub');
scrub.max = S.frames.length - 1;
let cam = {az:135, el:-15, dist:1.6, look:[0,0,-0.25], fov:45};
let frame = 0, playing = true, last = performance.now(), acc = 0;
const PAL = ['#cb4c3c','#daa520','#3cb371','#9b59b6','#3b97a7',
             '#c0392b','#46698c'];
function pose(){
 const az = cam.az*Math.PI/180, el = cam.el*Math.PI/180;
 const fwd = [Math.cos(el)*Math.cos(az), Math.cos(el)*Math.sin(az),
              Math.sin(el)];
 const eye = [cam.look[0]-cam.dist*fwd[0], cam.look[1]-cam.dist*fwd[1],
              cam.look[2]-cam.dist*fwd[2]];
 let right = [fwd[1], -fwd[0], 0];
 const nr = Math.hypot(...right) || 1; right = right.map(v=>-v/nr);
 const down = [fwd[1]*right[2]-fwd[2]*right[1],
               fwd[2]*right[0]-fwd[0]*right[2],
               fwd[0]*right[1]-fwd[1]*right[0]];
 return {R:[right, down, fwd], eye};
}
function proj(p, P, f, cx, cy){
 const d = [p[0]-P.eye[0], p[1]-P.eye[1], p[2]-P.eye[2]];
 const x = d[0]*P.R[0][0]+d[1]*P.R[0][1]+d[2]*P.R[0][2];
 const y = d[0]*P.R[1][0]+d[1]*P.R[1][1]+d[2]*P.R[1][2];
 const z = d[0]*P.R[2][0]+d[1]*P.R[2][1]+d[2]*P.R[2][2];
 return [cx + f*x/Math.max(z,1e-6), cy + f*y/Math.max(z,1e-6), z];
}
function hz(x, y){
 if (!S.hfield) return S.floor_z;
 const H = S.hfield, nr = H.length, nc = H[0].length;
 const gx = Math.min(Math.max((x/S.hfield_halfsize[0]+1)*0.5*(nc-1),0),
                     nc-1.001);
 const gy = Math.min(Math.max((y/S.hfield_halfsize[1]+1)*0.5*(nr-1),0),
                     nr-1.001);
 const i=Math.floor(gy), j=Math.floor(gx), fy=gy-i, fx=gx-j;
 return S.floor_z + H[i][j]*(1-fx)*(1-fy)+H[i][j+1]*fx*(1-fy)
        +H[i+1][j]*(1-fx)*fy+H[i+1][j+1]*fx*fy;
}
function draw(){
 const w = cv.width = cv.clientWidth*devicePixelRatio,
       h = cv.height = cv.clientHeight*devicePixelRatio;
 ctx.fillStyle = '#23272e'; ctx.fillRect(0,0,w,h);
 const pts = S.frames[frame];
 // track the centroid in x/y like the reference viewer
 let mx=0,my=0; for(const p of pts){mx+=p[0];my+=p[1];}
 cam.look[0]=mx/pts.length; cam.look[1]=my/pts.length;
 const P = pose(), f = 0.5*h/Math.tan(0.5*cam.fov*Math.PI/180),
       cx=w/2, cy=h/2;
 // floor checkerboard
 const tile=0.25, n=10,
       x0=Math.floor(cam.look[0]/tile)*tile,
       y0=Math.floor(cam.look[1]/tile)*tile;
 for(let i=-n;i<n;i++) for(let j=-n;j<n;j++){
  const xa=x0+i*tile, ya=y0+j*tile;
  const q=[[xa,ya],[xa+tile,ya],[xa+tile,ya+tile],[xa,ya+tile]]
    .map(([x,y])=>proj([x,y,hz(x,y)],P,f,cx,cy));
  if(q.some(p=>p[2]<=1e-3)) continue;
  ctx.fillStyle=(i+j)%2==0?'#3a4049':'#31363e';
  ctx.beginPath(); ctx.moveTo(q[0][0],q[0][1]);
  for(let k=1;k<4;k++) ctx.lineTo(q[k][0],q[k][1]);
  ctx.closePath(); ctx.fill();
 }
 // spheres far -> near
 const order = pts.map((p,i)=>[proj(p,P,f,cx,cy),i])
                  .sort((a,b)=>b[0][2]-a[0][2]);
 for(const [pp,i] of order){
  if(pp[2]<=1e-3) continue;
  const r = Math.max(1, f*S.radii[i]/pp[2]);
  ctx.fillStyle = PAL[S.bodies[i]%PAL.length];
  ctx.beginPath(); ctx.arc(pp[0],pp[1],r,0,7); ctx.fill();
  ctx.strokeStyle='rgba(0,0,0,.4)'; ctx.stroke();
 }
 document.getElementById('t').textContent =
   (frame*S.dt).toFixed(2)+' s / '+((S.frames.length-1)*S.dt).toFixed(2)+' s';
 scrub.value = frame;
}
function tick(now){
 const speed = parseFloat(document.getElementById('speed').value);
 if(playing){
  acc += (now-last)/1000*speed;
  while(acc >= S.dt){ acc -= S.dt; frame=(frame+1)%S.frames.length; }
 }
 last = now; draw(); requestAnimationFrame(tick);
}
document.getElementById('play').onclick = e => {
 playing = !playing; e.target.innerHTML = playing?'&#10074;&#10074;':'&#9654;';
};
document.getElementById('play').innerHTML='&#10074;&#10074;';
scrub.oninput = e => { playing=false; frame=parseInt(e.target.value); };
let drag=null;
cv.onmousedown = e => drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};
window.onmouseup = () => drag=null;
window.onmousemove = e => {
 if(!drag) return;
 const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
 if(drag.shift){ cam.look[2] += dy*0.003*cam.dist; }
 else { cam.az -= dx*0.4; cam.el = Math.min(85,Math.max(-85,cam.el-dy*0.4)); }
 drag={x:e.clientX,y:e.clientY,shift:drag.shift};
};
cv.onwheel = e => { e.preventDefault();
 cam.dist = Math.min(20, Math.max(0.2, cam.dist*(1+e.deltaY*0.001))); };
requestAnimationFrame(tick);
</script></body></html>
"""


def export_html(scene: dict, path: str) -> str:
    """Write the self-contained interactive viewer page."""
    with open(path, "w") as f:
        f.write(_PAGE.replace("__SCENE__", json.dumps(scene)))
    return path


def serve(scene: dict, port: int = 8000, block: bool = True):
    """Host the viewer at http://127.0.0.1:port/ (visualize_policy.py's
    `viewer.launch` analog for a headless box)."""
    page = _PAGE.replace("__SCENE__", json.dumps(scene)).encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(page)))
            self.end_headers()
            self.wfile.write(page)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    if block:
        print(f"viewer at http://127.0.0.1:{srv.server_address[1]}/")
        srv.serve_forever()
    else:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
    return srv


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Interactive policy viewer (rl/visualize_policy.py "
                    "analog): rolls out a checkpoint and serves/exports "
                    "an orbit-camera playback page; --live runs the "
                    "plan-in-the-loop MPC surface (the mjpc app analog).")
    ap.add_argument("--ckpt", default=None, help="policy checkpoint "
                    "(None = zero-torque rollout)")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rand", type=float, default=0.0)
    ap.add_argument("--out", default=None, help="write standalone HTML "
                    "here instead of serving")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default=None)
    ap.add_argument("--live", action="store_true",
                    help="live MPC: physics + async plan loop with "
                         "weight sliders and pushes (app.cc:209-496)")
    ap.add_argument("--task", default="Humanoid Cap Stand")
    ap.add_argument("--planner", default="sampling")
    ap.add_argument("--nsample", type=int, default=64)
    ap.add_argument("--hz", type=float, default=50.0)
    a = ap.parse_args(argv)

    if a.live:
        from .live import LiveSession, serve_live
        session = LiveSession(task_name=a.task, planner=a.planner,
                              nsample=a.nsample, control_hz=a.hz,
                              device=a.device)
        session.start()
        serve_live(session, port=a.port)
        return

    from ..rl.videos import record_episode
    m, traj = record_episode(a.ckpt, seconds=a.seconds,
                             randomization_factor=a.rand, device=a.device)
    scene = trajectory_scene(m, traj, dt=0.002, stride=10)
    if a.out:
        print(export_html(scene, a.out))
    else:
        serve(scene, port=a.port)


if __name__ == "__main__":
    main()
