"""Live plan-in-the-loop viewer: the interactive MJPC app analog.

Counterpart of humanoid_mujoco_tpu/viz/live.py. The reference GUI runs
physics and async plan threads with live cost-term plots, planner
timers, weight sliders and mouse perturbations (mjpc/app.cc:209-496,
agent.cc Plots; GUI sliders mutate agent fields live,
sampling/planner.cc:437-461). This is that surface for a headless box:
a background physics loop steps the sim (serving/realtime_eval.py's
RobotProxy: the plain step on the CPU in a process of its own) under actions from the
continuously replanning AsyncAgent (native/async_agent.py, planning on
the agent's device, the card by default), and a browser page polls a
snapshot endpoint to draw the robot live, plot cost terms, show plans/s
and control Hz, adjust weights (sliders -> AsyncAgent.submit, applied
on the plan thread), and push the robot (buttons and canvas clicks ->
xfrc impulses, the app.cc mouse-perturb analog).

Run: python -m humanoid_mujoco_torch.viz.viewer --live \\
         --task "Humanoid Cap Stand"
"""

from __future__ import annotations

import http.server
import json
import threading
import time

import numpy as np
import torch

_PUSH_SECONDS = 0.2        # impulse duration per perturb request


class LiveSession:
    """Physics loop + async plan loop + snapshot state for the page."""

    def __init__(self, task_name: str = "Humanoid Cap Stand",
                 planner: str = "sampling", nsample: int = 64,
                 horizon: int = 17, control_hz: float = 50.0,
                 realtime: bool = True, seed: int = 0, device=None):
        from .. import resolve_device
        from ..agent import Agent
        from ..native.async_agent import AsyncAgent
        from ..tasks import registry

        self.task_name = task_name
        self.control_hz = control_hz
        self.realtime = realtime
        dev = resolve_device(device)
        m = registry.task_model(task_name, device=dev)
        task = registry.get_task(task_name, device=dev)
        agent = Agent(m, task, planner=planner, nsample=nsample,
                      horizon=horizon, seed=seed)
        agent.set_state(qpos=registry.home_qpos(task_name, m))
        self.agent = agent
        self.aa = AsyncAgent(agent)
        self.m = m
        # the sim: the plain step on the CPU in a process of its own
        # (serving/realtime_eval.py's RobotProxy), started by start()
        self._sub = max(1, int(round(1.0 / control_hz / float(m.dt))))
        self.robot = None
        self._state = None      # the latest observation

        # shared snapshot (lock-protected; read by the HTTP thread)
        self._lock = threading.Lock()
        self._snap = dict(t=0.0, spheres=[], cost=0.0, terms={},
                          control_hz=0.0, plans_per_s=0.0)
        self._push = np.zeros(3)
        self._push_until = 0.0
        self._run = False
        self._thread = None
        self.error = None

        # static scene metadata for the page
        self.meta = dict(
            task=task_name, planner=planner,
            radii=m.sph_radius.double().cpu().numpy().tolist(),
            bodies=[int(b) for b in m.struct.sph_body],
            floor_z=float(m.floor_z),
            terms=[t.name for t in task.terms],
            weights={t.name: float(task.weights[i])
                     for i, t in enumerate(task.terms)},
        )

    # ---- GUI verbs ----
    def set_weight(self, name: str, value: float):
        """Slider -> plan thread (sampling/planner.cc:437-461 analog)."""
        self.meta["weights"][name] = float(value)
        self.aa.submit(lambda a: a.set_cost_weights({name: value}))

    def perturb(self, force_xyz):
        """Queue a world-frame push on the heaviest body for
        `_PUSH_SECONDS` (app.cc mouse perturbation analog)."""
        with self._lock:
            self._push = np.asarray(force_xyz, dtype=float)
            self._push_until = time.monotonic() + _PUSH_SECONDS

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._snap)

    # ---- physics loop ----
    def _loop(self):
        try:
            self._physics()
        except Exception as e:     # noqa: BLE001, kept for stop()
            self.error = e

    def _physics(self):
        m, aa, robot = self.m, self.aa, self.robot
        period = 1.0 / self.control_hz
        zeros6 = np.zeros((m.struct.nbody, 6))
        # the push lands on the body with the most mass
        root = int(torch.argmax(m.body_mass))
        t0 = time.monotonic()
        n = 0
        iters0 = aa.plan_iterations
        while self._run:
            o = robot.obs
            u = aa.get_action(o["qpos"], o["qvel"], o["time"])
            with self._lock:
                active = time.monotonic() < self._push_until
                push = self._push if active else None
            xfrc = zeros6
            if push is not None:
                xfrc = zeros6.copy()
                xfrc[root, :3] = push
            o = robot.step(u, xfrc)
            self._state = o
            aa.set_state(o["qpos"], o["qvel"], o["time"])
            n += 1
            wall = time.monotonic() - t0
            with self._lock:
                self._snap = dict(
                    t=o["time"],
                    spheres=np.round(o["centers"], 4).tolist(),
                    cost=float(o["terms"].sum()),
                    terms={name: float(o["terms"][i]) for i, name in
                           enumerate(self.meta["terms"])},
                    control_hz=round(n / max(wall, 1e-9), 1),
                    plans_per_s=round(
                        (aa.plan_iterations - iters0) / max(wall, 1e-9),
                        2),
                    push_active=bool(push is not None),
                )
            if self.realtime:
                sleep = n * period - (time.monotonic() - t0)
                if sleep > 0:
                    time.sleep(sleep)

    def start(self):
        # warm the plan path before the clock starts
        from ..serving.realtime_eval import RobotProxy
        self.agent.planner_step()
        self.robot = RobotProxy(self.task_name, self._sub)
        self._state = self.robot.obs
        self.aa.start()
        self._run = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        """Stop the physics loop, the robot proxy and the plan loop;
        re-raise a failure of either loop."""
        self._run = False
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self.robot is not None:
            self.robot.close()
        self.aa.stop()
        if self.error is not None:
            raise RuntimeError("the physics loop failed") from self.error


_LIVE_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>live MPC</title>
<style>
 body{margin:0;background:#1b1e23;color:#ddd;font:13px sans-serif;
      display:flex;height:100vh}
 #main{flex:1;display:flex;flex-direction:column;min-width:0}
 canvas#cv{flex:1;min-height:0}
 #panel{width:280px;padding:10px;background:#22262c;overflow-y:auto}
 .term{margin:6px 0}
 .bar{height:6px;background:#3cb371;border-radius:2px}
 input[type=range]{width:100%}
 button{background:#333;color:#ddd;border:1px solid #555;margin:2px;
        padding:3px 10px;border-radius:3px;cursor:pointer}
 #timers{opacity:.8;margin:8px 0;white-space:pre}
 canvas#plot{width:100%;height:70px;background:#1b1e23}
</style></head><body>
<div id="main">
 <div style="padding:6px 10px">__TASK__ &middot; live MPC &middot;
  drag: orbit &middot; wheel: zoom &middot; click robot: push</div>
 <canvas id="cv"></canvas>
</div>
<div id="panel">
 <div id="timers"></div>
 <canvas id="plot"></canvas>
 <div><b>push</b><br>
  <button onclick="push(30,0)">+X</button>
  <button onclick="push(-30,0)">-X</button>
  <button onclick="push(0,30)">+Y</button>
  <button onclick="push(0,-30)">-Y</button>
 </div>
 <div id="terms"></div>
</div>
<script>
const META = __META__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let cam = {az:135, el:-15, dist:1.6, look:[0,0,0], fov:45};
let S = null; const hist = [];
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
const PAL = ['#cb4c3c','#daa520','#3cb371','#9b59b6','#3b97a7',
             '#c0392b','#46698c'];
function draw(){
 if(!S) return;
 const w = cv.width = cv.clientWidth*devicePixelRatio,
       h = cv.height = cv.clientHeight*devicePixelRatio;
 ctx.fillStyle = '#23272e'; ctx.fillRect(0,0,w,h);
 const pts = S.spheres; if(!pts.length) return;
 let mx=0,my=0; for(const p of pts){mx+=p[0];my+=p[1];}
 cam.look[0]=mx/pts.length; cam.look[1]=my/pts.length;
 const P = pose(), f = 0.5*h/Math.tan(0.5*cam.fov*Math.PI/180),
       cx=w/2, cy=h/2;
 const tile=0.25, n=10,
       x0=Math.floor(cam.look[0]/tile)*tile,
       y0=Math.floor(cam.look[1]/tile)*tile;
 for(let i=-n;i<n;i++) for(let j=-n;j<n;j++){
  const xa=x0+i*tile, ya=y0+j*tile;
  const q=[[xa,ya],[xa+tile,ya],[xa+tile,ya+tile],[xa,ya+tile]]
    .map(([x,y])=>proj([x,y,META.floor_z],P,f,cx,cy));
  if(q.some(p=>p[2]<=1e-3)) continue;
  ctx.fillStyle=(i+j)%2==0?'#3a4049':'#31363e';
  ctx.beginPath(); ctx.moveTo(q[0][0],q[0][1]);
  for(let k=1;k<4;k++) ctx.lineTo(q[k][0],q[k][1]);
  ctx.closePath(); ctx.fill();
 }
 const order = pts.map((p,i)=>[proj(p,P,f,cx,cy),i])
                  .sort((a,b)=>b[0][2]-a[0][2]);
 for(const [pp,i] of order){
  if(pp[2]<=1e-3) continue;
  const r = Math.max(1, f*META.radii[i]/pp[2]);
  ctx.fillStyle = PAL[META.bodies[i]%PAL.length];
  ctx.beginPath(); ctx.arc(pp[0],pp[1],r,0,7); ctx.fill();
  ctx.strokeStyle='rgba(0,0,0,.4)'; ctx.stroke();
 }
 if(S.push_active){
  ctx.fillStyle='#e74c3c';
  ctx.font = (16*devicePixelRatio)+'px sans-serif';
  ctx.fillText('PUSH', 20, 30*devicePixelRatio);
 }
}
function drawPlot(){
 const pc = document.getElementById('plot'),
       c2 = pc.getContext('2d');
 const w = pc.width = pc.clientWidth*devicePixelRatio,
       h = pc.height = pc.clientHeight*devicePixelRatio;
 c2.fillStyle='#1b1e23'; c2.fillRect(0,0,w,h);
 if(hist.length<2) return;
 const mx = Math.max(...hist)*1.1 || 1;
 c2.strokeStyle='#3cb371'; c2.beginPath();
 hist.forEach((v,i)=>{
  const x=i/(hist.length-1)*w, y=h-(v/mx)*h;
  i?c2.lineTo(x,y):c2.moveTo(x,y);});
 c2.stroke();
 c2.fillStyle='#888';
 c2.font=(10*devicePixelRatio)+'px sans-serif';
 c2.fillText('cost '+hist[hist.length-1].toFixed(3), 4,
             10*devicePixelRatio);
}
function buildPanel(){
 const el = document.getElementById('terms');
 el.innerHTML = '<b>cost terms / weights</b>';
 for(const name of META.terms){
  const d = document.createElement('div'); d.className='term';
  d.innerHTML = `<div>${name}: <span id="v_${name}">0</span></div>
   <div class="bar" id="b_${name}" style="width:0%"></div>
   <input type="range" min="0" max="${Math.max(
       META.weights[name]*4, 1)}" step="0.01"
    value="${META.weights[name]}" id="w_${name}">`;
  el.appendChild(d);
  d.querySelector('input').oninput = e => fetch('/set_weight', {
    method:'POST', body: JSON.stringify(
        {name: name, value: parseFloat(e.target.value)})});
 }
}
async function poll(){
 try{
  const r = await fetch('/state.json'); S = await r.json();
  hist.push(S.cost); if(hist.length>300) hist.shift();
  document.getElementById('timers').textContent =
   `t        ${S.t.toFixed(2)} s\\ncontrol  ${S.control_hz} Hz\\n` +
   `plans    ${S.plans_per_s} /s`;
  for(const [k,v] of Object.entries(S.terms)){
   const vv=document.getElementById('v_'+k),
         bb=document.getElementById('b_'+k);
   if(vv){vv.textContent=v.toFixed(4);
          bb.style.width=Math.min(100, v/(S.cost||1)*100)+'%';}
  }
  draw(); drawPlot();
 }catch(e){}
 setTimeout(poll, 33);
}
function push(fx, fy){
 fetch('/perturb', {method:'POST',
   body: JSON.stringify({force:[fx, fy, 0]})});
}
cv.onclick = e => {
 // push in the horizontal camera-forward direction (click = shove)
 const az = cam.az*Math.PI/180;
 push(Math.round(30*Math.cos(az)), Math.round(30*Math.sin(az)));
};
let drag=null;
cv.onmousedown = e => drag={x:e.clientX,y:e.clientY};
window.onmouseup = () => drag=null;
window.onmousemove = e => {
 if(!drag) return;
 const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
 if(Math.abs(dx)+Math.abs(dy)>2){
  cam.az -= dx*0.4; cam.el = Math.min(85,Math.max(-85,cam.el-dy*0.4));
  drag={x:e.clientX,y:e.clientY};
 }
};
cv.onwheel = e => { e.preventDefault();
 cam.dist = Math.min(20, Math.max(0.2, cam.dist*(1+e.deltaY*0.001))); };
buildPanel(); poll();
</script></body></html>
"""


def serve_live(session: LiveSession, port: int = 8000,
               block: bool = True, host: str = "127.0.0.1"):
    """Host the live page and the snapshot and verb endpoints."""
    page = (_LIVE_PAGE
            .replace("__META__", json.dumps(session.meta))
            .replace("__TASK__", session.task_name)).encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, body, ctype="application/json"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/state.json"):
                self._send(json.dumps(session.snapshot()).encode())
            elif self.path.startswith("/meta.json"):
                self._send(json.dumps(session.meta).encode())
            else:
                self._send(page, "text/html")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if self.path.startswith("/set_weight"):
                session.set_weight(body["name"], float(body["value"]))
            elif self.path.startswith("/perturb"):
                session.perturb(body.get("force", [0, 0, 0]))
            self._send(b"{}")

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer((host, port), Handler)
    if block:
        print(f"live viewer at http://{host}:{srv.server_address[1]}/")
        try:
            srv.serve_forever()
        finally:
            session.stop()
    else:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
