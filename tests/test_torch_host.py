"""Port parity: the host surface (native runtime, AsyncAgent, the async
server, realtime eval, the live viewer, profiling, the gRPC servers)
against the JAX package's tests of the same modules.

On the CPU, float64 where a number is compared (ParticleFixed, or the
cap humanoid at nsample <= 8 and horizon <= 8); tolerances are max-abs
error:

- the native runtime: the scenarios of tests/test_native.py (the pool's
  count and wait, a concurrent snapshot's consistency, the policy swap,
  the loop's stop) on the port's own build of runtime.cpp, which lands
  under build/native/; a plan-loop exception kept and re-raised by
  stop();
- `AsyncAgent`: hand-driven `_plan_once` calls with injected noise (the
  sampling planner on the humanoid, iLQG on ParticleFixed) against a
  synchronous port Agent on the same states and noise (which
  tests/test_torch_serving.py and test_torch_ilqg.py hold to JAX): the
  published policy equal to the bit, `get_action` at 1e-12; a threaded
  second on ParticleFixed: iterations, a `submit` applied by the plan
  thread, an injected plan exception re-raised by `get_action`,
  `plan_iterations` and `stop()`;
- `MPCServer(async_mode=True)`: TCP round trips, with and without the
  EKF, replies of 12 finite floats from the published policy;
- `realtime_eval.run(realtime=False)` returns the JAX module's keys;
  `LiveSession` passes the steps of tests/test_viewer.py's live test;
  `StageTimers` and `trace_to`;
- gRPC: the port's agent, filter and direct servers, spawned with
  `--device cpu`, answer every verb of tests/test_grpc.py and
  tests/test_grpc_estimation.py equal to the same verbs on in-process
  port objects (1e-12; the agent's float32 to the bit); the JAX
  package's `GrpcAgent(address=...)` drives the port's server through
  a state round trip (the wire is shared; no JAX planner compiles);
- Humanoid Track's clips: the port's file has the JAX file's sha256.

tests/test_torch_port.py runs these checks as the port's one collected
test; no JAX reference process is needed.
"""

import hashlib
import json
import os
import pickle
import socket
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from humanoid_mujoco_torch import native
from humanoid_mujoco_torch.agent import Agent
from humanoid_mujoco_torch.native.async_agent import AsyncAgent
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.serving import MPCServer
from humanoid_mujoco_torch.tasks import task_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
F64 = torch.float64


def particle(planner="sampling", dtype=F64, dt=0.01, **kw):
    m = task_model("ParticleFixed", device="cpu", dtype=dtype, dt=dt)
    return Agent(m, "ParticleFixed", planner=planner, **kw)


def humanoid_agent(**kw):
    m = th.build_humanoid(dtype=F64, device="cpu")
    return Agent(m, "Humanoid Cap Stand", **kw)


# ---------------------------------------------------------------------------
# the native runtime (tests/test_native.py's scenarios)
# ---------------------------------------------------------------------------

def check_native_build():
    so = native.library_path()
    native.load()
    assert so.exists() and so.parent == ROOT / "build" / "native", so
    assert not (ROOT / "humanoid_mujoco_torch" / "native"
                / "libhmt_runtime.so").exists()


def check_thread_pool():
    tp = native.NativeThreadPool(4)
    results, lock = [], threading.Lock()
    for i in range(20):
        def fn(i=i):
            with lock:
                results.append(i * i)
        tp.schedule(fn)
    tp.wait_count(20)
    assert sorted(results) == [i * i for i in range(20)]
    tp.reset_count()
    assert tp.count == 0
    tp.close()


def check_state_store():
    ss = native.NativeStateStore(19, 18)
    qp = np.arange(19, dtype=np.float64)
    qv = np.arange(18, dtype=np.float64) * 0.1
    v0 = ss.version
    ss.set(qp, qv, 1.25)
    qp2, qv2, t = ss.get()
    np.testing.assert_array_equal(qp2, qp)
    np.testing.assert_array_equal(qv2, qv)
    assert t == 1.25 and ss.version == v0 + 1
    ss.close()
    # concurrent readers never see a torn snapshot
    ss = native.NativeStateStore(4, 4)
    stop, bad = threading.Event(), []

    def writer():
        i = 0
        while not stop.is_set():
            v = np.full(4, float(i))
            ss.set(v, v, float(i))
            i += 1

    def reader():
        while not stop.is_set():
            qp, qv, _ = ss.get()
            if not (qp == qp[0]).all() or not (qv == qp[0]).all():
                bad.append((qp.copy(), qv.copy()))
    ths = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(2)]
    for t in ths:
        t.start()
    time.sleep(0.3)
    stop.set()
    for t in ths:
        t.join()
    assert not bad


def check_policy_buffer():
    pb = native.NativePolicyBuffer()
    assert pb.read() is None
    pb.publish(b"hello-policy")
    assert pb.read() == b"hello-policy"
    pb.publish(b"v2")
    assert pb.read() == b"v2" and pb.version == 2
    pb.close()


def check_agent_loop():
    loop = native.NativeAgentLoop()
    counter = dict(n=0)

    def plan_once():
        counter["n"] += 1
        time.sleep(0.001)
        return False
    loop.start(plan_once)
    time.sleep(0.3)
    loop.stop()
    assert counter["n"] > 10 and loop.iterations == counter["n"]
    loop = native.NativeAgentLoop()
    loop.start(lambda: True)        # stops after one iteration
    time.sleep(0.2)
    assert loop.iterations == 1
    loop.close()
    # an exception stops the loop and is re-raised by stop()
    loop = native.NativeAgentLoop()

    def fails():
        raise KeyError("plan failed")
    loop.start(fails)
    time.sleep(0.2)
    assert loop.iterations == 1 and isinstance(loop.error, KeyError)
    with pytest.raises(RuntimeError) as e:
        loop.stop()
    assert isinstance(e.value.__cause__, KeyError)
    loop.close()


# ---------------------------------------------------------------------------
# AsyncAgent
# ---------------------------------------------------------------------------

def _leaves(pstate):
    if hasattr(pstate, "policy"):
        p = pstate.policy
        return [p.times, p.qpos_nom, p.qvel_nom, p.u_nom, p.K, p.k_scale,
                pstate.reg]
    return [pstate.times, pstate.values]


def _hand_driven(make, planner, iters, nq, nv, seed):
    a1, a2 = make(), make()
    aa = AsyncAgent(a1)
    rng = np.random.default_rng(seed)
    q0 = a1.get_state()["qpos"]
    for i in range(iters):
        q = q0 + 0.02 * rng.standard_normal(nq)
        if nq == 19:
            q[:7] = q0[:7]
        v = 0.1 * rng.standard_normal(nv)
        t = 0.01 * i
        noise = None
        if planner != "ilqg":
            noise = torch.tensor(rng.standard_normal(
                (a1.cfg.nsample, a1.cfg.nknots, a1.model.nu)), dtype=F64)
        aa.set_state(q, v, t)
        aa._plan_once(noise=noise)
        a2.set_state(qpos=q, qvel=v, time=t)
        a2.planner_step(noise=noise)
        pub = pickle.loads(aa.policy_buf.read())
        for x, y in zip(_leaves(pub), _leaves(a2.pstate)):
            assert torch.equal(x, y), (planner, i)
        for tq in (t, t + 0.013):
            u1 = aa.get_action(q, v, tq)
            u2 = a2.get_action(time=tq)
            assert np.max(np.abs(u1 - u2)) <= 1e-12, (planner, u1, u2)
    assert aa.plan_iterations == 0       # the loop never started
    return aa


def check_async_hand_driven():
    def hum():
        a = humanoid_agent(planner="sampling", nsample=8, horizon=5)
        a.set_state(qpos=th.stand_qpos(a.model))
        return a
    aa = _hand_driven(hum, "sampling", 3, 19, 18, seed=1)
    assert aa._ctl_model.device.type == "cpu"
    _hand_driven(lambda: particle("ilqg", horizon=8), "ilqg", 2, 2, 2,
                 seed=2)


def check_async_threads():
    a = particle(nsample=8, horizon=8)
    aa = AsyncAgent(a)
    aa.set_state([0.1, -0.2], [0.0, 0.0], 0.0)
    aa.start()
    deadline = time.time() + 60
    while aa.plan_iterations < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert aa.plan_iterations >= 3
    u = aa.get_action([0.1, -0.2], [0.0, 0.0], 0.01)
    assert u.shape == (2,) and np.all(np.isfinite(u))
    aa.submit(lambda ag: ag.set_cost_weights({"Position": 7.5}))
    while (a.get_cost_weights()["Position"] != 7.5
           and time.time() < deadline):
        time.sleep(0.01)
    assert a.get_cost_weights()["Position"] == 7.5

    def boom(ag):
        raise ZeroDivisionError("injected")
    aa.submit(boom)
    while aa.loop.error is None and time.time() < deadline:
        time.sleep(0.01)
    for fn in (lambda: aa.get_action([0, 0], [0, 0], 0.0),
               lambda: aa.plan_iterations, aa.stop):
        with pytest.raises(RuntimeError) as e:
            fn()
        assert isinstance(e.value.__cause__, ZeroDivisionError)


def _observation(m, seed=4):
    rng = np.random.default_rng(seed)
    q0 = th.stand_qpos(m).double().numpy()
    quat = q0[3:7] + 0.01 * rng.standard_normal(4)
    return dict(joint_pos=(q0[7:] + 0.03 * rng.standard_normal(12)).tolist(),
                joint_vel=(0.1 * rng.standard_normal(12)).tolist(),
                ang_vel=(0.05 * rng.standard_normal(3)).tolist(),
                quat=(quat / np.linalg.norm(quat)).tolist())


def _tcp(port, requests):
    dec, out, buf = json.JSONDecoder(), [], ""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
        for r in requests:
            c.sendall(json.dumps(r).encode())
            while True:
                try:
                    v, end = dec.raw_decode(buf.lstrip())
                    buf = buf.lstrip()[end:]
                    break
                except json.JSONDecodeError:
                    data = c.recv(65536)
                    assert data, "the server closed"
                    buf += data.decode()
            out.append(v)
    return out


def check_server_async():
    for filt in ("none", "ekf"):
        m = th.build_humanoid(device="cpu")
        agent = Agent(m, "Humanoid Cap Stand", planner="sampling",
                      nsample=8, horizon=3)
        srv = MPCServer(agent, port=0, async_mode=True, filter=filt)
        server = threading.Thread(target=srv.serve_forever, daemon=True)
        server.start()
        assert srv.listening.wait(30)
        obs = _observation(m)
        replies = _tcp(srv.port, [obs])
        a = srv._async
        deadline = time.time() + 60
        while a.loop.iterations < 1 and time.time() < deadline:
            time.sleep(0.01)
        replies += _tcp(srv.port, [obs])
        assert srv.plan_iterations >= 1
        srv.stop()
        server.join(timeout=30)
        assert srv._async is None and not server.is_alive()
        for r in replies:
            assert len(r) == 12 and np.all(np.isfinite(r)), r


# ---------------------------------------------------------------------------
# realtime eval, the live viewer, profiling
# ---------------------------------------------------------------------------

def check_realtime_eval():
    from humanoid_mujoco_torch.serving import realtime_eval
    out = realtime_eval.run(seconds=0.03, control_hz=100.0,
                            planner="sampling", nsample=8, horizon=3,
                            realtime=False, verbose=False, device="cpu")
    jax_keys = {"achieved_control_hz", "plan_iterations_per_s",
                "plan_iterations", "action_latency_ms_mean",
                "action_latency_ms_p99", "mean_cost", "final_cost",
                "wall_s"}
    assert jax_keys <= set(out), out
    assert out["sim_substeps"] == 5 and np.isfinite(out["mean_cost"])


def check_live_session():
    """tests/test_viewer.py's TestLiveViewer on the port (planning on the
    CPU)."""
    from humanoid_mujoco_torch.viz.live import LiveSession, serve_live
    session = LiveSession(task_name="ParticleFixed", planner="sampling",
                          nsample=8, horizon=8, control_hz=50.0,
                          realtime=False, device="cpu")
    session.start()
    srv = serve_live(session, port=0, block=False)
    try:
        port = srv.server_address[1]

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=30) as r:
                return json.loads(r.read())

        def post(path, payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(payload).encode(), method="POST")
            urllib.request.urlopen(req, timeout=30).read()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=30) as r:
            page = r.read().decode()
        assert "const META =" in page and "set_weight" in page
        s1 = get("/state.json")
        time.sleep(0.5)
        s2 = get("/state.json")
        assert s2["t"] > s1["t"]
        assert len(s2["spheres"]) == len(session.meta["radii"])
        assert s2["control_hz"] > 0
        assert get("/meta.json") == session.meta
        post("/set_weight", {"name": "Position", "value": 7.5})
        deadline = time.time() + 10
        while time.time() < deadline:
            if session.agent.get_cost_weights().get("Position") == 7.5:
                break
            time.sleep(0.05)
        assert session.agent.get_cost_weights()["Position"] == 7.5
        q_before = session._state["qpos"].copy()
        post("/perturb", {"force": [5.0, 0.0, 0.0]})
        time.sleep(0.5)
        assert not np.allclose(q_before, session._state["qpos"], atol=1e-5)
    finally:
        srv.shutdown()
        session.stop()


def check_profiling():
    from humanoid_mujoco_torch.utils import StageTimers, trace_to
    timers = StageTimers()
    x = torch.ones(64, dtype=F64)
    for _ in range(3):
        with timers.section("matmul", block=True, result=x):
            x = torch.tanh(x @ torch.eye(64, dtype=F64))
    s = timers.summary()
    assert s["matmul"]["calls"] == 3 and s["matmul"]["total_s"] > 0
    timers.reset()
    assert timers.summary() == {}
    with tempfile.TemporaryDirectory() as d:
        with trace_to(d):
            torch.tanh(x @ torch.eye(64, dtype=F64))
        trace = json.load(open(os.path.join(d, "trace.json")))
        assert any(e.get("name") == "aten::mm"
                   for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# gRPC: the port's servers against the in-process port objects
# ---------------------------------------------------------------------------

def _near(a, b, tol=1e-12):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b), initial=0.0) <= tol, (a, b)


def check_grpc_agent():
    """tests/test_grpc.py's verbs on a spawned port server (float32, the
    server's model) and on an in-process Agent, equal to the bit."""
    from humanoid_mujoco_torch.serving.grpc_client import GrpcAgent
    local = particle(dtype=torch.float32, planner="sampling", nsample=8,
                     horizon=8)
    with GrpcAgent(task_id="ParticleFixed", planner="sampling", nsample=8,
                   horizon=8, device="cpu") as ag:
        def both(verb, *a, **kw):
            return getattr(ag, verb)(*a, **kw), getattr(local, verb)(*a,
                                                                     **kw)
        ag.set_state(qpos=[0.1, -0.2], qvel=[0.0, 0.0], time=0.0)
        local.set_state(qpos=[0.1, -0.2], qvel=[0.0, 0.0], time=0.0)
        s = ag.get_state()
        _near(s["qpos"], np.float32([0.1, -0.2]), 0.0)
        assert s["time"] == 0.0
        r0 = ag.planner_step()
        assert r0 == local.planner_step()
        r = ag.planner_step(iterations=3)
        for _ in range(3):
            rl = local.planner_step()
        assert r == rl and np.isfinite(r)
        u, ul = both("get_action")
        assert u.shape == (2,) and np.all(np.abs(u) <= 1.0 + 1e-6)
        _near(u, ul, 0.0)
        _near(*both("get_action", time=0.05, averaging_duration=0.03), 0.0)
        t0 = ag.get_state()["time"]
        _near(*both("step"), 0.0)
        assert ag.get_state()["time"] > t0
        ag.set_cost_weights({"Position": 11.0})
        local.set_cost_weights({"Position": 11.0})
        assert ag.get_cost_weights() == local.get_cost_weights()
        assert ag.get_cost_weights()["Position"] == 11.0
        vals = ag.get_cost_term_values()
        assert set(vals) == {"Position", "Velocity", "Control"}
        assert vals == local.get_cost_term_values()
        ag.set_task_parameters({})
        assert ag.get_mode() == local.get_mode() == "default"
        ag.set_mocap("goal", pos=[0.3, 0.1, 0.0])
        local.set_mocap("goal", pos=[0.3, 0.1, 0.0])
        r, rl = both("get_residuals")
        _near(r, rl, 0.0)
        q = ag.get_state()["qpos"]
        _near(r[:2], q - np.float32([0.3, 0.1]), 1e-6)
        tr, trl = both("best_trajectory")
        assert tr["knots"].shape == (3, 2)
        _near(tr["knots"], trl["knots"], 0.0)
        _near(tr["times"], trl["times"], 0.0)
        ag.set_anything(state={"time": 2.0})
        assert ag.get_state()["time"] == pytest.approx(2.0)
        with pytest.raises(Exception):
            ag.set_anything(task={"Bogus": 1.0})
        assert ag.get_mode() == "default"       # the server survives
        ag.set_state(qpos=[0.4, 0.4])
        ag.reset()
        _near(ag.get_state()["qpos"], [0.0, 0.0], 0.0)
        # tests/test_grpc.py's spawned-server loop, against the local one
        local.reset()
        for x in (ag, local):
            x.set_state(qpos=[0.0, 0.0], qvel=[0.0, 0.0], time=0.0)
            for _ in range(40):
                x.planner_step()
                x.step()
        s, sl = ag.get_state(), local.get_state()
        _near(s["qpos"], sl["qpos"], 0.0)
        assert s["qpos"][0] > 0.05
        _near(*both("get_action", nominal_action=True), 0.0)


def check_grpc_wire_with_jax_client():
    """The JAX package's client drives the port's server: one state round
    trip (the service name and messages are shared)."""
    from humanoid_mujoco_tpu.serving.grpc_client import GrpcAgent as JAgent
    from humanoid_mujoco_torch.serving.grpc_server import make_server
    agent = particle(nsample=8, horizon=8, dt=0.02)
    server, port = make_server(agent, port=0, device="cpu")
    server.start()
    try:
        client = JAgent(task_id="", address=f"127.0.0.1:{port}",
                        spawn=False)
        client.set_state(qpos=[0.1, -0.2], qvel=[0.0, 0.0], time=0.0)
        s = client.get_state()
        np.testing.assert_array_equal(s["qpos"], [0.1, -0.2])
        assert s["time"] == 0.0
        assert client.get_mode() == "default"
        client.close()
    finally:
        server.stop(None)


def check_grpc_estimation():
    """tests/test_grpc_estimation.py's verbs on spawned port filter and
    direct servers (float64) and on in-process port services."""
    from humanoid_mujoco_torch.direct.service import DirectService
    from humanoid_mujoco_torch.estimators import measure
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.serving.filtering import FilterService
    from humanoid_mujoco_torch.serving.grpc_estimation import (GrpcDirect,
                                                               GrpcFilter)
    m = th.build_humanoid(dtype=F64, device="cpu")
    q0 = th.stand_qpos(m).numpy()
    s = make_state(m, qpos=torch.tensor(q0))
    y = measure(m, s.qpos, s.qvel)[0].numpy()
    local = FilterService(m)
    with GrpcFilter(task_id="Humanoid Cap Stand", device="cpu",
                    dtype="float64") as f:
        with pytest.raises(Exception):     # update before init aborts
            f.update(np.zeros(m.nu), np.zeros(30))
        f.init(q0)
        local.init(q0)
        st = f.state()
        _near(st["qpos"], q0, 0.0)
        _near(st["qvel"], np.zeros(m.nv), 0.0)
        innov = f.update(np.zeros(m.nu), y)
        assert np.isfinite(innov)
        assert abs(innov - local.update(np.zeros(m.nu), y)) <= 1e-12
        st, stl = f.state(), local.state()
        _near(st["qpos"], stl["qpos"])
        _near(st["qvel"], stl["qvel"])
        assert abs(st["qpos"][2] - q0[2]) < 0.05
        cov = f.covariance()
        assert cov.shape == (2 * m.nv, 2 * m.nv)
        _near(cov, local.covariance())
        _near(cov, cov.T, 1e-5)
        assert np.all(np.diag(cov) > 0)
        noise = f.noise()
        assert noise.shape == (30,) and np.all(noise > 0)
        _near(noise, local.noise(), 0.0)
        f.reset()

    T = 5
    local = DirectService(m, configuration_length=T)
    with GrpcDirect(task_id="Humanoid Cap Stand", configuration_length=T,
                    device="cpu") as d:
        out = d.settings(gn_iters=2, force_weight=1e-4,
                         regularization=1e-4)
        local.set_settings(gn_iters=2, force_weight=1e-4,
                           regularization=1e-4)
        assert out["gn_iters"] == 2
        assert out["force_weight"] == pytest.approx(1e-4)
        loc = local.settings()
        assert {k: out[k] for k in loc} == loc
        d.settings(gn_iters=2)
        local.set_settings(gn_iters=2)
        rng = np.random.default_rng(0)
        qs = np.tile(q0, (T, 1))
        qs[:, 7:] += 0.01 * rng.standard_normal((T, m.nq - 7))
        sens, ctrl = np.tile(y, (T, 1)), np.zeros((T, m.nu))
        d.data(qs, sensor=sens, ctrl=ctrl)
        local.set_data(qs, sens, ctrl)
        out = d.optimize()
        r = local.optimize()
        assert out["qpos"].shape == (T, m.nq)
        assert out["qvel"].shape == (T - 1, m.nv)
        assert np.isfinite(out["cost"])
        assert out["cost"] <= out["cost_initial"]
        _near(out["qpos"], r.qpos.numpy())
        _near(out["qvel"], r.qvel.numpy())
        assert abs(out["cost"] - float(r.cost)) <= 1e-12 * max(
            1.0, abs(float(r.cost)))
        st = d.status()
        assert st["optimized"] and st["cost"] == pytest.approx(out["cost"])
        assert d.cost() == pytest.approx(out["cost"])
        d.reset()
        with pytest.raises(Exception):
            d.optimize()


def check_track_clips():
    from humanoid_mujoco_torch.tasks import humanoid_track
    port = Path(humanoid_track.MOTIONS_PATH)
    jax = ROOT / "humanoid_mujoco_tpu" / "physics" / "tracking_motions.npz"
    assert port.parent == ROOT / "humanoid_mujoco_torch" / "physics"
    assert hashlib.sha256(port.read_bytes()).hexdigest() == hashlib.sha256(
        jax.read_bytes()).hexdigest()


def run_checks():
    check_track_clips()
    check_native_build()
    check_thread_pool()
    check_state_store()
    check_policy_buffer()
    check_agent_loop()
    check_async_hand_driven()
    check_async_threads()
    check_server_async()
    check_realtime_eval()
    check_live_session()
    check_profiling()
    check_grpc_agent()
    check_grpc_wire_with_jax_client()
    check_grpc_estimation()
