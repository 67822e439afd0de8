"""The port stands alone: no module of humanoid_mujoco_torch, and not
chip_smoke.py, imports JAX or the JAX package. tests/test_torch_port.py
runs these checks as the port's one collected test."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "humanoid_mujoco_tpu")


def port_sources():
    files = sorted((ROOT / "humanoid_mujoco_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def check_importing_the_port_loads_no_jax():
    """A fresh interpreter (isolated from the environment's path hooks)
    imports every module of the port and chip_smoke.py, then reports
    which forbidden modules it loaded."""
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
import humanoid_mujoco_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r})
print(json.dumps([names, bad]))
"""
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    names, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) >= 98, out.stdout
    for mod in ("mpc", "tasks.registry", "tasks.swimmer", "rl.rewards",
                "rl.env", "rl.networks", "rl.curriculum", "rl.sac",
                "rl.ppo", "rl.train", "agent", "mpc_in_env",
                "planners.cem", "planners.mppi", "planners.derivatives",
                "serving", "serving.server", "serving.state_estimation",
                "rl.evaluate", "physics.tangent", "ops.boxqp",
                "planners.ilqg", "planners.terminal",
                "planners.tangent_interp", "tasks.acrobot",
                "tasks.cartpole", "tasks.particle", "tasks.quadruped",
                "tasks.quadruped_hill", "tasks.walk", "tasks.walker2d",
                "estimators", "estimators.sensors",
                "estimators.ground_truth", "estimators.kalman",
                "estimators.unscented", "estimators.batch", "direct",
                "direct.optimizer", "direct.service", "serving.filtering",
                "rollout", "planners.robust", "planners.sample_gradient",
                "planners.gradient", "planners.ilqs",
                "planners.parallel_riccati", "rl.tune", "rl.plot",
                "rl.videos", "viz", "viz.render", "viz.viewer",
                "physics.humanoid_upstream", "physics.humanoid21_data",
                "physics.op3_data", "tasks.aloha", "tasks.fingers",
                "tasks.humanoid21", "tasks.humanoid_track", "tasks.op3",
                "tasks.panda", "tasks.pickplace", "tasks.quadrotor",
                "physics.allegro_data", "physics.shadow_data",
                "tasks.hands", "tasks.interact", "tasks.rubik",
                "native", "native.async_agent", "serving.realtime_eval",
                "viz.live", "utils", "utils.profiling", "grpc",
                "grpc.agent_pb2", "grpc.filter_pb2", "grpc.direct_pb2",
                "serving.grpc_server", "serving.grpc_client",
                "serving.estimation_servers", "serving.grpc_estimation",
                "parallel", "parallel.mesh", "parallel.distributed",
                "parallel.dryrun"):
        assert f"humanoid_mujoco_torch.{mod}" in names, mod
    assert bad == [], bad


def check_no_source_file_imports_jax():
    for path in port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def run_checks():
    check_no_source_file_imports_jax()
    check_importing_the_port_loads_no_jax()
