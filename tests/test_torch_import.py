"""The port stands alone: no module of humanoid_mujoco_torch, and not
chip_smoke.py, imports JAX or the JAX package. The port modules that
the parity suite's own helpers and its one collected test import
(tests/test_torch_golden.py, tests/test_torch_refs.py and
tests/test_torch_port.py) are among those a fresh interpreter loads
with no JAX, and the collected test's bare-name imports of its sibling
modules resolve to files of tests/. tests/test_torch_port.py runs these
checks as the port's one collected test."""

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


TESTS = Path(__file__).resolve().parent
PORT_TEST = TESTS / "test_torch_port.py"
HELPERS = (TESTS / "test_torch_golden.py", TESTS / "test_torch_refs.py",
           PORT_TEST)


def imported_modules(path):
    """The absolute module names `path` imports (for `from a import b`,
    both a and a.b: b may be a module)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
            mods.update(f"{node.module}.{a.name}" for a in node.names)
    return mods


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
    return names


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


def check_test_helpers_import_isolated_modules(names):
    """Every humanoid_mujoco_torch module the helpers import is one the
    fresh interpreter loaded with no JAX (`names`, the package's own
    modules; a name imported from a module that is not itself a module
    counts by its module); the collected test's sibling imports are
    files of tests/."""
    loaded = set(names) | {"humanoid_mujoco_torch"}
    for path in HELPERS:
        assert path.exists(), path
        mods = imported_modules(path)
        for mod in sorted(m for m in mods
                          if m.split(".")[0] == "humanoid_mujoco_torch"):
            assert mod in loaded or mod.rsplit(".", 1)[0] in loaded, \
                (path.name, mod)
    for mod in imported_modules(PORT_TEST):
        if mod.startswith("test_torch_"):
            assert (TESTS / f"{mod}.py").exists(), mod


def run_checks():
    check_no_source_file_imports_jax()
    names = check_importing_the_port_loads_no_jax()
    check_test_helpers_import_isolated_modules(names)
