"""Rubik: the Shadow hand turns a cube's faces, batched.

Counterpart of humanoid_mujoco_tpu/tasks/rubik.py (the reference's
mjpc/tasks/rubik): the face goals are the six face-hinge angles against
goal angles, while the cube stays on the palm at a goal orientation.
As in the JAX package the reference's 26-cubie cube is simplified to a
free cube core carrying six hinged face plates (one rotational dof per
face about its outward normal, light damping), each a thin box the
fingertips turn by contact friction. The model: the Shadow hand
(tasks/hands.py `add_hand`), the core box and the six plates, every
hand sphere paired with the core and each plate: nv 36, 256 slots, 48
limit rows, top-16 contact selection in the step, so kernel B2 runs at
R = 2 (two matrix rows per lane) with a per-env chain mask.

Residual (88): In Hand (3), Orientation (3), Cube Vel. (3), Actuator
(24), Faces (6) face angles - goal angles (off in mode Wait), Grasp
(24), Joint Vel. (24), Remaining (1) 12 × the remaining-goal count.

Modes Wait | Scramble | Solve; `scramble_goals` authors a scramble as
the sequence of face-angle goals. One difference from the JAX package:
its draws come from a `torch.Generator` (the JAX package seeds numpy
from a JAX key); the goals it returns follow the same rule.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.model import JointType, Model, ModelBuilder, State
from ..physics.step import StepInfo
from .base import Task, TermSpec, constant, make_task
from .hands import _KEY_HAND, add_hand, goal_error

_CUBE_HALF = 0.0285                     # 57 mm cube
_CUBE_START = (0.33326, -0.00362331, 0.045)
_FACE_AXES = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
              (0, 0, 1), (0, 0, -1))
_FACE_NAMES = ("red", "orange", "blue", "green", "white", "yellow")
_SOLVE_TOL = 0.085                      # solve.cc:214
_FACES = slice(31, 37)                  # face hinge angles in qpos


def rubik_model(dt: float = 0.01, max_contacts: int = 16,
                dtype=torch.float32, device=None) -> Model:
    b = ModelBuilder(dt=dt)
    b.has_floor = True
    b.max_contacts = max_contacts
    _, sphs = add_hand(b, "shadow")
    cube = b.add_body("cube", -1, pos=_CUBE_START, mass=0.0685,
                      inertia=(0.0685 / 6 * 2 * _CUBE_HALF ** 2,) * 3)
    b.add_joint("cube_free", cube, JointType.FREE)
    core = b.add_box(cube, size=(_CUBE_HALF * 0.98,) * 3, friction=1.0,
                     floor=True)
    plates = []
    for ax, name in zip(_FACE_AXES, _FACE_NAMES):
        axv = np.asarray(ax, dtype=float)
        face = b.add_body(f"face_{name}", cube,
                          pos=tuple(axv * _CUBE_HALF), mass=0.009,
                          inertia=(2.4e-06, 2.4e-06, 4.7e-06))
        b.add_joint(f"face_{name}_hinge", face, JointType.HINGE,
                    axis=tuple(axv), damping=0.02)
        # thin plate normal to the face axis (fingertips turn it by
        # contact friction, the torsional term among it)
        half = np.full(3, _CUBE_HALF * 0.96)
        half[np.argmax(np.abs(axv))] = 0.004
        plates.append(b.add_box(face, size=tuple(half), friction=1.2,
                                friction_tor=0.02, floor=False))
    for s in sphs:
        b.add_pair_sb(s, core)
        for p in plates:
            b.add_pair_sb(s, p)
    return b.finalize(dtype=dtype, device=device)


def rubik_home_qpos(m: Model) -> torch.Tensor:
    q = np.zeros(m.nq)
    q[:24] = _KEY_HAND["shadow"]
    q[24:27] = _CUBE_START
    q[27] = 1.0
    return torch.tensor(q, dtype=m.dtype, device=m.device)


def scramble_goals(generator: torch.Generator, n: int) -> np.ndarray:
    """A scramble of n quarter-turns on random faces, as the sequence of
    face-angle goal vectors (n + 1, 6), most scrambled first (the
    reference's goal cache, solve.cc:150-199). The draws: a seed from
    `generator`, then numpy's."""
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
    rng = np.random.default_rng(seed)
    angles = np.zeros(6)
    cache = []
    for _ in range(n):
        cache.append(angles.copy())
        face = rng.integers(0, 6)
        angles[face] += rng.choice((-1.0, 1.0)) * 0.5 * np.pi
    cache.append(angles.copy())
    return np.stack(cache[::-1])    # [scrambled ... solved]


def _rubik_residual(m: Model, task: Task, state: State, info: StepInfo,
                    ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    cube = s.body_id("cube")
    in_hand = info.xpos[:, cube] - info.site_xpos[:, s.site_id("grasp_site")]
    faces = state.qpos[:, _FACES] - task.params[:6]
    faces = torch.where(task.mode != 0, faces, torch.zeros_like(faces))
    pose = state.qpos[:, :24] - constant(m, "rubik_key", _KEY_HAND["shadow"],
                                         state.qpos)
    remaining = (task.params[6] * 12.0).expand(state.qpos.shape[0], 1)
    return torch.cat([in_hand, goal_error(m, task, info),
                      info.body_com_vel[:, cube], info.actuator_force,
                      faces, pose, state.qvel[:, :24], remaining], dim=-1)


def _rubik_transition(task: Task, m: Model, state: State,
                      info: StepInfo) -> Task:
    """Solve mode's success check (solve.cc:207-222) on the (single)
    simulated state's first env: once the face angles match within
    0.085, one goal fewer remains; at none, back to Wait (solved)."""
    err = torch.linalg.vector_norm(state.qpos[0, _FACES] - task.params[:6])
    solved_one = (task.mode == 2) & (err < _SOLVE_TOL)
    remaining = torch.clamp(task.params[6] - solved_one.to(
        task.params.dtype), min=0.0)
    mode = torch.where(solved_one & (remaining <= 0.0),
                       torch.zeros_like(task.mode), task.mode)
    params = task.params.clone()
    params[6] = remaining
    return dataclasses.replace(task, mode=mode, params=params)


_TERMS = (
    TermSpec("In Hand", 3, NormType.L22, num_params=2),
    TermSpec("Orientation", 3, NormType.QUADRATIC),
    TermSpec("Cube Vel.", 3, NormType.QUADRATIC),
    TermSpec("Actuator", 24, NormType.QUADRATIC),
    TermSpec("Faces", 6, NormType.QUADRATIC),
    TermSpec("Grasp", 24, NormType.QUADRATIC),
    TermSpec("Joint Vel.", 24, NormType.QUADRATIC),
    TermSpec("Remaining", 1, NormType.NULL),
)
_WEIGHTS = (20.0, 5.0, 10.0, 0.1, 10.0, 2.5, 1.0e-4, 1.0)
_NORM_PARAMS = ((0.02, 2.0),) + ((0.0, 0.0),) * 7


def rubik_task(dtype=torch.float32, device=None) -> Task:
    return make_task("Rubik", _TERMS, _rubik_residual, _WEIGHTS,
                     norm_params=_NORM_PARAMS, params=(0.0,) * 7,
                     param_names=tuple(f"Goal {n}" for n in _FACE_NAMES)
                     + ("Remaining",),
                     mocap={"goal": ((0.325, 0.17, 0.0475),
                                     (1.0, 0.0, 0.0, 0.0))},
                     transition_fn=_rubik_transition,
                     mode_names=("Wait", "Scramble", "Solve"),
                     dtype=dtype, device=device)
