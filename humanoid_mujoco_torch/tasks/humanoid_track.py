"""Humanoid Track, the mocap-tracking task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/humanoid_track.py (the
reference's mjpc/tasks/humanoid/tracking): the 21-DOF humanoid
(physics/humanoid_upstream.py, dt 0.005) tracks one of ten CMU mocap
clips, 30 fps marker trajectories of 16 landmarks, chosen by the task's
mode; the clip is interpolated linearly at the sim time. The clips are
read with numpy from the port's own physics/tracking_motions.npz, a
byte-for-byte copy of the JAX package's data file.

Residual (141): joint velocities, controls, the marker centroid minus
the tracking-site centroid, the centered marker minus the centered site
per landmark, and the finite-difference marker velocity minus the site's
body COM velocity per landmark.

`start_state(m, mode)` is the clip's first frame.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.humanoid_upstream import build_humanoid21
from ..physics.model import Model, State, make_state
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task

_FPS = 30.0
MOTIONS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "physics",
    "tracking_motions.npz")

# marker order of tracking.cc's body_names
_MARKERS = ("pelvis", "head", "ltoe", "rtoe", "lheel", "rheel",
            "lknee", "rknee", "lhand", "rhand", "lelbow", "relbow",
            "lshoulder", "rshoulder", "lhip", "rhip")


@functools.lru_cache(maxsize=None)
def motions():
    """The clips: {mpos (N, 16, 3), qpos (N, 28), qvel (N, 27), lengths
    (10,), names (10,), starts (10,)} as numpy arrays."""
    with np.load(MOTIONS_PATH, allow_pickle=False) as z:
        d = {k: np.asarray(z[k]) for k in z.files}
    d["starts"] = np.concatenate([[0], np.cumsum(d["lengths"])[:-1]])
    return d


def motion_names():
    return tuple(str(n) for n in motions()["names"])


def track_model(dt: float = 0.005, dtype=torch.float32, device=None
                ) -> Model:
    return build_humanoid21(dt=dt, dtype=dtype, device=device)


def start_state(m: Model, mode: int = 0) -> State:
    """The clip's first frame as a batch-1 state."""
    d = motions()
    i = int(d["starts"][mode])
    return make_state(m, qpos=d["qpos"][i], qvel=d["qvel"][i])


def _frames(m: Model, task: Task, t: torch.Tensor):
    """Interpolated marker frames (B, 16, 3) and the finite-difference
    marker velocities at sim times t (B,)."""
    dtype, dev = t.dtype, t.device
    d = motions()
    starts, lengths, mpos = m.struct_static(
        ("track_tables", dtype, dev), lambda: (
            torch.as_tensor(d["starts"], device=dev),
            torch.as_tensor(d["lengths"], device=dev),
            torch.as_tensor(d["mpos"], dtype=dtype, device=dev)))
    mode = task.mode.long().to(dev)
    start, last = starts[mode], starts[mode] + lengths[mode] - 1
    idx = torch.minimum(torch.maximum(t * _FPS + start.to(dtype),
                                      start.to(dtype)), last.to(dtype))
    i0 = torch.floor(idx).long()
    i1 = torch.minimum(i0 + 1, last)
    w1 = (idx - i0.to(dtype))[:, None, None]
    f0, f1 = mpos[i0], mpos[i1]
    return (1.0 - w1) * f0 + w1 * f1, (f1 - f0) * _FPS


def _track_residual(m: Model, task: Task, state: State, info: StepInfo,
                    ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    markers, marker_vel = _frames(m, task, state.time)
    sites = [s.site_id(f"tracking[{n}]") for n in _MARKERS]
    pos = info.site_xpos[:, sites]
    vel = info.body_com_vel[:, [s.site_body[i] for i in sites]]
    avg_m, avg_s = markers.mean(dim=1), pos.mean(dim=1)
    pos_err = (markers - avg_m[:, None]) - (pos - avg_s[:, None])
    B = pos.shape[0]
    return torch.cat([state.qvel[:, 6:], ctrl, avg_m - avg_s,
                      pos_err.reshape(B, -1),
                      (marker_vel - vel).reshape(B, -1)], dim=-1)


_TERMS = (
    TermSpec("Joint Vel.", 21, NormType.QUADRATIC),
    TermSpec("Control", 21, NormType.COSH, num_params=1),
    TermSpec("Pos[avg]", 3, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Pos[pelvis]", 3, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Pos[head]", 3, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Pos[toe]", 6, NormType.SMOOTH_ABS2, num_params=2),
    TermSpec("Pos[heel]", 6, NormType.SMOOTH_ABS2, num_params=2),
    TermSpec("Pos[knee]", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Pos[hand]", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Pos[elbow]", 6, NormType.SMOOTH_ABS2, num_params=2),
    TermSpec("Pos[shoulder]", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Pos[hip]", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Vel[root]", 3, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Vel[head]", 3, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Vel[toe]", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Vel[heel]", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Vel[knee]", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Vel[hand]", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Vel[elbow]", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Vel[shoulder]", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Vel[hip]", 6, NormType.SMOOTH_ABS, num_params=1),
)
_WEIGHTS = (0.001, 0.1, 100.0, 30.0, 0.0, 30.0, 30.0, 30.0, 30.0, 30.0,
            30.0, 30.0, 0.1, 0.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1)
_NORM_PARAMS = ((0.0, 0.0), (0.3, 0.0), (0.1, 0.0), (0.1, 0.0),
                (0.1, 0.0), (0.2, 4.0), (0.2, 4.0), (0.1, 0.0),
                (0.1, 0.0), (0.2, 4.0), (0.1, 0.0), (0.1, 0.0),
                (0.3, 0.0), (0.3, 0.0), (0.3, 0.0), (0.3, 0.0),
                (0.3, 0.0), (0.3, 0.0), (0.3, 0.0), (0.3, 0.0),
                (0.3, 0.0))


def track_task(dtype=torch.float32, device=None) -> Task:
    return make_task("Humanoid Track", _TERMS, _track_residual,
                     _WEIGHTS, norm_params=_NORM_PARAMS,
                     mode_names=motion_names(), dtype=dtype, device=device)
