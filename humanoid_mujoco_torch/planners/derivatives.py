"""Model and cost linearization along a nominal trajectory.

Counterpart of humanoid_mujoco_tpu/planners/derivatives.py. This slice
holds only `_light_info`, the kinematics-only StepInfo that the Agent
runs its task transitions on. The rest of the file (the A, B, C, D
linearizations through the step with the implicit-function derivative
of the Newton solve) comes with the gradient planners, ROADMAP item 10.
"""

from __future__ import annotations

import torch

from ..physics.engine import body_com_velocities, fwd_position, fwd_velocity
from ..physics.model import Model, State
from ..physics.step import StepInfo


def _light_info(m: Model, state: State) -> StepInfo:
    """Kinematics-only StepInfo of a batch (no contact solve): valid for
    residuals and transitions that read positions and velocities. The
    contact, acceleration and force leaves are zeros."""
    kin = fwd_position(m, state.qpos)
    vel = fwd_velocity(m, kin, state.qvel)
    B = state.batch

    def z(n):
        return state.qpos.new_zeros((B, n))
    return StepInfo(
        xpos=kin.xpos, xquat=kin.xquat, xipos=kin.xipos,
        site_xpos=kin.site_xpos, com=kin.anchor, com_vel=vel.com_vel,
        body_com_vel=body_com_velocities(kin, vel),
        contact_dist=z(m.ncon), contact_force=z(m.ncon), qacc=z(m.nv),
        actuator_force=z(m.nu), qfrc_total=z(m.nv),
        diverged=torch.zeros(B, dtype=torch.bool, device=state.qpos.device))
