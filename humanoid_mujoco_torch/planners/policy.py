"""Spline action policies for the sampling planners.

Counterpart of humanoid_mujoco_tpu/planners/policy.py: a policy is
(times (K,), values (K, nu)); see ops/spline.py for the interpolants.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.spline import SplineOrder, spline_sample
from ..physics.model import Model


@dataclasses.dataclass(frozen=True)
class SplinePolicy:
    times: torch.Tensor    # (K,)
    values: torch.Tensor   # (K, nu)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_policy(m: Model, nknots: int, dtype=None) -> SplinePolicy:
    """Knots on [0, 1], every value at the middle of the ctrl range."""
    dtype = dtype or m.dtype
    mid = 0.5 * (m.act_ctrlrange[:, 0] + m.act_ctrlrange[:, 1])
    return SplinePolicy(
        times=torch.linspace(0.0, 1.0, nknots, dtype=dtype, device=m.device),
        values=mid.to(dtype).expand(nknots, m.nu).clone())


def knot_times(t0, horizon_s, nknots: int, order: int) -> torch.Tensor:
    """Fresh knot grid from t0: spacing horizon/K for zero order, else
    horizon/(K-1) (sampling/planner.cc:284-289)."""
    t0 = torch.as_tensor(t0)
    if order == SplineOrder.ZERO:
        shift = horizon_s / nknots
    else:
        shift = horizon_s / max(nknots - 1, 1)
    return t0 + shift * torch.arange(nknots, dtype=t0.dtype,
                                     device=t0.device)


def resample_policy(policy: SplinePolicy, t0, horizon_s, nknots: int,
                    order: int) -> SplinePolicy:
    """Shift-to-now: the current plan evaluated on a fresh knot grid."""
    new_times = knot_times(t0, horizon_s, nknots, order)
    return SplinePolicy(times=new_times, values=spline_sample(
        policy.times, policy.values, new_times, order))


def policy_action(m: Model, policy: SplinePolicy, t, order: int
                  ) -> torch.Tensor:
    """The policy at time t, clamped to the ctrl range."""
    a = spline_sample(policy.times, policy.values, t, order)
    return torch.clamp(a, m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1])
