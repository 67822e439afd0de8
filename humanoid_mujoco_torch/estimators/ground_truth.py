"""Ground-truth "estimator": the registry's null option
(mjpc/estimators/include.cc:23-38 "Ground Truth").

Counterpart of humanoid_mujoco_tpu/estimators/ground_truth.py: it passes
the true simulation state through unchanged, the baseline in estimator
comparisons and for pure-simulation control loops.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..physics.model import Model, State


@dataclasses.dataclass(frozen=True)
class GroundTruthState:
    state: State


def ground_truth_init(m: Model, state: State) -> GroundTruthState:
    return GroundTruthState(state=state)


def ground_truth_update(m: Model, gt: GroundTruthState, ctrl: torch.Tensor,
                        true_state: State
                        ) -> Tuple[GroundTruthState, torch.Tensor]:
    """(the true state, a zero innovation (B,))."""
    return (GroundTruthState(state=true_state),
            torch.zeros_like(true_state.time))
