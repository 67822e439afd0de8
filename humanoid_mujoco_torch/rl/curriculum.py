"""Adaptive domain-randomization curriculum.

Counterpart of humanoid_mujoco_tpu/rl/curriculum.py (the reference's
randomization_adaptation_callback.py): after each evaluation window the
randomization factor steps up by 0.01 when the success rate beats the
target and down by 0.01 otherwise, clamped to [0, 1]; training stops
after `MAX_SUCCESSES_AT_FULL` successes at full randomization. The state
is a few host numbers: the trainer reads the success rate once a window.
"""

from __future__ import annotations

import dataclasses

SUCCESS_RATE_TARGET = 0.5
RAND_STEP = 0.01
MAX_SUCCESSES_AT_FULL = 10


@dataclasses.dataclass(frozen=True)
class CurriculumState:
    randomization_factor: float
    successes_at_max: int
    done: bool


def curriculum_init(rf0: float = 0.0) -> CurriculumState:
    return CurriculumState(randomization_factor=float(rf0),
                           successes_at_max=0, done=False)


def curriculum_update(cs: CurriculumState, success_rate: float,
                      target: float = SUCCESS_RATE_TARGET
                      ) -> CurriculumState:
    ok = success_rate > target
    rf = min(max(cs.randomization_factor + (RAND_STEP if ok else -RAND_STEP),
                 0.0), 1.0)
    at_max = cs.randomization_factor >= 1.0 - 1e-9
    succ = cs.successes_at_max + int(ok and at_max)
    return CurriculumState(randomization_factor=rf, successes_at_max=succ,
                           done=succ >= MAX_SUCCESSES_AT_FULL)
