"""RL on the lockstep env batch: the domain-randomized humanoid env,
rewards, networks, the curriculum, SAC, PPO and the training driver
(counterpart of humanoid_mujoco_tpu/rl)."""

from .env import (EnvConfig, EnvState, batch_reset, batch_step, env_reset,
                  env_step, rl_humanoid_model)
from .rewards import RewardResult, control_input_reward, standup_reward

__all__ = ["standup_reward", "control_input_reward", "RewardResult",
           "EnvConfig", "EnvState", "env_reset", "env_step", "batch_reset",
           "batch_step", "rl_humanoid_model"]
