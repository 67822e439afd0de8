from .cem import CEMConfig, CEMState, cem_init, cem_plan
from .mppi import MPPIConfig, mppi_plan
from .policy import (SplinePolicy, init_policy, knot_times, policy_action,
                     resample_policy)
from .sampling import (PlanInfo, SamplingConfig, sample_candidates,
                       sampling_plan)

__all__ = ["SplinePolicy", "init_policy", "knot_times", "policy_action",
           "resample_policy", "PlanInfo", "SamplingConfig",
           "sample_candidates", "sampling_plan", "CEMConfig", "CEMState",
           "cem_init", "cem_plan", "MPPIConfig", "mppi_plan"]
