from .policy import (SplinePolicy, init_policy, knot_times, policy_action,
                     resample_policy)
from .sampling import (PlanInfo, SamplingConfig, sample_candidates,
                       sampling_plan)

__all__ = ["SplinePolicy", "init_policy", "knot_times", "policy_action",
           "resample_policy", "PlanInfo", "SamplingConfig",
           "sample_candidates", "sampling_plan"]
