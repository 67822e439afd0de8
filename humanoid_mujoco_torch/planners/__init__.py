from .cem import CEMConfig, CEMState, cem_init, cem_plan
from .gradient import GradientConfig, gradient_plan
from .ilqg import (ILQGConfig, ILQGInfo, ILQGPolicy, ILQGState, ilqg_action,
                   ilqg_init, ilqg_plan, ilqg_state_from_numpy)
from .ilqs import ILQSConfig, ILQSState, ilqs_init, ilqs_plan
from .mppi import MPPIConfig, mppi_plan
from .policy import (SplinePolicy, init_policy, knot_times, policy_action,
                     resample_policy)
from .robust import RobustConfig, robust_plan
from .sample_gradient import (SampleGradientConfig, SampleGradientState,
                              sample_gradient_init, sample_gradient_plan,
                              sample_gradient_state_from_numpy)
from .sampling import (PlanInfo, SamplingConfig, sample_candidates,
                       sampling_plan)

__all__ = ["SplinePolicy", "init_policy", "knot_times", "policy_action",
           "resample_policy", "PlanInfo", "SamplingConfig",
           "sample_candidates", "sampling_plan", "CEMConfig", "CEMState",
           "cem_init", "cem_plan", "MPPIConfig", "mppi_plan", "ILQGConfig",
           "ILQGInfo", "ILQGPolicy", "ILQGState", "ilqg_action", "ilqg_init",
           "ilqg_plan", "ilqg_state_from_numpy", "GradientConfig",
           "gradient_plan", "ILQSConfig", "ILQSState", "ilqs_init",
           "ilqs_plan", "RobustConfig", "robust_plan",
           "SampleGradientConfig", "SampleGradientState",
           "sample_gradient_init", "sample_gradient_plan",
           "sample_gradient_state_from_numpy"]
