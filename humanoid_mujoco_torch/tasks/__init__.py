from .base import Task, TermSpec, cost_terms, cost_value, trajectory_cost
from .stand import stand_residual, stand_task

__all__ = ["Task", "TermSpec", "cost_terms", "cost_value",
           "trajectory_cost", "stand_task", "stand_residual"]
