from .base import Task, TermSpec, cost_terms, cost_value, trajectory_cost
from .registry import get_task, home_qpos, list_tasks, register, task_model
from .stand import stand_residual, stand_task
from .swimmer import swimmer_model, swimmer_task
from .walk import walk_task

__all__ = ["Task", "TermSpec", "cost_terms", "cost_value",
           "trajectory_cost", "get_task", "home_qpos", "list_tasks",
           "register", "task_model", "stand_task", "stand_residual",
           "swimmer_model", "swimmer_task", "walk_task"]
