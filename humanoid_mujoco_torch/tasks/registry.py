"""Task registry (the reference's tasks.cc GetTasks).

Counterpart of humanoid_mujoco_tpu/tasks/registry.py, holding the tasks
ported so far: "Humanoid Cap Stand" and "Swimmer". Each name selects a
task factory, the factory of the model it plans on and, optionally, its
home keyframe. Factories take the `dtype` and `device` keywords.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .base import Task

_REGISTRY: Dict[str, Callable[..., Task]] = {}
_MODELS: Dict[str, Callable] = {}
_HOME_QPOS: Dict[str, Callable] = {}


def register(name: str, factory: Callable[..., Task],
             model_factory: Callable = None,
             home_qpos_factory: Callable = None):
    """Register a task factory, its model factory and optionally its
    home keyframe (a function of the model)."""
    _REGISTRY[name] = factory
    if model_factory is not None:
        _MODELS[name] = model_factory
    if home_qpos_factory is not None:
        _HOME_QPOS[name] = home_qpos_factory


def home_qpos(name: str, m):
    """The task's home keyframe qpos, else the model's default qpos."""
    if name in _HOME_QPOS:
        return _HOME_QPOS[name](m)
    from ..physics.model import default_qpos
    return default_qpos(m)


def task_model(name: str, **kwargs):
    """Build the model a registered task plans on."""
    if name not in _MODELS:
        raise KeyError(
            f"no model factory for task {name!r}; have: {sorted(_MODELS)}")
    return _MODELS[name](**kwargs)


def list_tasks() -> List[str]:
    return sorted(_REGISTRY)


def get_task(name: str, **kwargs) -> Task:
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; available: {list_tasks()}")
    return _REGISTRY[name](**kwargs)


def _register_builtin():
    from ..physics.humanoid import build_humanoid, stand_qpos
    from .stand import stand_task
    from .swimmer import swimmer_model, swimmer_task
    register("Humanoid Cap Stand", stand_task, build_humanoid, stand_qpos)
    register("Swimmer", swimmer_task, swimmer_model)


_register_builtin()
