"""Task registry (the reference's tasks.cc GetTasks).

Counterpart of humanoid_mujoco_tpu/tasks/registry.py, with all 24 of
its tasks under their names: the sphere-and-joint tier ("Acrobot",
"Cartpole", "Humanoid Cap Stand", "Humanoid Cap Walk", "Particle",
"ParticleFixed", "Quadruped Flat", "Quadruped Hill", "Swimmer",
"Walker"), the contact-rich tier the step runs selection-free
("Bimanual Handover", "FreeFingers", "Humanoid Stand", "Humanoid
Track", "Humanoid Walk", "OP3", "Panda", "PickAndPlace", "Quadrotor")
and the top-k tier, whose step keeps its contact selection and hands
kernel B2 a per-env chain mask ("Allegro", "Bimanual Insert", "Bimanual
Reorient", "Humanoid Interact", "Rubik" at nv 36, "Shadow"). Each name
selects a task factory, the factory of the model it plans on and,
optionally, its home keyframe. Factories take the `dtype` and `device`
keywords.
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
    from ..physics import humanoid_upstream
    from ..physics.humanoid import build_humanoid, stand_qpos
    from .acrobot import acrobot_home_qpos, acrobot_model, acrobot_task
    from .aloha import (aloha_home_qpos, aloha_insert_model, aloha_model,
                        aloha_reorient_model, handover_task,
                        insert_home_qpos, insert_task, reorient_home_qpos,
                        reorient_task)
    from .cartpole import cartpole_home_qpos, cartpole_model, cartpole_task
    from .fingers import fingers_home_qpos, fingers_model, fingers_task
    from .hands import (allegro_home_qpos, allegro_model, allegro_task,
                        shadow_home_qpos, shadow_model, shadow_task)
    from .humanoid21 import h21_stand_task, h21_walk_task, humanoid21_model
    from .humanoid_track import start_state as track_start
    from .humanoid_track import track_model, track_task
    from .interact import interact_home_qpos, interact_model, interact_task
    from .op3 import op3_home_qpos, op3_model, op3_task
    from .panda import panda_home_qpos, panda_model, panda_task
    from .particle import particle_fixed_task, particle_model, particle_task
    from .pickplace import (pickplace_home_qpos, pickplace_model,
                            pickplace_task)
    from .quadrotor import (quadrotor_home_qpos, quadrotor_model,
                            quadrotor_task)
    from .quadruped import (quadruped_home_qpos, quadruped_model,
                            quadruped_task)
    from .quadruped_hill import quadruped_hill_model, quadruped_hill_task
    from .rubik import rubik_home_qpos, rubik_model, rubik_task
    from .stand import stand_task
    from .swimmer import swimmer_model, swimmer_task
    from .walk import walk_task
    from .walker2d import walker_model, walker_stand_qpos, walker_task
    register("Acrobot", acrobot_task, acrobot_model, acrobot_home_qpos)
    register("Allegro", allegro_task, allegro_model, allegro_home_qpos)
    register("Bimanual Handover", handover_task, aloha_model,
             aloha_home_qpos)
    register("Bimanual Insert", insert_task, aloha_insert_model,
             insert_home_qpos)
    register("Bimanual Reorient", reorient_task, aloha_reorient_model,
             reorient_home_qpos)
    register("Cartpole", cartpole_task, cartpole_model,
             cartpole_home_qpos)
    register("FreeFingers", fingers_task, fingers_model,
             fingers_home_qpos)
    register("Humanoid Cap Stand", stand_task, build_humanoid, stand_qpos)
    register("Humanoid Cap Walk", walk_task, build_humanoid, stand_qpos)
    register("Humanoid Stand", h21_stand_task, humanoid21_model,
             humanoid_upstream.stand_qpos)
    register("Humanoid Walk", h21_walk_task, humanoid21_model,
             humanoid_upstream.stand_qpos)
    register("Humanoid Track", track_task, track_model,
             lambda m: track_start(m, 0).qpos[0])
    register("Humanoid Interact", interact_task, interact_model,
             interact_home_qpos)
    register("OP3", op3_task, op3_model, op3_home_qpos)
    register("Panda", panda_task, panda_model, panda_home_qpos)
    register("Particle", particle_task, particle_model)
    register("ParticleFixed", particle_fixed_task, particle_model)
    register("PickAndPlace", pickplace_task, pickplace_model,
             pickplace_home_qpos)
    register("Quadrotor", quadrotor_task, quadrotor_model,
             quadrotor_home_qpos)
    register("Quadruped Flat", quadruped_task, quadruped_model,
             quadruped_home_qpos)
    register("Quadruped Hill", quadruped_hill_task, quadruped_hill_model,
             quadruped_home_qpos)
    register("Rubik", rubik_task, rubik_model, rubik_home_qpos)
    register("Shadow", shadow_task, shadow_model, shadow_home_qpos)
    register("Swimmer", swimmer_task, swimmer_model)
    register("Walker", walker_task, walker_model, walker_stand_qpos)


_register_builtin()
