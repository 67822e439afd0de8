"""The upstream MJPC humanoid (dm_control-derived, 21 actuated DOF).

Counterpart of humanoid_mujoco_tpu/physics/humanoid_upstream.py: the
model behind the Humanoid Stand, Walk and Track tasks
(mjpc/tasks/humanoid/humanoid.xml.patch): capsule limbs and sphere
head and hands on a free root, 21 hinge joints with per-class damping,
stiffness and armature, motor actuators with MJPC's gears, and the two
hamstring fixed-tendon limits. The numbers are physics/humanoid21_data.py.
Its step takes the "contact" route: the plain smooth stage, then
kernel B2 over all 35 slots (nv 27, 46 limit rows).
"""

from __future__ import annotations

import torch

from . import humanoid21_data as D
from .model import ActuatorType, Model, ModelBuilder, default_qpos

# torso height at the declared (standing) pose
STAND_HEIGHT = 1.282


def build_humanoid21(dtype=torch.float32, dt: float = 0.002,
                     max_contacts: int = 16, extend=None,
                     device=None) -> Model:
    """The 21-DOF humanoid. `max_contacts` caps the slots `forward`
    solves (the 16 smallest gaps of the 35); `step` runs all 35, as the
    JAX step's selection-free branch does. `extend(builder, body_ids)`
    runs before finalize."""
    b = ModelBuilder(dt=dt)
    b.hfield_shape = (2, 2)
    b.hfield_halfsize = (50.0, 50.0)
    b.max_contacts = max_contacts
    b.solref = (0.015, 1.0)
    b.solimp = (0.9, 0.99, 0.003)
    b.limit_solimp = (0.0, 0.99, 0.01)   # joint solimplimit "0 .99 .01"

    body_ids = {}
    for spec in D.BODIES:
        body_ids[spec["name"]] = b.add_body(
            spec["name"], spec["parent"], pos=spec["pos"],
            quat=spec["quat"], mass=spec["mass"], ipos=spec["ipos"],
            iquat=spec["iquat"], inertia=spec["inertia"])
    joint_ids = {}
    for spec in D.JOINTS:
        joint_ids[spec["name"]] = b.add_joint(
            spec["name"], spec["body"], spec["jtype"], axis=spec["axis"],
            pos=spec["pos"], jrange=spec["jrange"],
            limited=spec["limited"], damping=spec["damping"],
            armature=spec["armature"], stiffness=spec["stiffness"])
    for g in D.GEOMS:
        if g["kind"] == "capsule":
            b.add_capsule(g["body"], p0=g["p0"], p1=g["p1"],
                          radius=g["radius"], friction=g["friction"])
        else:
            b.add_sphere(g["body"], pos=g["pos"], radius=g["radius"],
                         friction=g["friction"])
    for s in D.SITES:
        b.add_site(s["name"], s["body"], pos=s["pos"])
    for a in D.ACTUATORS:
        b.add_actuator(joint_ids[a["joint"]], ActuatorType.MOTOR,
                       gear=a["gear"], ctrlrange=(-1.0, 1.0),
                       forcerange=(-1e9, 1e9))
    for t in D.TENDONS:
        b.add_tendon_limit([joint_ids[j] for j in t["joints"]],
                           t["coefs"], t["range"])
    if extend is not None:
        extend(b, body_ids)
    return b.finalize(dtype=dtype, device=device)


def stand_qpos(m: Model) -> torch.Tensor:
    """The standing keyframe: the declared pose (MuJoCo qpos0)."""
    return default_qpos(m)
