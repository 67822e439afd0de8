"""The 12-actuated-DOF mini humanoid ("Humanoid_Cap") as a Model.

Counterpart of humanoid_mujoco_tpu/physics/humanoid.py, with the same
numbers: free-joint root + 6 arm hinges + 6 leg hinges, ~1.9 kg, sphere
collision proxies, 45 sphere pairs, an 8×8 heightfield floor. Joint
order matches the reference MJCF document order (simulation/assets/
humanoid.xml), so qpos/qvel indices line up with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import ActuatorType, JointType, Model, ModelBuilder

# reference defaults (world.xml:18-22)
_JOINT = dict(damping=0.2, armature=0.01, stiffness=1.0, springref=0.0,
              limited=True)
_GEAR = 20.0
_FRC = (-1.0, 1.0)
_CTRL = (-1.0, 1.0)
_FRICTION = 0.6          # default geom friction
_FOOT_FRICTION = 0.8     # pressure_geom_{L,R} friction (humanoid.xml:70,89)
FLOOR_FRICTION = 1.5     # world.xml floor (world.xml:60)
FLOOR_Z = -0.7           # floor hfield pos z (world.xml:60)

HALF_PI = 1.5708

# initial poses (simulation/simulation_parameters.py:62-72)
STAND_POS = (0.0, 0.0, -0.375)
STAND_QUAT = (-0.70710678, 0.0, 0.0, 0.70710678)
STANDUP_POS = (0.0, 0.0, -0.6)
STANDUP_QUAT = (-0.5, -0.5, 0.5, 0.5)

JOINT_NAMES = (
    "right_shoulder_roll", "right_shoulder_pitch", "right_elbow",
    "left_shoulder_roll", "left_shoulder_pitch", "left_elbow",
    "right_hip_roll", "right_hip_pitch", "right_knee",
    "left_hip_roll", "left_hip_pitch", "left_knee",
)

# actuator order follows the reference <actuator> block (humanoid.xml:96-109)
ACTUATED_JOINT_ORDER = (
    "right_shoulder_pitch", "right_shoulder_roll", "right_elbow",
    "left_shoulder_pitch", "left_shoulder_roll", "left_elbow",
    "left_hip_roll", "left_hip_pitch", "left_knee",
    "right_hip_roll", "right_hip_pitch", "right_knee",
)


def _euler_to_quat_xyz(a, b, c):
    """Intrinsic x-y-z Euler angles -> quaternion (MJCF compiler default)."""
    def aa(axis, ang):
        s = np.sin(ang / 2)
        q = np.zeros(4)
        q[0] = np.cos(ang / 2)
        q[1 + axis] = s
        return q

    def mul(p, q):
        w1, x1, y1, z1 = p
        w2, x2, y2, z2 = q
        return np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ])
    return tuple(mul(mul(aa(0, a), aa(1, b)), aa(2, c)))


def build_humanoid(dt: float = 0.002, dtype=torch.float32,
                   hfield_shape=(8, 8), with_floor: bool = True,
                   self_collision: bool = True,
                   max_contacts: int = 32, device=None) -> Model:
    """The flagship model on `device` (cuda unless told otherwise).

    `max_contacts` is kept in the structure for parity with the JAX
    package; the port's step is selection-free over all 67 slots, as
    the JAX kernel path is.
    """
    b = ModelBuilder(dt=dt, gravity=(0.0, 0.0, -9.81))
    b.floor_z = FLOOR_Z
    b.floor_friction = FLOOR_FRICTION
    b.has_floor = with_floor
    b.hfield_shape = hfield_shape
    b.hfield_halfsize = (10.0, 10.0)
    b.max_contacts = max_contacts

    root = b.add_body("humanoid_world_link", -1, pos=STAND_POS,
                      quat=STAND_QUAT, mass=0.0)
    # The XML <default> joint class applies to the free root too
    # (world.xml:21 + humanoid.xml:17 `<joint type="free"/>`): damping
    # 0.2 and armature 0.01 on all 6 root dofs, and a stiffness-1.0
    # spring tethering the root to its qpos0 pose (= the stand pose).
    b.add_joint("humanoid_free", root, JointType.FREE,
                damping=_JOINT["damping"], armature=_JOINT["armature"],
                stiffness=_JOINT["stiffness"])

    torso = b.add_body(
        "torso", root, pos=(0.1675, -0.005, 0.135),
        mass=1.12683815772725, ipos=(0, 0, 0),
        iquat=_euler_to_quat_xyz(-0.0008201436182088129, -0.12382311655719636,
                                 1.5628008270149865),
        inertia=(0.010527741038321506, 0.009364184382386672,
                 0.004851735924892816))

    def arm(side: str, shoulder_pos, roll_range):
        sr = b.add_body(
            f"{side}_shoulder_roll_link", root, pos=shoulder_pos,
            quat=(0.707105, 0.707107, -0.00096831, 0.000968314),
            mass=0.0517508, ipos=(0.000605694, -0.0120164, 0.0186305),
            iquat=(0.653192, 0.653383, -0.270554, 0.270611),
            inertia=(1.4546e-05, 1.38577e-05, 1.00733e-05))
        b.add_joint(f"{side}_shoulder_roll", sr, JointType.HINGE,
                    axis=(0, 0, -1), jrange=roll_range, **_JOINT)
        sp = b.add_body(
            f"{side}_shoulder_pitch_link", sr, pos=(0, -0.024, 0.018),
            quat=(0.706803, 0.020714, -0.706803, -0.020714),
            mass=0.0745776, ipos=(-5.93785e-06, -0.0552442, -1.9163e-10),
            iquat=(0.707107, 0.707107, 0, 0),
            inertia=(3.48174e-05, 2.30396e-05, 2.00988e-05))
        b.add_joint(f"{side}_shoulder_pitch", sp, JointType.HINGE,
                    axis=(0, 0, 1), jrange=(-HALF_PI, HALF_PI), **_JOINT)
        fa = b.add_body(
            f"{side}_forearm_pitch_link", sp, pos=(0, -0.11049, 0),
            quat=(0.707055, -0.00862726, -0.707053, -0.00862572),
            mass=0.094279, ipos=(0.000238558, -0.0331073, 8.27912e-05),
            iquat=(0.707052, 0.70712, -0.00486423, -0.00594191),
            inertia=(3.34885e-05, 3.00632e-05, 1.67663e-05))
        b.add_joint(f"{side}_elbow", fa, JointType.HINGE,
                    axis=(1, 0, 0), jrange=(-HALF_PI, 0.0), **_JOINT)
        return sr, sp, fa

    def leg(side: str, waist_pos, waist_quat, roll_range, wp_quat, knee_pos,
            knee_quat, ipos_y_eps, mass_wp):
        wr = b.add_body(
            f"{side}_waist_roll_link", root, pos=waist_pos, quat=waist_quat,
            mass=0.0517508, ipos=(0.000605143, -0.0120164, 0.0186305),
            iquat=(0.653192, 0.653383, -0.270554, 0.270611),
            inertia=(1.4546e-05, 1.38577e-05, 1.00733e-05))
        b.add_joint(f"{side}_hip_roll", wr, JointType.HINGE,
                    axis=(0, 0, -1), jrange=roll_range, **_JOINT)
        wp = b.add_body(
            f"{side}_waist_pitch_link", wr, pos=(0, -0.024, 0.018),
            quat=wp_quat, mass=mass_wp,
            ipos=(4.9863e-06, -0.0752442, ipos_y_eps),
            iquat=(0.707107, 0.707107, 0, 0),
            inertia=(6.15393e-05, 4.97615e-05, 2.20093e-05))
        b.add_joint(f"{side}_hip_pitch", wp, JointType.HINGE,
                    axis=(0, 0, -1), jrange=(-HALF_PI, HALF_PI), **_JOINT)
        kn = b.add_body(
            f"{side}_knee_pitch_link", wp, pos=knee_pos, quat=knee_quat,
            mass=0.167319, ipos=(0.000109197, -0.0801721, 0.00013442),
            iquat=(0.499013, 0.501748, -0.500969, 0.498263),
            inertia=(8.01423e-05, 7.67196e-05, 3.31839e-05))
        b.add_joint(f"{side}_knee", kn, JointType.HINGE,
                    axis=(0, 0, 1), jrange=(0.0, HALF_PI), **_JOINT)
        b.add_site(f"{side}_bottom_foot", kn, pos=(0, -0.15, 0))
        return wr, wp, kn

    # document order: right arm, left arm, right leg, left leg
    r_sr, r_sp, r_fa = arm("right", (0.31335, -0.0091897, 0.17689),
                           (-HALF_PI, 0.0))
    l_sr, l_sp, l_fa = arm("left", (0.057897, -0.0091897, 0.17689),
                           (0.0, HALF_PI))
    r_wr, r_wp, r_kn = leg(
        "right", (0.22812, -0.0082528, 0.025136),
        (0.707039, 0.707041, -0.0097277, 0.00972773), (-HALF_PI, 0.26),
        (0.707056, 0.00844572, 0.707056, 0.00844572), (0, -0.150488, 0),
        (0, -0.0240565, 0.999711, 0), -1.31697e-09, 0.0888059)
    l_wr, l_wp, l_kn = leg(
        "left", (0.14312, -0.0082528, 0.025136),
        (0.707101, 0.707104, 0.00253804, -0.00253805), (-0.26, HALF_PI),
        (0.706835, 0.0196184, 0.706835, 0.0196184), (0, -0.15049, 0),
        (-3.26776e-08, 0.00889621, 0.99996, -3.67306e-06), -1.53469e-09,
        0.088806)

    # actuators in reference order, all motors gear=20 frc/ctrl ±1
    jid = {name: i for i, name in enumerate(
        j["name"] for j in b._joints)}
    for name in ACTUATED_JOINT_ORDER:
        b.add_actuator(jid[name], ActuatorType.MOTOR, gear=_GEAR,
                       ctrlrange=_CTRL, forcerange=_FRC)

    # --- collision sphere clouds (sized from the reference STL bounds) ---
    def sph(body, pos, r, fr=_FRICTION, tor=0.005, roll=0.0001):
        return b.add_sphere(body, pos=pos, radius=r, friction=fr,
                            friction_tor=tor, friction_roll=roll)

    torso_sph = [sph(torso, (x, 0.0, z), 0.055)
                 for x in (-0.03, 0.07) for z in (-0.07, 0.07)]
    arm_sph = {}
    for side, sp_, fa_ in (("right", r_sp, r_fa), ("left", l_sp, l_fa)):
        upper = [sph(sp_, (0, -0.03, 0), 0.020),
                 sph(sp_, (0, -0.10, 0), 0.020)]
        fore = [sph(fa_, (0, -0.04, 0), 0.019),
                sph(fa_, (0, -0.10, 0), 0.019)]   # [-1] = hand
        arm_sph[side] = dict(upper=upper, fore=fore)
    leg_sph = {}
    for side, wp_, kn_ in (("right", r_wp, r_kn), ("left", l_wp, l_kn)):
        thigh = [sph(wp_, (0, -0.05, 0), 0.020),
                 sph(wp_, (0, -0.12, 0), 0.020)]
        # pressure_geom friction "0.8 0.02 0.01" (humanoid.xml:70,89):
        # the elevated torsional/rolling coefficients on the ball-shaped
        # feet act as a weak virtual ankle — essential for standing
        shin = [sph(kn_, (0, -0.02, 0), 0.022, _FOOT_FRICTION, 0.02, 0.01),
                sph(kn_, (0, -0.09, 0), 0.022, _FOOT_FRICTION, 0.02, 0.01)]
        foot = sph(kn_, (0, -0.15, 0), 0.027, _FOOT_FRICTION, 0.02, 0.01)
        leg_sph[side] = dict(thigh=thigh, shin=shin, foot=foot)

    if self_collision:
        # leg-leg (the dominant self-collision mode for this robot)
        left_leg = (leg_sph["left"]["thigh"] + leg_sph["left"]["shin"]
                    + [leg_sph["left"]["foot"]])
        right_leg = (leg_sph["right"]["thigh"] + leg_sph["right"]["shin"]
                     + [leg_sph["right"]["foot"]])
        for a in left_leg:
            for c in right_leg:
                b.add_pair(a, c)
        # forearms vs torso, hands vs thighs
        for side in ("left", "right"):
            for a in arm_sph[side]["fore"]:
                for c in torso_sph:
                    b.add_pair(a, c)
            hand = arm_sph[side]["fore"][-1]
            for c in leg_sph[side]["thigh"]:
                b.add_pair(hand, c)

    return b.finalize(dtype=dtype, device=device)


def stand_qpos(m: Model) -> torch.Tensor:
    """Keyframe: standing, joints at 0 (the reference initial pose)."""
    q = np.zeros(m.nq)
    q[0:3] = STAND_POS
    q[3:7] = np.asarray(STAND_QUAT) / np.linalg.norm(STAND_QUAT)
    return torch.as_tensor(q, dtype=m.dtype, device=m.device)


def standup_qpos(m: Model) -> torch.Tensor:
    """Keyframe: lying on the ground (standupReward initial pose)."""
    q = np.zeros(m.nq)
    q[0:3] = STANDUP_POS
    q[3:7] = np.asarray(STANDUP_QUAT) / np.linalg.norm(STANDUP_QUAT)
    return torch.as_tensor(q, dtype=m.dtype, device=m.device)
