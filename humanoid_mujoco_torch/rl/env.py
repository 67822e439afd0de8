"""On-device lockstep RL environment, batch-first.

Counterpart of humanoid_mujoco_tpu/rl/env.py (the reference's CPUEnv
under heavy domain randomization). A batch of B environments is one
`EnvState` of (B, ...) tensors on one device, stepped in lockstep by the
port's `step` (kernels B1 and B2 on the card).

Domain randomization draws nine model leaves per environment
(`ModelPatch`); `ModelPatch.apply(base)` grafts them, batch-first, onto
the shared base model, and the smooth kernel takes them as per-env
parameter packs (the TPU kernel's `params_batched`). Sensor and action
delays are fixed-capacity shift buffers with a per-env integer delay,
read by a one-hot mask.

Randomness is kept apart from the arithmetic. `env_reset`, `env_step`
and `env_auto_reset` take their draws as tensors (`ResetDraws`,
`StepDraws`, documented shapes), so that a caller can feed any draws,
such as the JAX package's own, bit for bit; `draw_reset` and
`draw_step` draw them from a `torch.Generator` on the env's device, and
`batch_reset` and `batch_step` draw and call.

Observation (30-D, in the reference's actuator order):
  [12 noisy joint angles | 12 noisy joint velocities |
   3 noisy torso angular velocity | 3 local gravity from the noisy torso
   quaternion], each read through its delay buffer.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..physics import math as pm
from ..physics.humanoid import (ACTUATED_JOINT_ORDER, STAND_POS, STAND_QUAT,
                                STANDUP_POS, STANDUP_QUAT, build_humanoid)
from ..physics.model import ActuatorType, JointType, Model, State, make_state
from ..physics.engine import fwd_position
from ..physics.step import step
from .rewards import control_input_reward, standup_reward

# the reference's simulation_parameters.py constants
_MIN_DELAY, _MAX_DELAY = 0.01, 0.05
_MASS_CHANGE = 0.05
_EXT_MASS = 0.2
_FORCE_DUR = (0.05, 0.15)
_FORCE_MAG = (5.0, 15.0)
_FORCE_INTERVAL = (1.0, 3.0)
_JOINT_OFFSET_MAX = 0.2
_Z_OFFSET_MAX = 0.1
_QUAT_OFFSET_MAX = 0.1
_ARMATURE_CHANGE = 0.0005
_RANGE_CHANGE = 0.1
_MARGIN_CHANGE = 0.05
_FORCE_LIMIT_CHANGE = 0.05
_P_GAIN = 2.0
_P_GAIN_CHANGE = 0.5
_ANGLE_NOISE = 2.0 / 180.0 * math.pi
_VEL_NOISE = 5.0 / 180.0 * math.pi
_IMU_NOISE = 5.0 / 180.0 * math.pi
_GYRO_NOISE = 2.0 / 180.0 * math.pi
_ACTION_NOISE = 0.5 / 180.0 * math.pi
_FLOOR_FRICTION_MULT = (0.5, 1.0)
_MAX_BUMP = 0.1
_NOISE_OCTAVES = 3         # fractal heightfield: grids of 3, 4 and 6

DELAY_CAP = 26             # ceil(50 ms / 2 ms) + 1


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    standup: bool = True
    physics_steps_per_control: int = 1
    use_potential_rewards: bool = False
    use_control_inputs: bool = False
    max_sim_time: float = 10.0


@dataclasses.dataclass(frozen=True)
class ModelPatch:
    """The domain-randomized model leaves, the only per-env model state,
    batch-first. `apply(base)` puts them on the shared base model."""

    floor_friction: torch.Tensor   # (B,)
    body_mass: torch.Tensor        # (B, nbody)
    dof_armature: torch.Tensor     # (B, nv)
    jnt_stiffness: torch.Tensor    # (B, njnt)
    jnt_margin: torch.Tensor       # (B, njnt)
    jnt_range: torch.Tensor        # (B, njnt, 2)
    act_kp: torch.Tensor           # (B, nu)
    act_forcerange: torch.Tensor   # (B, nu, 2)
    hfield_data: torch.Tensor      # (B, nhrow, nhcol)

    def apply(self, base: Model) -> Model:
        return base.replace(**{f.name: getattr(self, f.name)
                               for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class EnvState:
    """A batch of environments, (B, ...) throughout."""

    patch: ModelPatch
    phys: State
    rf: torch.Tensor              # (B,) randomization factor in [0, 1]
    step_count: torch.Tensor      # (B,) int32 control steps since reset
    # delay shift buffers (newest last) and their per-env delays
    buf_action: torch.Tensor      # (B, CAP, nu)
    buf_jpos: torch.Tensor        # (B, CAP, 12)
    buf_jvel: torch.Tensor        # (B, CAP, 12)
    buf_angvel: torch.Tensor      # (B, CAP, 3)
    buf_gravity: torch.Tensor     # (B, CAP, 3)
    d_action: torch.Tensor        # (B,) int32
    d_joint: torch.Tensor
    d_angvel: torch.Tensor
    d_gravity: torch.Tensor
    prev_action: torch.Tensor     # (B, nu)
    latest_action: torch.Tensor   # (B, nu)
    prev_reward: torch.Tensor     # (B,) for potential rewards
    target_velocity: torch.Tensor  # (B, 2)
    target_yaw: torch.Tensor       # (B, 1)
    # external force schedule
    force_start: torch.Tensor      # (B,)
    force_duration: torch.Tensor   # (B,)
    force_magnitude: torch.Tensor  # (B,)
    force_dir: torch.Tensor        # (B, 2)
    force_body: torch.Tensor       # (B,) int32

    @property
    def batch(self) -> int:
        return self.rf.shape[0]


@dataclasses.dataclass(frozen=True)
class ResetDraws:
    """The draws of a reset of B envs: uniforms in [0, 1) in the model's
    dtype, except `ext_body` (int64 in [1, nbody)) and `obs` (standard
    normals). Shapes: friction (B,), mass (B, nbody), ext_body (B,),
    ext_mass (B,), armature (B, nv), margin (B, njnt), range (B, njnt,
    2), kp (B, nu), forcerange (B, nu, 2), noise the fractal octaves'
    coarse grids (B, 3, 3), (B, 4, 4), (B, 6, 6); z (B,), quat (B, 4),
    joint (B, 12), delay (B, 4) [action, joint, angvel, gravity],
    target_velocity (B, 2), target_yaw (B, 1) (read only with
    `use_control_inputs`), obs (B, 31)."""

    friction: torch.Tensor
    mass: torch.Tensor
    ext_body: torch.Tensor
    ext_mass: torch.Tensor
    armature: torch.Tensor
    margin: torch.Tensor
    range: torch.Tensor
    kp: torch.Tensor
    forcerange: torch.Tensor
    noise: Tuple[torch.Tensor, ...]
    z: torch.Tensor
    quat: torch.Tensor
    joint: torch.Tensor
    delay: torch.Tensor
    target_velocity: torch.Tensor
    target_yaw: torch.Tensor
    obs: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """The draws of one control step of B envs: action (B, nu) and obs
    (B, 31) standard normals, force (B, 6) uniforms in [0, 1) [start,
    duration, magnitude, direction x, y, body]."""

    action: torch.Tensor
    force: torch.Tensor
    obs: torch.Tensor


def rl_humanoid_model(dtype=torch.float32, device=None) -> Model:
    """The RL variant of the humanoid: the reference env rewrites the
    motor actuators into position servos, gain kp 2, kv 0, ctrl range
    ±π/2."""
    m = build_humanoid(dtype=dtype, device=device)
    s = m.struct
    new_struct = dataclasses.replace(
        s, act_type=tuple(ActuatorType.POSITION for _ in range(s.nu)))
    return dataclasses.replace(
        m, struct=new_struct,
        act_kp=torch.full((s.nu,), _P_GAIN, dtype=dtype, device=m.device),
        act_kv=torch.zeros((s.nu,), dtype=dtype, device=m.device),
        act_ctrlrange=torch.tensor(
            [-math.pi / 2, math.pi / 2], dtype=dtype,
            device=m.device).repeat(s.nu, 1))


def _joint_indices(m: Model):
    """qpos and dof indices (tensors) of the actuated joints, in the
    reference's actuator order."""
    def build():
        s = m.struct
        jids = [s.jnt_id(n) for n in ACTUATED_JOINT_ORDER]
        return tuple(torch.tensor([a[j] for j in jids], device=m.device)
                     for a in (s.jnt_qadr, s.jnt_vadr))
    return m.struct_static(("rl_joint_indices", m.device), build)


def _u(x, lo, hi):
    """A unit uniform mapped to [lo, hi), as jax.random.uniform does."""
    return x * (hi - lo) + lo


@functools.lru_cache(maxsize=None)
def const(values, dtype, device) -> torch.Tensor:
    """A constant tensor, made once per dtype and device: no host-to-
    device copy on the step path."""
    return torch.tensor(values, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _noise_grid(o: int, n: int, dtype, device):
    """Static bilinear upsampling of octave o's (res + 1)-point grid to n
    points: (lower index, fraction)."""
    res = 2 ** o + 1
    g = np.linspace(0.0, res - 1e-6, n)
    i0 = np.floor(g).astype(np.int64)
    return (torch.tensor(i0, device=device),
            torch.tensor(g - i0, dtype=dtype, device=device))


def _fractal_noise(coarse, shape):
    """Value-noise octaves on the (nr, nc) grid, scaled to [0, 1] per env
    (the JAX package's stand-in for the reference's 8×8 Perlin field).
    coarse: octave o's grid (B, res + 1, res + 1), res = 2**o + 1."""
    nr, nc = shape
    total = 0.0
    amp = 1.0
    for o, c in enumerate(coarse):
        y0, fy = _noise_grid(o, nr, c.dtype, c.device)
        x0, fx = _noise_grid(o, nc, c.dtype, c.device)
        y0, fy, x0, fx = y0[:, None], fy[:, None], x0[None, :], fx[None, :]
        c00, c01 = c[:, y0, x0], c[:, y0, x0 + 1]
        c10, c11 = c[:, y0 + 1, x0], c[:, y0 + 1, x0 + 1]
        layer = (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
                 + c10 * fy * (1 - fx) + c11 * fy * fx)
        total = total + amp * layer
        amp *= 0.5
    total = total - total.amin(dim=(1, 2), keepdim=True)
    return total / torch.clamp(total.amax(dim=(1, 2), keepdim=True),
                               min=1e-9)


def _randomize_model(base: Model, rf, d: ResetDraws) -> ModelPatch:
    """Per-env model randomization (the reference's cpu_env.py:189-285):
    only the randomized leaves, (B, ...)."""
    s = base.struct
    B = rf.shape[0]
    r1 = rf[:, None]
    r2 = rf[:, None, None]
    fric_mult = (1.0 - rf) + _u(d.friction, *_FLOOR_FRICTION_MULT) * rf
    floor_friction = base.floor_friction * fric_mult
    # per-body mass ± 0.05 rf (the massless root stays exact), plus one
    # external mass on a random body
    dm = _u(d.mass, -_MASS_CHANGE, _MASS_CHANGE) * r1
    mass = torch.clamp(base.body_mass[1:] + dm[:, 1:], min=1e-5)
    mass = torch.cat([base.body_mass[:1].expand(B, 1), mass], dim=1)
    hit = torch.arange(s.nbody, device=rf.device) == d.ext_body[:, None]
    mass = mass + hit.to(mass.dtype) * (_u(d.ext_mass, 0.0, _EXT_MASS)
                                        * rf)[:, None]
    arm = base.dof_armature + _u(d.armature, 0.0, _ARMATURE_CHANGE) * r1
    margin = base.jnt_margin + _u(d.margin, 0.0, _MARGIN_CHANGE) * r1
    jrange = base.jnt_range + _u(d.range, -_RANGE_CHANGE, _RANGE_CHANGE) * r2
    # the reference ships a joint-stiffness change of 0
    stiff = base.jnt_stiffness.expand(B, s.njnt).clone()
    kp = _P_GAIN + _u(d.kp, -_P_GAIN_CHANGE, _P_GAIN_CHANGE) * r1
    frange = base.act_forcerange + _u(d.forcerange, -_FORCE_LIMIT_CHANGE,
                                      _FORCE_LIMIT_CHANGE) * r2
    hfield = _fractal_noise(d.noise, (s.nhrow, s.nhcol)) * (_MAX_BUMP * r2)
    return ModelPatch(
        floor_friction=floor_friction, body_mass=mass, dof_armature=arm,
        jnt_stiffness=stiff, jnt_margin=margin, jnt_range=jrange,
        act_kp=kp, act_forcerange=frange, hfield_data=hfield)


def _sample_delays(rf, u):
    """Four delays in control steps from uniforms u (B, 4); rounded half
    to even, as jnp.round."""
    lo = (_MIN_DELAY * rf)[:, None]
    hi = (_MAX_DELAY * rf + 1e-9)[:, None]
    return torch.round(_u(u, lo, hi) / 0.002).to(torch.int32)


def _initial_qpos(cfg: EnvConfig, m: Model, rf, d: ResetDraws):
    """The reset pose (B, 19): the root at the (standup or stand) pose
    raised and tilted, the 12 hinges offset, all scaled by rf."""
    dev, dtype = m.device, m.dtype
    pos0 = STANDUP_POS if cfg.standup else STAND_POS
    quat0 = STANDUP_QUAT if cfg.standup else STAND_QUAT
    z = _u(d.z, 0.0, _Z_OFFSET_MAX * rf)
    pos = const(pos0, dtype, dev) + torch.stack(
        [torch.zeros_like(z), torch.zeros_like(z), z], dim=1)
    quat = const(quat0, dtype, dev) + _u(
        d.quat, -_QUAT_OFFSET_MAX, _QUAT_OFFSET_MAX) * rf[:, None]
    quat = quat / pm.safe_norm(quat, keepdim=True)
    # the hinges' neutral angle (qpos0) is 0
    joints = _u(d.joint, -_JOINT_OFFSET_MAX, _JOINT_OFFSET_MAX) * rf[:, None]
    return torch.cat([pos, quat, joints], dim=1)


def env_reset(cfg: EnvConfig, base: Model, rf, d: ResetDraws
              ) -> Tuple[EnvState, torch.Tensor]:
    """Reset B envs from the draws `d`: randomize the model and the
    state; returns (state, obs (B, 30)). rf: a number or (B,)."""
    dtype, dev = base.dtype, base.device
    B = d.z.shape[0]
    rf = torch.as_tensor(rf, dtype=dtype, device=dev).expand(B)
    patch = _randomize_model(base, rf, d)
    m = patch.apply(base)
    phys = make_state(m, qpos=_initial_qpos(cfg, m, rf, d))
    delays = _sample_delays(rf, d.delay)
    if cfg.use_control_inputs:
        tv = _u(d.target_velocity, -2.0, 2.0)
        ty = _u(d.target_yaw, -math.pi, math.pi)
    else:
        tv = torch.zeros((B, 2), dtype=dtype, device=dev)
        ty = torch.zeros((B, 1), dtype=dtype, device=dev)
    nu = base.nu

    def zeros(*shape):
        return torch.zeros((B,) + shape, dtype=dtype, device=dev)
    gravity = const((0.0, 0.0, -1.0), dtype, dev)
    es = EnvState(
        patch=patch, phys=phys, rf=rf.clone(),
        step_count=torch.zeros(B, dtype=torch.int32, device=dev),
        buf_action=zeros(DELAY_CAP, nu), buf_jpos=zeros(DELAY_CAP, 12),
        buf_jvel=zeros(DELAY_CAP, 12), buf_angvel=zeros(DELAY_CAP, 3),
        buf_gravity=gravity.expand(B, DELAY_CAP, 3).clone(),
        d_action=delays[:, 0], d_joint=delays[:, 1],
        d_angvel=delays[:, 2], d_gravity=delays[:, 3],
        prev_action=zeros(nu), latest_action=zeros(nu), prev_reward=zeros(),
        target_velocity=tv, target_yaw=ty,
        force_start=zeros(), force_duration=zeros(), force_magnitude=zeros(),
        force_dir=zeros(2),
        force_body=torch.ones(B, dtype=torch.int32, device=dev))
    return es, _observe(cfg, m, es, d.obs)[1]


def _ring_push_read(buf, value, delay):
    """Push `value` (B, n) as the newest entry of `buf` (B, CAP, n) and
    read the entry `delay` (B,) steps old. Entries not yet written still
    hold the reset-time fill (the reference's pre-filled delay queues).
    A shift and a one-hot read (the JAX package's form)."""
    cap = buf.shape[1]
    buf = torch.cat([buf[:, 1:], value[:, None]], dim=1)
    idx = cap - 1 - torch.clamp(delay, 0, cap - 1)
    onehot = (torch.arange(cap, device=buf.device)
              == idx[:, None]).to(buf.dtype)
    return buf, torch.sum(onehot[:, :, None] * buf, dim=1)


def _observe(cfg: EnvConfig, m: Model, es: EnvState, eps,
             torso_quat: Optional[torch.Tensor] = None):
    """The noisy, delayed 30-D observation, eps (B, 31) standard
    normals. `torso_quat` (B, 4) reuses the step's kinematics."""
    qadr, vadr = _joint_indices(m)
    qpos, qvel = es.phys.qpos, es.phys.qvel
    rf = es.rf[:, None]
    jpos = qpos[:, qadr] + rf * _ANGLE_NOISE * eps[:, 0:12]
    jvel = qvel[:, vadr] + rf * _VEL_NOISE * eps[:, 12:24]
    # qvel[3:6], the free joint's local-frame angular velocity, as the
    # reference reads it
    angvel = qvel[:, 3:6] + rf * _GYRO_NOISE * eps[:, 24:27]
    if torso_quat is None:
        torso_quat = _torso_quat(m, es)
    noisy = torso_quat + rf * _IMU_NOISE * eps[:, 27:31]
    gravity = pm.quat_rotate_inv(
        noisy / pm.safe_norm(noisy, keepdim=True),
        const((0.0, 0.0, -1.0), noisy.dtype, noisy.device))
    buf_jpos, jpos_d = _ring_push_read(es.buf_jpos, jpos, es.d_joint)
    buf_jvel, jvel_d = _ring_push_read(es.buf_jvel, jvel, es.d_joint)
    buf_av, av_d = _ring_push_read(es.buf_angvel, angvel, es.d_angvel)
    buf_g, g_d = _ring_push_read(es.buf_gravity, gravity, es.d_gravity)
    es = dataclasses.replace(es, buf_jpos=buf_jpos, buf_jvel=buf_jvel,
                             buf_angvel=buf_av, buf_gravity=buf_g)
    return es, torch.cat([jpos_d, jvel_d, av_d, g_d], dim=-1)


def _torso_quat(m: Model, es: EnvState):
    """The torso's world quaternion (B, 4) without forward kinematics of
    the whole tree: the free joint's quaternion, composed with the fixed
    frames of the jointless bodies from its body down to the torso (the
    humanoid's torso hangs off the free-joint root link)."""
    s = m.struct
    b = s.body_id("torso")
    chain = []
    while not s.body_joints[b] and s.body_parent[b] >= 0:
        chain.append(b)
        b = s.body_parent[b]
    joints = s.body_joints[b]
    if len(joints) != 1 or s.jnt_type[joints[0]] != JointType.FREE:
        return fwd_position(m, es.phys.qpos).xquat[:, s.body_id("torso")]
    a = s.jnt_qadr[joints[0]]
    q = pm.quat_normalize(es.phys.qpos[:, a + 3:a + 7])
    for c in reversed(chain):
        q = pm.quat_mul(q, m.body_quat[c])
    return q


def _update_forces(m: Model, es: EnvState, u6):
    """The external force schedule (the reference's cpu_env.py:618-654):
    every 1-3 s a random body is pushed horizontally with 5-15 N for
    0.05-0.15 s. u6 (B, 6) uniforms. Returns (state, xfrc (B, nbody,
    6)): a one-hot body row, no scatter."""
    nbody = m.struct.nbody
    t = es.phys.time
    expired = t >= es.force_start + es.force_duration
    new_start = t + (_FORCE_INTERVAL[0] + u6[:, 0]
                     * (_FORCE_INTERVAL[1] - _FORCE_INTERVAL[0]))
    new_dur = _FORCE_DUR[0] + u6[:, 1] * (_FORCE_DUR[1] - _FORCE_DUR[0])
    new_mag = (_FORCE_MAG[0] + u6[:, 2] * (_FORCE_MAG[1] - _FORCE_MAG[0])
               ) * es.rf
    dxy = 2.0 * u6[:, 3:5] - 1.0
    new_dir = dxy / pm.safe_norm(dxy, keepdim=True)
    new_body = (1 + torch.floor(u6[:, 5] * (nbody - 1))).to(torch.int32)
    new_body = torch.clamp(new_body, max=nbody - 1)
    start = torch.where(expired, new_start, es.force_start)
    dur = torch.where(expired, new_dur, es.force_duration)
    es = dataclasses.replace(
        es, force_start=start, force_duration=dur,
        force_magnitude=torch.where(expired, new_mag, es.force_magnitude),
        force_dir=torch.where(expired[:, None], new_dir, es.force_dir),
        force_body=torch.where(expired, new_body, es.force_body))
    active = (t > start) & (t < start + dur)
    f = torch.where(active, es.force_magnitude,
                    torch.zeros_like(es.force_magnitude))
    onehot = (torch.arange(nbody, device=t.device)
              == es.force_body[:, None]).to(t.dtype)
    fvec = torch.cat([f[:, None] * es.force_dir,
                      f.new_zeros((f.shape[0], 4))], dim=-1)
    return es, onehot[:, :, None] * fvec[:, None, :]


def _self_collision(m: Model, info) -> torch.Tensor:
    """Any self-collision pair slot in contact, (B,)."""
    nfloor = m.struct.n_floor_slots
    if m.ncon == nfloor:
        return torch.zeros(info.contact_dist.shape[0], dtype=torch.bool,
                           device=info.contact_dist.device)
    return torch.any(info.contact_dist[:, nfloor:] < 0.0, dim=-1)


def env_step(cfg: EnvConfig, base: Model, es: EnvState, action,
             d: StepDraws):
    """One control step of B envs from the draws `d`: returns (state',
    obs (B, 30), reward (B,), terminal (B,), truncated (B,))."""
    m = es.patch.apply(base)
    action = action.to(base.dtype) + es.rf[:, None] * _ACTION_NOISE * d.action
    buf_a, delayed = _ring_push_read(es.buf_action, action, es.d_action)
    es = dataclasses.replace(es, buf_action=buf_a,
                             prev_action=es.latest_action,
                             latest_action=delayed)
    es, xfrc = _update_forces(m, es, d.force)
    phys, info = es.phys, None
    for _ in range(cfg.physics_steps_per_control):
        phys, info = step(m, phys, delayed, xfrc=xfrc)
    es = dataclasses.replace(es, phys=phys, step_count=es.step_count + 1)
    _, vadr = _joint_indices(m)
    torso = m.struct.body_id("torso")
    reward_fn = standup_reward if cfg.standup else control_input_reward
    rr = reward_fn(
        velocity=phys.qvel[:, 0:3], target_velocity=es.target_velocity,
        torso_quat=info.xquat[:, torso], target_yaw=es.target_yaw,
        z_pos=info.xpos[:, torso, 2],
        joint_torques=info.qfrc_total[:, vadr],
        previous_ctrl=es.prev_action / (math.pi / 2),
        latest_ctrl=es.latest_action / (math.pi / 2),
        is_self_colliding=_self_collision(m, info), time=phys.time,
        max_simulation_time=cfg.max_sim_time)
    reward = rr.reward
    if cfg.use_potential_rewards:
        reward = rr.reward - es.prev_reward
        es = dataclasses.replace(es, prev_reward=rr.reward)
    es, obs = _observe(cfg, m, es, d.obs, torso_quat=info.xquat[:, torso])
    return es, obs, reward, rr.terminal, rr.truncated


def _where_tree(done, new, old):
    """torch.where(done, new, old) over every tensor leaf of two states
    (dataclasses of tensors), done (B,) broadcast over trailing axes."""
    if dataclasses.is_dataclass(old):
        return type(old)(**{
            f.name: _where_tree(done, getattr(new, f.name),
                                getattr(old, f.name))
            for f in dataclasses.fields(old)})
    return torch.where(done.reshape((-1,) + (1,) * (old.ndim - 1)), new, old)


def env_auto_reset(cfg: EnvConfig, base: Model, es: EnvState, obs, reward,
                   terminal, truncated, d: ResetDraws):
    """Reset-on-done (the DummyVecEnv auto-reset): every env is reset
    from the draws `d` at its own rf, and each leaf takes the reset value
    where the env is done; no host sync. Returns (state, obs, done)."""
    done = terminal | truncated
    es_new, obs_new = env_reset(cfg, base, es.rf, d)
    return (_where_tree(done, es_new, es),
            torch.where(done[:, None], obs_new, obs), done)


# ---------------------------------------------------------------------------
# the draws, from a torch.Generator on the env's device
# ---------------------------------------------------------------------------

def draw_reset(base: Model, n: int, generator) -> ResetDraws:
    """The draws of a reset of n envs (`ResetDraws`): one uniform and one
    normal block, sliced."""
    s = base.struct
    dev, dtype = base.device, base.dtype
    sizes = dict(friction=(), mass=(s.nbody,), ext_body=(), ext_mass=(),
                 armature=(s.nv,), margin=(s.njnt,), range=(s.njnt, 2),
                 kp=(s.nu,), forcerange=(s.nu, 2),
                 noise=[(2 ** o + 2,) * 2 for o in range(_NOISE_OCTAVES)],
                 z=(), quat=(4,), joint=(12,), delay=(4,),
                 target_velocity=(2,), target_yaw=(1,))
    flat = [(k, sh) for k, v in sizes.items()
            for sh in (v if isinstance(v, list) else [v])]
    total = sum(int(np.prod(sh)) for _, sh in flat)
    u = torch.rand((n, total), generator=generator, device=dev, dtype=dtype)
    out, at = {}, 0
    for k, sh in flat:
        w = int(np.prod(sh))
        x = u[:, at:at + w].reshape((n,) + sh)
        at += w
        if k == "noise":
            out[k] = out.get(k, ()) + (x,)
        else:
            out[k] = x
    out["ext_body"] = torch.clamp(
        1 + torch.floor(out["ext_body"] * (s.nbody - 1)).long(),
        max=s.nbody - 1)
    out["obs"] = torch.randn((n, 31), generator=generator, device=dev,
                             dtype=dtype)
    return ResetDraws(**out)


def draw_step(base: Model, n: int, generator) -> StepDraws:
    dev, dtype = base.device, base.dtype
    nrm = torch.randn((n, base.nu + 31), generator=generator, device=dev,
                      dtype=dtype)
    return StepDraws(
        action=nrm[:, :base.nu], obs=nrm[:, base.nu:],
        force=torch.rand((n, 6), generator=generator, device=dev,
                         dtype=dtype))


def batch_reset(cfg: EnvConfig, base: Model, rf, n_envs: int, generator):
    """Reset n_envs envs at randomization factor rf (a number or
    (n_envs,)), drawing from `generator`: (state, obs)."""
    return env_reset(cfg, base, rf, draw_reset(base, n_envs, generator))


def batch_step(cfg: EnvConfig, base: Model, es: EnvState, actions,
               generator):
    """Step the batch under actions (B, nu), drawing from `generator`:
    (state', obs, reward, terminal, truncated)."""
    return env_step(cfg, base, es, actions,
                    draw_step(base, es.batch, generator))


def env_state_from_jax(leaves, device=None, dtype=None) -> EnvState:
    """An EnvState from the arrays of a batched JAX `EnvState`: a mapping
    of its field names to numpy arrays, with `patch` and `phys` mappings
    of their own (`rng` is ignored: the port draws from a generator).
    Float arrays take `dtype` (default: as given), integer arrays int32."""
    from .. import resolve_device
    dev = resolve_device(device)

    def t(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return torch.tensor(x, dtype=torch.int32, device=dev)
        return torch.tensor(x, dtype=dtype, device=dev)
    kw = {}
    for f in dataclasses.fields(EnvState):
        v = leaves[f.name]
        if f.name == "patch":
            v = ModelPatch(**{g.name: t(v[g.name])
                              for g in dataclasses.fields(ModelPatch)})
        elif f.name == "phys":
            v = State(**{g.name: t(v[g.name])
                         for g in dataclasses.fields(State)})
        else:
            v = t(v)
        kw[f.name] = v
    return EnvState(**kw)


def env_state_to_dict(es: EnvState) -> dict:
    """The state as nested dicts of tensors (for a checkpoint)."""
    return {f.name: ({g.name: getattr(v, g.name)
                      for g in dataclasses.fields(v)}
                     if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(es) for v in [getattr(es, f.name)]}


def env_state_from_dict(d) -> EnvState:
    """The inverse of `env_state_to_dict`."""
    return EnvState(**{**d, "patch": ModelPatch(**d["patch"]),
                       "phys": State(**d["phys"])})
