"""Model description: static structure, float parameters, state.

Counterpart of humanoid_mujoco_tpu/physics/model.py. `Structure` is
plain static Python (the tree topology, joint types, dof bookkeeping,
contact-slot tables). `Model` holds the float parameters as tensors on
one device, shared by every environment of a batch. `ModelBuilder` is
the MJCF-compiler analog: it works in host-side numpy and turns only
the final arrays into tensors.

`State` is batch-leading: qpos (B, nq), qvel (B, nv), time (B,).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import resolve_device


class JointType:
    """Joint type codes (MuJoCo's mjtJoint order)."""

    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3


class ActuatorType:
    MOTOR = 0        # force = clip(ctrl); qfrc = gear * clip(force)
    POSITION = 1     # force = kp (ctrl - q) - kv qvel; qfrc = gear * clip
    SITE_THRUST = 2  # wrench ctrl * gear6 at a site


def _jnt_nq(t: int) -> int:
    return {JointType.FREE: 7, JointType.BALL: 4,
            JointType.SLIDE: 1, JointType.HINGE: 1}[t]


def _jnt_nv(t: int) -> int:
    return {JointType.FREE: 6, JointType.BALL: 3,
            JointType.SLIDE: 1, JointType.HINGE: 1}[t]


@dataclasses.dataclass(frozen=True)
class Structure:
    """Static topology (same fields as the JAX package's Structure)."""

    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    nsph: int
    npair: int
    nhrow: int
    nhcol: int

    body_parent: Tuple[int, ...]
    body_joints: Tuple[Tuple[int, ...], ...]
    jnt_type: Tuple[int, ...]
    jnt_body: Tuple[int, ...]
    jnt_qadr: Tuple[int, ...]
    jnt_vadr: Tuple[int, ...]
    jnt_limited: Tuple[bool, ...]
    dof_body: Tuple[int, ...]
    dof_jnt: Tuple[int, ...]
    dof_mask_bytes: bytes                 # (nv, nv) uint8 row-major
    body_dof_bytes: bytes                 # (nbody, nv) uint8: dof j moves b
    sph_body: Tuple[int, ...]
    pair_a: Tuple[int, ...]
    pair_b: Tuple[int, ...]
    act_type: Tuple[int, ...]
    act_jnt: Tuple[int, ...]
    act_site: Tuple[int, ...]
    body_names: Tuple[str, ...]
    jnt_names: Tuple[str, ...]
    site_names: Tuple[str, ...]
    site_body: Tuple[int, ...]
    has_floor: bool
    max_contacts: int = 0
    fluid_density: float = 0.0
    fluid_viscosity: float = 0.0
    act_site_world: Tuple[bool, ...] = ()
    has_gravcomp: bool = False
    ncap: int = 0
    nbox: int = 0
    cap_body: Tuple[int, ...] = ()
    box_body: Tuple[int, ...] = ()
    pair_sc: Tuple[Tuple[int, int], ...] = ()
    pair_cc: Tuple[Tuple[int, int], ...] = ()
    pair_sb: Tuple[Tuple[int, int], ...] = ()
    pair_cb: Tuple[Tuple[int, int], ...] = ()
    pair_bb: Tuple[Tuple[int, int], ...] = ()
    sph_floor: Tuple[bool, ...] = ()
    cap_floor: Tuple[bool, ...] = ()
    box_floor: Tuple[bool, ...] = ()
    tendon_jnt: Tuple[Tuple[int, ...], ...] = ()
    tendon_coef: Tuple[Tuple[float, ...], ...] = ()
    slot_body_a: Tuple[int, ...] = ()
    slot_body_b: Tuple[int, ...] = ()

    @property
    def ntendon(self) -> int:
        return len(self.tendon_jnt)

    @property
    def n_floor_slots(self) -> int:
        return self.nsph + 2 * self.ncap + 8 * self.nbox

    @property
    def dof_mask(self) -> np.ndarray:
        return np.frombuffer(self.dof_mask_bytes, dtype=np.uint8).reshape(
            self.nv, self.nv)

    @property
    def body_dof(self) -> np.ndarray:
        return np.frombuffer(self.body_dof_bytes, dtype=np.uint8).reshape(
            self.nbody, self.nv)

    def body_id(self, name: str) -> int:
        return self.body_names.index(name)

    def jnt_id(self, name: str) -> int:
        return self.jnt_names.index(name)

    def site_id(self, name: str) -> int:
        return self.site_names.index(name)


# float leaves of Model, in declaration order (sol_iter is the int leaf)
_LEAVES = (
    "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass",
    "body_inertia", "jnt_pos", "jnt_axis", "jnt_range", "jnt_stiffness",
    "jnt_springref", "jnt_margin", "qpos_spring", "dof_damping",
    "dof_armature", "act_gear", "act_gear6", "act_kp", "act_kv",
    "act_ctrlrange", "act_forcerange", "body_gravcomp", "site_pos",
    "sph_pos", "sph_radius", "sph_friction", "sph_friction_tor",
    "sph_friction_roll", "floor_z", "floor_friction", "floor_friction_tor",
    "floor_friction_roll", "hfield_data", "hfield_halfsize", "dt",
    "gravity", "solref", "solimp", "limit_solref", "limit_solimp",
    "cap_pos", "cap_axis", "cap_halflen", "cap_radius", "cap_friction",
    "cap_friction_tor", "cap_friction_roll", "box_pos", "box_quat",
    "box_size", "box_friction", "box_friction_tor", "box_friction_roll",
    "tendon_range",
)


# number of dimensions of each float leaf when it is shared by the batch;
# a leaf with one more carries a leading env axis (B, ...): the per-env
# parameters of a domain-randomized batch (rl/env.py ModelPatch)
LEAF_NDIM = dict(
    body_pos=2, body_quat=2, body_ipos=2, body_iquat=2, body_mass=1,
    body_inertia=2, jnt_pos=2, jnt_axis=2, jnt_range=2, jnt_stiffness=1,
    jnt_springref=1, jnt_margin=1, qpos_spring=1, dof_damping=1,
    dof_armature=1, act_gear=1, act_gear6=2, act_kp=1, act_kv=1,
    act_ctrlrange=2, act_forcerange=2, body_gravcomp=1, site_pos=2,
    sph_pos=2, sph_radius=1, sph_friction=1, sph_friction_tor=1,
    sph_friction_roll=1, floor_z=0, floor_friction=0, floor_friction_tor=0,
    floor_friction_roll=0, hfield_data=2, hfield_halfsize=1, dt=0,
    gravity=1, solref=1, solimp=1, limit_solref=1, limit_solimp=1,
    cap_pos=2, cap_axis=2, cap_halflen=1, cap_radius=1, cap_friction=1,
    cap_friction_tor=1, cap_friction_roll=1, box_pos=2, box_quat=2,
    box_size=2, box_friction=1, box_friction_tor=1, box_friction_roll=1,
    tendon_range=2)
assert tuple(LEAF_NDIM) == _LEAVES

# tables that depend only on a Structure (and the device or dtype named
# in their key), shared by every Model built on that Structure object
_STRUCT_CACHE = WeakIdKeyDictionary()


@dataclasses.dataclass(frozen=True)
class Model:
    """Float parameters (tensors on one device) + static structure.

    Every leaf is shared by the batch, except that a leaf may carry a
    leading env axis (B, ...) (`LEAF_NDIM`): the domain-randomized
    parameters of an RL batch. The kernel wrappers cache what they
    derive from the leaves (B1's parameter packs) in `cache`, per model:
    derive a new model with `replace` (or `dataclasses.replace`, which
    also starts an empty cache) and never edit a leaf in place once a
    kernel has seen the model, or the kernel runs the stale packs.
    """

    struct: Structure
    body_pos: torch.Tensor       # (nbody, 3) frame offset in parent frame
    body_quat: torch.Tensor      # (nbody, 4)
    body_ipos: torch.Tensor      # (nbody, 3) COM in body frame
    body_iquat: torch.Tensor     # (nbody, 4) inertial frame rotation
    body_mass: torch.Tensor      # (nbody,)
    body_inertia: torch.Tensor   # (nbody, 3) diagonal in inertial frame
    jnt_pos: torch.Tensor        # (njnt, 3) anchor in body frame
    jnt_axis: torch.Tensor       # (njnt, 3)
    jnt_range: torch.Tensor      # (njnt, 2)
    jnt_stiffness: torch.Tensor  # (njnt,)
    jnt_springref: torch.Tensor  # (njnt,)
    jnt_margin: torch.Tensor     # (njnt,)
    qpos_spring: torch.Tensor    # (nq,) spring reference configuration
    dof_damping: torch.Tensor    # (nv,)
    dof_armature: torch.Tensor   # (nv,)
    act_gear: torch.Tensor       # (nu,)
    act_gear6: torch.Tensor      # (nu, 6)
    act_kp: torch.Tensor         # (nu,)
    act_kv: torch.Tensor         # (nu,)
    act_ctrlrange: torch.Tensor  # (nu, 2)
    act_forcerange: torch.Tensor  # (nu, 2)
    body_gravcomp: torch.Tensor  # (nbody,)
    site_pos: torch.Tensor       # (nsite, 3)
    sph_pos: torch.Tensor        # (nsph, 3)
    sph_radius: torch.Tensor     # (nsph,)
    sph_friction: torch.Tensor
    sph_friction_tor: torch.Tensor
    sph_friction_roll: torch.Tensor
    floor_z: torch.Tensor        # ()
    floor_friction: torch.Tensor
    floor_friction_tor: torch.Tensor
    floor_friction_roll: torch.Tensor
    hfield_data: torch.Tensor    # (nhrow, nhcol)
    hfield_halfsize: torch.Tensor  # (2,)
    dt: torch.Tensor             # ()
    gravity: torch.Tensor        # (3,)
    solref: torch.Tensor         # (2,)
    solimp: torch.Tensor         # (3,)
    limit_solref: torch.Tensor   # (2,)
    limit_solimp: torch.Tensor   # (3,)
    cap_pos: torch.Tensor
    cap_axis: torch.Tensor
    cap_halflen: torch.Tensor
    cap_radius: torch.Tensor
    cap_friction: torch.Tensor
    cap_friction_tor: torch.Tensor
    cap_friction_roll: torch.Tensor
    box_pos: torch.Tensor
    box_quat: torch.Tensor
    box_size: torch.Tensor
    box_friction: torch.Tensor
    box_friction_tor: torch.Tensor
    box_friction_roll: torch.Tensor
    tendon_range: torch.Tensor
    sol_iter: torch.Tensor       # () int32
    # per-model derived data (parameter packs), built on first use by
    # the kernel wrappers; not an __init__ argument, so every `replace`
    # and every dataclasses.replace starts an empty one
    cache: Dict[str, object] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def replace(self, **kw) -> "Model":
        return dataclasses.replace(self, **kw)

    @property
    def nq(self) -> int:
        return self.struct.nq

    @property
    def nv(self) -> int:
        return self.struct.nv

    @property
    def nu(self) -> int:
        return self.struct.nu

    @property
    def device(self) -> torch.device:
        return self.body_pos.device

    @property
    def dtype(self) -> torch.dtype:
        return self.body_pos.dtype

    @property
    def ncon(self) -> int:
        s = self.struct
        return (s.n_floor_slots + s.npair + len(s.pair_sc)
                + len(s.pair_cc) + len(s.pair_sb) + len(s.pair_cb)
                + 16 * len(s.pair_bb))

    @property
    def env_batch(self) -> Optional[int]:
        """The env axis of the per-env leaves, or None when every leaf is
        shared."""
        return self.static("env_batch", lambda: next(
            (getattr(self, k).shape[0] for k, n in LEAF_NDIM.items()
             if getattr(self, k).ndim > n), None))

    def per_env(self, name: str) -> bool:
        """Whether leaf `name` carries the leading env axis."""
        return getattr(self, name).ndim > LEAF_NDIM[name]

    def static(self, key, build):
        """`build()` once per model and key (what depends on the leaves:
        the kernels' parameter packs)."""
        if key not in self.cache:
            self.cache[key] = build()
        return self.cache[key]

    def struct_static(self, key, build):
        """`build()` once per Structure object and key (what depends only
        on the structure: kernel tables, masks; name the device or dtype
        in `key` when the value is a tensor). Shared by every model on
        the structure, such as the patched model of each RL env step."""
        c = _STRUCT_CACHE.get(self.struct)
        if c is None:
            c = _STRUCT_CACHE[self.struct] = {}
        if key not in c:
            c[key] = build()
        return c[key]

    def body_dof_t(self, dtype: torch.dtype) -> torch.Tensor:
        """Structure.body_dof (nbody, nv) as a float tensor."""
        return self.struct_static(
            ("body_dof", dtype, self.device), lambda: torch.tensor(
                self.struct.body_dof, dtype=dtype, device=self.device))


def model_from_jax_leaves(struct: Structure,
                          leaves: Dict[str, np.ndarray],
                          device=None) -> Model:
    """A Model from the float leaves of a JAX `Model`, taken as numpy
    arrays (`{name: np.asarray(getattr(jax_model, name))}`), so both
    packages can run on one parameter set. `sol_iter` may be included."""
    dev = resolve_device(device)
    missing = [k for k in _LEAVES if k not in leaves]
    if missing:
        raise KeyError(f"missing model leaves: {missing}")
    kw = {k: torch.tensor(np.asarray(leaves[k]), device=dev)
          for k in _LEAVES}
    sol_iter = leaves.get("sol_iter", 20)
    kw["sol_iter"] = torch.tensor(np.asarray(sol_iter), dtype=torch.int32,
                                  device=dev)
    return Model(struct=struct, **kw)


class ModelBuilder:
    """Programmatic model construction (the MJCF-compiler analog)."""

    def __init__(self, dt: float = 0.002, gravity=(0.0, 0.0, -9.81)):
        self.dt = dt
        self.gravity = gravity
        self._bodies: List[dict] = []
        self._joints: List[dict] = []
        self._acts: List[dict] = []
        self._sphs: List[dict] = []
        self._caps: List[dict] = []
        self._boxes: List[dict] = []
        self._pairs: List[Tuple[int, int]] = []
        self._pairs_sc: List[Tuple[int, int]] = []
        self._pairs_cc: List[Tuple[int, int]] = []
        self._pairs_sb: List[Tuple[int, int]] = []
        self._pairs_cb: List[Tuple[int, int]] = []
        self._pairs_bb: List[Tuple[int, int]] = []
        self._tendons: List[dict] = []
        self._sites: List[dict] = []
        self.floor_z = 0.0
        self.floor_friction = 1.0
        self.floor_friction_tor = 0.005
        self.floor_friction_roll = 0.0001
        self.has_floor = True
        self.max_contacts = 0
        self.fluid_density = 0.0     # MJCF <option density>
        self.fluid_viscosity = 0.0   # MJCF <option viscosity>
        self.hfield_shape = (2, 2)
        self.hfield_halfsize = (10.0, 10.0)
        self.solref = (0.015, 1.0)
        self.solimp = (0.9, 0.99, 0.003)
        self.limit_solref = (0.004, 1.0)
        self.limit_solimp = (0.95, 0.99, 0.001)
        self.sol_iter = 20

    def add_body(self, name: str, parent: int, pos=(0, 0, 0),
                 quat=(1, 0, 0, 0), mass: float = 0.0,
                 ipos=(0, 0, 0), iquat=(1, 0, 0, 0),
                 inertia=(0, 0, 0), gravcomp: float = 0.0) -> int:
        self._bodies.append(dict(name=name, parent=parent, pos=pos, quat=quat,
                                 mass=mass, ipos=ipos, iquat=iquat,
                                 inertia=inertia, gravcomp=gravcomp))
        return len(self._bodies) - 1

    def add_joint(self, name: str, body: int, jtype: int, axis=(0, 0, 1),
                  pos=(0, 0, 0), jrange=(0.0, 0.0), limited=False,
                  damping: float = 0.0, armature: float = 0.0,
                  stiffness: float = 0.0, springref: float = 0.0,
                  margin: float = 0.0) -> int:
        self._joints.append(dict(name=name, body=body, jtype=jtype, axis=axis,
                                 pos=pos, jrange=jrange, limited=limited,
                                 damping=damping, armature=armature,
                                 stiffness=stiffness, springref=springref,
                                 margin=margin))
        return len(self._joints) - 1

    def add_actuator(self, joint: int, atype: int = ActuatorType.MOTOR,
                     gear: float = 1.0, kp: float = 1.0, kv: float = 0.0,
                     ctrlrange=(-1.0, 1.0), forcerange=(-1.0, 1.0)) -> int:
        self._acts.append(dict(joint=joint, atype=atype, gear=gear, kp=kp,
                               kv=kv, ctrlrange=ctrlrange,
                               forcerange=forcerange))
        return len(self._acts) - 1

    def add_thrust(self, site: int, gear=(0.0, 0.0, 1.0, 0.0, 0.0, 0.0),
                   ctrlrange=(0.0, 1.0), forcerange=(-1e9, 1e9),
                   world_frame: bool = False) -> int:
        """Site actuator: the wrench ctrl * gear6 at the site point, in
        the site body's frame or, with `world_frame`, in the world frame
        (the quadrotor's rotors; the Panda's Cartesian actuators)."""
        self._acts.append(dict(joint=-1, atype=ActuatorType.SITE_THRUST,
                               gear=1.0, kp=0.0, kv=0.0,
                               ctrlrange=ctrlrange, forcerange=forcerange,
                               site=site, gear6=tuple(gear),
                               world_frame=bool(world_frame)))
        return len(self._acts) - 1

    def add_sphere(self, body: int, pos=(0, 0, 0), radius: float = 0.02,
                   friction: float = 1.0, friction_tor: float = 0.005,
                   friction_roll: float = 0.0001,
                   floor: bool = True) -> int:
        self._sphs.append(dict(body=body, pos=pos, radius=radius,
                               friction=friction, friction_tor=friction_tor,
                               friction_roll=friction_roll,
                               floor=bool(floor)))
        return len(self._sphs) - 1

    def add_capsule(self, body: int, p0=(0, 0, 0), p1=(0, 0, 1),
                    radius: float = 0.02, friction: float = 1.0,
                    friction_tor: float = 0.005,
                    friction_roll: float = 0.0001,
                    floor: bool = True) -> int:
        """Capsule from its segment's endpoints in the body frame (the
        MJCF fromto convention)."""
        p0 = np.asarray(p0, dtype=np.float64)
        p1 = np.asarray(p1, dtype=np.float64)
        d = p1 - p0
        halflen = 0.5 * float(np.linalg.norm(d))
        self._caps.append(dict(body=body, pos=tuple(0.5 * (p0 + p1)),
                               axis=tuple(d / max(2 * halflen, 1e-12)),
                               halflen=halflen, radius=radius,
                               friction=friction, friction_tor=friction_tor,
                               friction_roll=friction_roll,
                               floor=bool(floor)))
        return len(self._caps) - 1

    def add_box(self, body: int, pos=(0, 0, 0), quat=(1, 0, 0, 0),
                size=(0.1, 0.1, 0.1), friction: float = 1.0,
                friction_tor: float = 0.005, friction_roll: float = 0.0001,
                floor: bool = True) -> int:
        """Box of half-extents `size`, posed in the body frame."""
        self._boxes.append(dict(body=body, pos=pos, quat=quat, size=size,
                                friction=friction,
                                friction_tor=friction_tor,
                                friction_roll=friction_roll,
                                floor=bool(floor)))
        return len(self._boxes) - 1

    def add_pair(self, sph_a: int, sph_b: int):
        self._pairs.append((sph_a, sph_b))

    def add_pair_sc(self, sph: int, cap: int):
        self._pairs_sc.append((sph, cap))

    def add_pair_cc(self, cap_a: int, cap_b: int):
        self._pairs_cc.append((cap_a, cap_b))

    def add_pair_sb(self, sph: int, box: int):
        self._pairs_sb.append((sph, box))

    def add_pair_cb(self, cap: int, box: int):
        self._pairs_cb.append((cap, box))

    def add_pair_bb(self, box_a: int, box_b: int):
        self._pairs_bb.append((box_a, box_b))

    def add_tendon_limit(self, joints: Sequence[int],
                         coefs: Sequence[float], trange: Tuple[float, float]):
        """Fixed-tendon length limit lo <= Σ coef_i qpos[jnt_i] <= hi
        (MJCF <fixed limited="true">: the humanoid's hamstrings)."""
        self._tendons.append(dict(joints=tuple(int(j) for j in joints),
                                  coefs=tuple(float(c) for c in coefs),
                                  range=(float(trange[0]),
                                         float(trange[1]))))

    def add_site(self, name: str, body: int, pos=(0, 0, 0)) -> int:
        self._sites.append(dict(name=name, body=body, pos=pos))
        return len(self._sites) - 1

    def finalize(self, dtype=torch.float32, device=None) -> Model:
        dev = resolve_device(device)
        nbody = len(self._bodies)
        njnt = len(self._joints)
        nq = nv = 0
        jnt_qadr, jnt_vadr = [], []
        dof_body, dof_jnt = [], []
        for j, jd in enumerate(self._joints):
            jnt_qadr.append(nq)
            jnt_vadr.append(nv)
            nq += _jnt_nq(jd["jtype"])
            for _ in range(_jnt_nv(jd["jtype"])):
                dof_body.append(jd["body"])
                dof_jnt.append(j)
            nv += _jnt_nv(jd["jtype"])

        body_joints: List[List[int]] = [[] for _ in range(nbody)]
        for j, jd in enumerate(self._joints):
            body_joints[jd["body"]].append(j)

        # dofs on each body's root->body chain
        body_dof = np.zeros((nbody, nv), dtype=np.uint8)
        for b in range(nbody):
            cur = b
            while cur >= 0:
                for j in body_joints[cur]:
                    v0 = jnt_vadr[j]
                    body_dof[b, v0:v0 + _jnt_nv(self._joints[j]["jtype"])] = 1
                cur = self._bodies[cur]["parent"]
        dof_mask = np.zeros((nv, nv), dtype=np.uint8)
        for i in range(nv):
            dof_mask[i] = body_dof[dof_body[i]]

        nsph, ncap, nbox = len(self._sphs), len(self._caps), len(self._boxes)
        nu = len(self._acts)
        sph_body_l = [s["body"] for s in self._sphs]
        cap_body_l = [c["body"] for c in self._caps]
        box_body_l = [b["body"] for b in self._boxes]
        # canonical slot order (collision.py's header): the floor groups
        # (1 slot a sphere, 2 a capsule, 8 a box), then the pair groups
        slot_a: List[int] = []
        slot_b: List[int] = []
        for bodies, per in ((sph_body_l, 1), (cap_body_l, 2),
                            (box_body_l, 8)):
            for b in bodies:
                slot_a.extend([-1] * per)
                slot_b.extend([b] * per)
        for pairs, la, lb, per in (
                (self._pairs, sph_body_l, sph_body_l, 1),
                (self._pairs_sc, sph_body_l, cap_body_l, 1),
                (self._pairs_cc, cap_body_l, cap_body_l, 1),
                (self._pairs_sb, sph_body_l, box_body_l, 1),
                (self._pairs_cb, cap_body_l, box_body_l, 1),
                (self._pairs_bb, box_body_l, box_body_l, 16)):
            for i, j in pairs:
                slot_a.extend([la[i]] * per)
                slot_b.extend([lb[j]] * per)

        struct = Structure(
            nq=nq, nv=nv, nu=nu, nbody=nbody, njnt=njnt, nsph=nsph,
            npair=len(self._pairs), nhrow=self.hfield_shape[0],
            nhcol=self.hfield_shape[1],
            body_parent=tuple(b["parent"] for b in self._bodies),
            body_joints=tuple(tuple(x) for x in body_joints),
            jnt_type=tuple(j["jtype"] for j in self._joints),
            jnt_body=tuple(j["body"] for j in self._joints),
            jnt_qadr=tuple(jnt_qadr), jnt_vadr=tuple(jnt_vadr),
            jnt_limited=tuple(bool(j["limited"]) for j in self._joints),
            dof_body=tuple(dof_body), dof_jnt=tuple(dof_jnt),
            dof_mask_bytes=dof_mask.tobytes(),
            body_dof_bytes=body_dof.tobytes(),
            sph_body=tuple(sph_body_l),
            pair_a=tuple(p[0] for p in self._pairs),
            pair_b=tuple(p[1] for p in self._pairs),
            act_type=tuple(a["atype"] for a in self._acts),
            act_jnt=tuple(a["joint"] for a in self._acts),
            act_site=tuple(a.get("site", -1) for a in self._acts),
            act_site_world=tuple(bool(a.get("world_frame", False))
                                 for a in self._acts),
            has_gravcomp=any(b["gravcomp"] != 0.0 for b in self._bodies),
            body_names=tuple(b["name"] for b in self._bodies),
            jnt_names=tuple(j["name"] for j in self._joints),
            site_names=tuple(s["name"] for s in self._sites),
            site_body=tuple(s["body"] for s in self._sites),
            has_floor=self.has_floor,
            max_contacts=self.max_contacts,
            fluid_density=float(self.fluid_density),
            fluid_viscosity=float(self.fluid_viscosity),
            ncap=ncap, nbox=nbox,
            cap_body=tuple(cap_body_l), box_body=tuple(box_body_l),
            pair_sc=tuple(self._pairs_sc), pair_cc=tuple(self._pairs_cc),
            pair_sb=tuple(self._pairs_sb), pair_cb=tuple(self._pairs_cb),
            pair_bb=tuple(self._pairs_bb),
            sph_floor=tuple(s["floor"] for s in self._sphs),
            cap_floor=tuple(c["floor"] for c in self._caps),
            box_floor=tuple(b["floor"] for b in self._boxes),
            tendon_jnt=tuple(t["joints"] for t in self._tendons),
            tendon_coef=tuple(t["coefs"] for t in self._tendons),
            slot_body_a=tuple(slot_a), slot_body_b=tuple(slot_b),
        )

        def arr(vals, shape):
            a = np.array(vals, dtype=np.float64)
            a = np.zeros(shape) if a.size == 0 else a.reshape(shape)
            return torch.as_tensor(a, dtype=dtype, device=dev)

        dof_damping = np.zeros(nv)
        dof_armature = np.zeros(nv)
        for j, jd in enumerate(self._joints):
            v0 = jnt_vadr[j]
            dof_damping[v0:v0 + _jnt_nv(jd["jtype"])] = jd["damping"]
            dof_armature[v0:v0 + _jnt_nv(jd["jtype"])] = jd["armature"]

        # spring reference: hinge/slide springref; free joints the body's
        # frame pose (MuJoCo qpos0); ball joints the identity quaternion
        qpos_spring = np.zeros(nq)
        for j, jd in enumerate(self._joints):
            q0 = jnt_qadr[j]
            t = jd["jtype"]
            if t == JointType.FREE:
                b = jd["body"]
                qpos_spring[q0:q0 + 3] = np.asarray(self._bodies[b]["pos"],
                                                    dtype=np.float64)
                qpos_spring[q0 + 3:q0 + 7] = _normq(self._bodies[b]["quat"])
            elif t == JointType.BALL:
                qpos_spring[q0] = 1.0
            else:
                qpos_spring[q0] = jd["springref"]

        bodies, joints, acts = self._bodies, self._joints, self._acts
        sphs, sites = self._sphs, self._sites
        caps, boxes, tendons = self._caps, self._boxes, self._tendons
        return Model(
            struct=struct,
            body_pos=arr([b["pos"] for b in bodies], (nbody, 3)),
            body_quat=arr([_normq(b["quat"]) for b in bodies], (nbody, 4)),
            body_ipos=arr([b["ipos"] for b in bodies], (nbody, 3)),
            body_iquat=arr([_normq(b["iquat"]) for b in bodies], (nbody, 4)),
            body_mass=arr([b["mass"] for b in bodies], (nbody,)),
            body_inertia=arr([b["inertia"] for b in bodies], (nbody, 3)),
            body_gravcomp=arr([b["gravcomp"] for b in bodies], (nbody,)),
            jnt_pos=arr([j["pos"] for j in joints], (njnt, 3)),
            jnt_axis=arr([_normv(j["axis"]) for j in joints], (njnt, 3)),
            jnt_range=arr([j["jrange"] for j in joints], (njnt, 2)),
            jnt_stiffness=arr([j["stiffness"] for j in joints], (njnt,)),
            jnt_springref=arr([j["springref"] for j in joints], (njnt,)),
            jnt_margin=arr([j["margin"] for j in joints], (njnt,)),
            qpos_spring=arr(qpos_spring, (nq,)),
            dof_damping=arr(dof_damping, (nv,)),
            dof_armature=arr(dof_armature, (nv,)),
            act_gear=arr([a["gear"] for a in acts], (nu,)),
            act_gear6=arr([a.get("gear6", (0.0,) * 6) for a in acts],
                          (nu, 6)),
            act_kp=arr([a["kp"] for a in acts], (nu,)),
            act_kv=arr([a["kv"] for a in acts], (nu,)),
            act_ctrlrange=arr([a["ctrlrange"] for a in acts], (nu, 2)),
            act_forcerange=arr([a["forcerange"] for a in acts], (nu, 2)),
            site_pos=arr([s["pos"] for s in sites], (len(sites), 3)),
            sph_pos=arr([s["pos"] for s in sphs], (nsph, 3)),
            sph_radius=arr([s["radius"] for s in sphs], (nsph,)),
            sph_friction=arr([s["friction"] for s in sphs], (nsph,)),
            sph_friction_tor=arr([s["friction_tor"] for s in sphs], (nsph,)),
            sph_friction_roll=arr([s["friction_roll"] for s in sphs],
                                  (nsph,)),
            floor_z=arr(self.floor_z, ()),
            floor_friction=arr(self.floor_friction, ()),
            floor_friction_tor=arr(self.floor_friction_tor, ()),
            floor_friction_roll=arr(self.floor_friction_roll, ()),
            hfield_data=torch.zeros(self.hfield_shape, dtype=dtype,
                                    device=dev),
            hfield_halfsize=arr(self.hfield_halfsize, (2,)),
            dt=arr(self.dt, ()),
            gravity=arr(self.gravity, (3,)),
            solref=arr(self.solref, (2,)),
            solimp=arr(self.solimp, (3,)),
            limit_solref=arr(self.limit_solref, (2,)),
            limit_solimp=arr(self.limit_solimp, (3,)),
            cap_pos=arr([c["pos"] for c in caps], (ncap, 3)),
            cap_axis=arr([c["axis"] for c in caps], (ncap, 3)),
            cap_halflen=arr([c["halflen"] for c in caps], (ncap,)),
            cap_radius=arr([c["radius"] for c in caps], (ncap,)),
            cap_friction=arr([c["friction"] for c in caps], (ncap,)),
            cap_friction_tor=arr([c["friction_tor"] for c in caps],
                                 (ncap,)),
            cap_friction_roll=arr([c["friction_roll"] for c in caps],
                                  (ncap,)),
            box_pos=arr([b["pos"] for b in boxes], (nbox, 3)),
            box_quat=arr([_normq(b["quat"]) for b in boxes], (nbox, 4)),
            box_size=arr([b["size"] for b in boxes], (nbox, 3)),
            box_friction=arr([b["friction"] for b in boxes], (nbox,)),
            box_friction_tor=arr([b["friction_tor"] for b in boxes],
                                 (nbox,)),
            box_friction_roll=arr([b["friction_roll"] for b in boxes],
                                  (nbox,)),
            tendon_range=arr([t["range"] for t in tendons],
                             (len(tendons), 2)),
            sol_iter=torch.as_tensor(self.sol_iter, dtype=torch.int32,
                                     device=dev),
        )


def _normq(q):
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q)


def _normv(v):
    v = np.asarray(v, dtype=np.float64)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


@dataclasses.dataclass(frozen=True)
class State:
    """Batch of dynamic states: qpos (B, nq), qvel (B, nv), time (B,)."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    time: torch.Tensor

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @property
    def batch(self) -> int:
        return self.qpos.shape[0]


def make_state(model: Model, qpos=None, qvel=None, time=0.0,
               batch: Optional[int] = None) -> State:
    """A batch of states on the model's device and dtype.

    qpos / qvel may be one configuration ((nq,), broadcast to the batch)
    or a batch ((B, nq)). The batch size comes from `batch`, else from a
    2-D qpos or qvel, else 1.
    """
    dev, dtype = model.device, model.dtype

    def as_t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    if qpos is None:
        qpos = default_qpos(model)
    qpos = as_t(qpos)
    qvel = (torch.zeros(model.nv, dtype=dtype, device=dev) if qvel is None
            else as_t(qvel))
    if batch is None:
        batch = next((x.shape[0] for x in (qpos, qvel) if x.ndim == 2), 1)
    qpos = qpos.expand(batch, model.nq).clone()
    qvel = qvel.expand(batch, model.nv).clone()
    time = as_t(time).expand(batch).clone()
    return State(qpos=qpos, qvel=qvel, time=time)


def default_qpos(model: Model) -> torch.Tensor:
    """Neutral configuration (MuJoCo qpos0): scalar joints at 0, ball
    joints at identity, free joints at the carrying body's frame pose."""
    s = model.struct
    q = torch.zeros(s.nq, dtype=model.dtype, device=model.device)
    for j in range(s.njnt):
        adr = s.jnt_qadr[j]
        if s.jnt_type[j] == JointType.FREE:
            b = s.jnt_body[j]
            q[adr:adr + 3] = model.body_pos[b]
            q[adr + 3:adr + 7] = model.body_quat[b]
        elif s.jnt_type[j] == JointType.BALL:
            q[adr] = 1.0
    return q
