"""Sphere collision over a fixed contact capacity, batched.

Counterpart of the sphere part of humanoid_mujoco_tpu/physics/
collision.py: sphere-vs-heightfield floor slots, then sphere-sphere pair
slots, in the canonical slot order of Structure.slot_body_a/b. Every
slot is always present; a floor slot that is gated off carries the
1e9 `dist` sentinel. Capsules and boxes wait for a later slice.

The floor is a bilinear heightfield z(x, y) over a (nhrow, nhcol) grid
spanning [-hx, hx] × [-hy, hy].
"""

from __future__ import annotations

import dataclasses

import torch

from . import math as pm
from .model import Model


@dataclasses.dataclass(frozen=True)
class Contacts:
    """Fixed-capacity contact set, (B, ncon, ...)."""

    pos: torch.Tensor            # (B, ncon, 3) contact point, world
    normal: torch.Tensor         # (B, ncon, 3) pushes body_b off body_a
    dist: torch.Tensor           # (B, ncon) signed gap
    friction: torch.Tensor       # (B, ncon)
    friction_tor: torch.Tensor
    friction_roll: torch.Tensor


def hfield_height(m: Model, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear floor height at world (x, y); xy (..., 2) -> (...).

    Tent-weight form, as in the JAX package: w_i = max(0, 1 - |g - i|),
    h = wyᵀ H wx, which is the 4-corner bilinear value.
    """
    nr, nc = m.struct.nhrow, m.struct.nhcol
    hx, hy = m.hfield_halfsize[0], m.hfield_halfsize[1]
    gx = (xy[..., 0] + hx) / (2 * hx) * (nc - 1)
    gy = (xy[..., 1] + hy) / (2 * hy) * (nr - 1)
    gx = torch.clamp(gx, 0.0, nc - 1.000001)
    gy = torch.clamp(gy, 0.0, nr - 1.000001)
    ix = torch.arange(nc, dtype=xy.dtype, device=xy.device)
    iy = torch.arange(nr, dtype=xy.dtype, device=xy.device)
    wx = torch.clamp(1.0 - torch.abs(gx[..., None] - ix), min=0.0)
    wy = torch.clamp(1.0 - torch.abs(gy[..., None] - iy), min=0.0)
    H = m.hfield_data
    if m.per_env("hfield_data"):      # (B, nr, nc): one floor per env
        H = H.reshape(H.shape[:1] + (1,) * (wy.ndim - 2) + H.shape[1:])
        hrow = torch.einsum("...r,...rc->...c", wy, H)
    else:
        hrow = torch.einsum("...r,rc->...c", wy, H)
    return m.floor_z + torch.sum(hrow * wx, dim=-1)


def hfield_normal(m: Model, xy: torch.Tensor, eps: float = 1e-3
                  ) -> torch.Tensor:
    """Floor surface normal by central differences of the height."""
    dx = torch.tensor([eps, 0.0], dtype=xy.dtype, device=xy.device)
    dy = torch.tensor([0.0, eps], dtype=xy.dtype, device=xy.device)
    hpx = hfield_height(m, xy + dx)
    hmx = hfield_height(m, xy - dx)
    hpy = hfield_height(m, xy + dy)
    hmy = hfield_height(m, xy - dy)
    n = torch.stack([-(hpx - hmx) / (2 * eps), -(hpy - hmy) / (2 * eps),
                     torch.ones_like(hpx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def sphere_world_centers(m: Model, xpos: torch.Tensor, xmat: torch.Tensor
                         ) -> torch.Tensor:
    """World centers of all collision spheres (B, nsph, 3)."""
    body = torch.as_tensor(m.struct.sph_body, device=xpos.device)
    return xpos[:, body] + torch.einsum("nsij,sj->nsi", xmat[:, body],
                                        m.sph_pos)


def collide(m: Model, xpos: torch.Tensor, xmat: torch.Tensor) -> Contacts:
    s = m.struct
    if s.ncap or s.nbox or s.pair_sc or s.pair_cc or s.pair_sb \
            or s.pair_cb or s.pair_bb:
        raise NotImplementedError(
            "capsule and box collision come with slice 4 of the port")
    B = xpos.shape[0]
    centers = sphere_world_centers(m, xpos, xmat)
    rad = m.sph_radius
    if s.has_floor:
        h = hfield_height(m, centers[..., :2])
        n = hfield_normal(m, centers[..., :2])
        dist = centers[..., 2] - rad - h
        pos = centers - n * (rad + 0.5 * dist)[..., None]
        if not all(s.sph_floor):
            gate = torch.as_tensor(s.sph_floor, device=xpos.device)
            dist = torch.where(gate, dist, torch.full_like(dist, 1e9))
        # floor friction: shared () or per env (B,)
        fr = torch.maximum(m.sph_friction, m.floor_friction[..., None])
        tor = torch.maximum(m.sph_friction_tor, m.floor_friction_tor)
        roll = torch.maximum(m.sph_friction_roll, m.floor_friction_roll)
    else:
        pos = centers
        n = torch.zeros_like(centers)
        n[..., 2] = 1.0
        dist = torch.full_like(centers[..., 0], 1e9)
        fr, tor, roll = m.sph_friction, m.sph_friction_tor, \
            m.sph_friction_roll
    groups = [(pos, n, dist, fr.expand(B, s.nsph), tor.expand(B, s.nsph),
               roll.expand(B, s.nsph))]

    if s.npair:
        ia = torch.as_tensor(s.pair_a, device=xpos.device)
        ib = torch.as_tensor(s.pair_b, device=xpos.device)
        ca, cb = centers[:, ia], centers[:, ib]
        ra, rb = rad[ia], rad[ib]
        delta = cb - ca
        dnorm = torch.linalg.vector_norm(delta, dim=-1)
        n = delta / torch.clamp(dnorm, min=1e-9)[..., None]
        dist = dnorm - (ra + rb)
        pos = ca + n * (ra + 0.5 * dist)[..., None]
        P = s.npair
        groups.append((
            pos, n, dist,
            torch.maximum(m.sph_friction[ia], m.sph_friction[ib]).expand(B, P),
            torch.maximum(m.sph_friction_tor[ia],
                          m.sph_friction_tor[ib]).expand(B, P),
            torch.maximum(m.sph_friction_roll[ia],
                          m.sph_friction_roll[ib]).expand(B, P)))

    pos, normal, dist, fric, tor, roll = (
        torch.cat([g[i] for g in groups], dim=1) for i in range(6))
    return Contacts(pos=pos, normal=normal, dist=dist, friction=fric,
                    friction_tor=tor, friction_roll=roll)


def select_contacts(contacts: Contacts, k: int):
    """Keep the k slots with the smallest signed gap, per env.

    Counterpart of the JAX package's `select_contacts` (`lax.top_k` of
    -dist). Ties go to the lower slot index, as `lax.top_k` breaks them:
    a stable ascending sort, whose first k entries are taken (the
    humanoid's mirrored spheres have exactly equal gaps at a symmetric
    pose, and `torch.topk` promises no order among ties). Returns the
    reduced Contacts (B, k, ...) and `sel` (B, k) int64, the original
    slot indices.
    """
    sel = torch.sort(contacts.dist, dim=-1, stable=True).indices[:, :k]

    def g(x):
        idx = sel if x.ndim == 2 else sel[..., None].expand(-1, -1,
                                                             x.shape[-1])
        return torch.gather(x, 1, idx)

    return Contacts(pos=g(contacts.pos), normal=g(contacts.normal),
                    dist=g(contacts.dist), friction=g(contacts.friction),
                    friction_tor=g(contacts.friction_tor),
                    friction_roll=g(contacts.friction_roll)), sel


def tangent_frame(normal: torch.Tensor):
    """Two unit tangents orthogonal to each normal, branch-free.
    normal (..., 3) -> (t1, t2)."""
    up = torch.abs(normal[..., 2:3]) > 0.9
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=normal.dtype,
                      device=normal.device)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=normal.dtype,
                      device=normal.device)
    ref = torch.where(up, ex, ez)
    t1 = pm.cross(ref, normal)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True),
                          min=1e-9)
    return t1, pm.cross(normal, t1)
