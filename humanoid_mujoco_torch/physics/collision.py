"""Collision over a fixed contact capacity, batched.

Counterpart of humanoid_mujoco_tpu/physics/collision.py. Geoms are
spheres, capsules and boxes fixed at build time; every candidate contact
has a static slot, and a slot that is out of reach or gated off carries
a large gap (the 1e9 sentinel off the floor). The canonical slot order,
which Structure.slot_body_a/b follows:

  [0, nsph)        sphere-vs-floor
  [., +2 ncap)     capsule-vs-floor (one slot per segment endpoint)
  [., +8 nbox)     box-vs-floor (the 8 corners)
  [., +npair)      sphere-sphere pairs
  [., +|sc|)       sphere-capsule pairs (exact point-segment)
  [., +|cc|)       capsule-capsule pairs (exact segment-segment)
  [., +|sb|)       sphere-box pairs (exact point-box, inside handled)
  [., +|cb|)       capsule-box pairs (the segment sampled at 5 points,
                   the deepest sample wins)
  [., +16 |bb|)    box-box pairs (the 8 corners of B in A, then the 8 of
                   A in B)

The floor is a bilinear heightfield z(x, y) over a (nhrow, nhcol) grid
spanning [-hx, hx] × [-hy, hy]. Every branch is a `torch.where` whose
unselected side carries no NaN into forward-mode tangents, and the
index tables are built once per structure and device.
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


def _index(m: Model, name: str, values, device) -> torch.Tensor:
    """A static int64 index table, built once per structure and device."""
    return m.struct_static(("collide", name, device), lambda: torch.as_tensor(
        values, dtype=torch.long, device=device).reshape(-1))


def sphere_world_centers(m: Model, xpos: torch.Tensor, xmat: torch.Tensor
                         ) -> torch.Tensor:
    """World centers of all collision spheres (B, nsph, 3)."""
    body = _index(m, "sph_body", m.struct.sph_body, xpos.device)
    return xpos[:, body] + torch.einsum("nsij,sj->nsi", xmat[:, body],
                                        m.sph_pos)


def capsule_world_segments(m: Model, xpos: torch.Tensor,
                           xmat: torch.Tensor):
    """World segment endpoints of all capsules, each (B, ncap, 3)."""
    body = _index(m, "cap_body", m.struct.cap_body, xpos.device)
    R = xmat[:, body]
    center = xpos[:, body] + torch.einsum("ncij,cj->nci", R, m.cap_pos)
    off = m.cap_halflen[:, None] * torch.einsum("ncij,cj->nci", R,
                                                 m.cap_axis)
    return center - off, center + off


def box_world_frames(m: Model, xpos: torch.Tensor, xmat: torch.Tensor):
    """World box centers (B, nbox, 3) and rotations (B, nbox, 3, 3)."""
    body = _index(m, "box_body", m.struct.box_body, xpos.device)
    R = xmat[:, body]
    c = xpos[:, body] + torch.einsum("ncij,cj->nci", R, m.box_pos)
    return c, R @ pm.quat_to_mat(m.box_quat)


# the 8 box-corner sign combinations, in the JAX package's order
_CORNER_SIGNS = tuple((sx, sy, sz) for sx in (-1.0, 1.0)
                      for sy in (-1.0, 1.0) for sz in (-1.0, 1.0))


def _corners(m: Model, c: torch.Tensor, R: torch.Tensor, size: torch.Tensor
             ) -> torch.Tensor:
    """World corners (..., 8, 3) of boxes at c (..., 3), R (..., 3, 3)
    with half-extents size (P, 3)."""
    signs = m.struct_static(
        ("corner_signs", size.dtype, size.device),
        lambda: torch.tensor(_CORNER_SIGNS, dtype=size.dtype,
                             device=size.device))
    local = size[:, None, :] * signs                        # (P, 8, 3)
    return c[..., None, :] + torch.einsum("...ij,...kj->...ki", R, local)


def _norm0(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis, with a zero (not NaN) tangent at v = 0."""
    sq = torch.sum(v * v, dim=-1)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq,
                                                   torch.ones_like(sq))),
                       torch.zeros_like(sq))


def _seg_seg_closest(p1, q1, p2, q2):
    """Closest points between segments [p1, q1] and [p2, q2] (Ericson's
    clamped closed form, branch-free); (..., 3) each. Parallel segments
    (denominator <= 1e-12) take s = 0."""
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a = torch.sum(d1 * d1, dim=-1)
    e = torch.sum(d2 * d2, dim=-1)
    f = torch.sum(d2 * r, dim=-1)
    c = torch.sum(d1 * r, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    denom = a * e - b * b
    ok = denom > 1e-12
    s0 = torch.where(ok, pm.clip((b * f - c * e)
                                 / torch.clamp(denom, min=1e-12), 0.0, 1.0),
                     torch.zeros_like(denom))
    t0 = (b * s0 + f) / torch.clamp(e, min=1e-12)
    t = pm.clip(t0, 0.0, 1.0)
    s = torch.where(t == t0, s0, pm.clip(
        (b * t - c) / torch.clamp(a, min=1e-12), 0.0, 1.0))
    return p1 + s[..., None] * d1, p2 + t[..., None] * d2


def _point_box_local(local: torch.Tensor, size: torch.Tensor):
    """Signed distance of points to a box surface, in the box frame:
    local (..., 3), size (..., 3) half-extents. Returns (dist (...),
    negative inside; outward unit gradient (..., 3); closest surface
    point (..., 3)). Inside, the nearest face decides (the first on a
    tie, as jnp.argmin)."""
    q = pm.clip(local, -size, size)
    delta = local - q
    d_out = _norm0(delta)
    face_gap = size - torch.abs(local)
    ax = torch.argmin(face_gap, dim=-1, keepdim=True)
    min_gap = torch.gather(face_gap, -1, ax)[..., 0]
    inside = min_gap > 0.0
    one_hot = torch.zeros_like(local).scatter(-1, ax, 1.0)
    sgn = torch.sum(torch.sign(local) * one_hot, dim=-1)
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    grad_in = sgn[..., None] * one_hot
    grad_out = delta / torch.clamp(d_out, min=1e-9)[..., None]
    grad = torch.where(inside[..., None], grad_in, grad_out)
    dist = torch.where(inside, -min_gap, d_out)
    surf = torch.where(inside[..., None],
                       local + grad_in * min_gap[..., None], q)
    return dist, grad, surf


def _point_box_world(p, box_c, box_R, size):
    """_point_box_local in world coordinates: p (..., 3), the box pose
    broadcastable. Returns (dist, world gradient, world surface point)."""
    local = torch.einsum("...ji,...j->...i", box_R, p - box_c)
    dist, grad_l, surf_l = _point_box_local(local, size)
    grad_w = torch.einsum("...ij,...j->...i", box_R, grad_l)
    surf_w = box_c + torch.einsum("...ij,...j->...i", box_R, surf_l)
    return dist, grad_w, surf_w


def _points_vs_floor(m: Model, centers, radii, fric3):
    """Floor narrowphase for spheres of radii (P,) at centers (B, P, 3),
    fric3 the (slide, torsion, roll) friction of each (P,). Returns the
    slot group (pos, normal, dist, friction, torsion, roll)."""
    if m.struct.has_floor:
        h = hfield_height(m, centers[..., :2])
        n = hfield_normal(m, centers[..., :2])
        dist = centers[..., 2] - radii - h
        pos = centers - n * (radii + 0.5 * dist)[..., None]
        # floor friction: shared () or per env (B,)
        return (pos, n, dist,
                torch.maximum(fric3[0], m.floor_friction[..., None]),
                torch.maximum(fric3[1], m.floor_friction_tor[..., None]),
                torch.maximum(fric3[2], m.floor_friction_roll[..., None]))
    n = torch.zeros_like(centers)
    n[..., 2] = 1.0
    return (centers, n, torch.full_like(centers[..., 0], 1e9)) + tuple(fric3)


def _gate(m: Model, name: str, flags, per: int, dist: torch.Tensor):
    """Floor slots of the geoms whose floor flag is off get the 1e9 gap."""
    if all(flags):
        return dist
    gate = m.struct_static(
        ("collide", name, dist.device), lambda: torch.as_tensor(
            [f for f in flags for _ in range(per)], device=dist.device))
    return torch.where(gate, dist, torch.full_like(dist, 1e9))


def _pair_friction(fa, fb, ia, ib):
    return tuple(torch.maximum(a[ia], b[ib]) for a, b in zip(fa, fb))


def _sphere_pair_group(ca, cb, ra, rb, fric):
    """Contacts of spheres of radii ra at ca against radii rb at cb,
    the normal from a to b."""
    delta = cb - ca
    dnorm = torch.linalg.vector_norm(delta, dim=-1)
    n = delta / torch.clamp(dnorm, min=1e-9)[..., None]
    dist = dnorm - (ra + rb)
    return (ca + n * (ra + 0.5 * dist)[..., None], n, dist) + fric


def collide(m: Model, xpos: torch.Tensor, xmat: torch.Tensor) -> Contacts:
    s = m.struct
    B, dev = xpos.shape[0], xpos.device
    groups = []
    centers = sphere_world_centers(m, xpos, xmat)
    fs = (m.sph_friction, m.sph_friction_tor, m.sph_friction_roll)
    fc = (m.cap_friction, m.cap_friction_tor, m.cap_friction_roll)
    fbx = (m.box_friction, m.box_friction_tor, m.box_friction_roll)
    if s.ncap:
        cap_e0, cap_e1 = capsule_world_segments(m, xpos, xmat)
    if s.nbox:
        box_c, box_R = box_world_frames(m, xpos, xmat)

    # --- geom-vs-floor groups ---
    if s.nsph:
        g = _points_vs_floor(m, centers, m.sph_radius, fs)
        groups.append(g[:2] + (_gate(m, "sph_floor", s.sph_floor, 1, g[2]),)
                      + g[3:])
    if s.ncap:
        pts = torch.stack([cap_e0, cap_e1], dim=2).reshape(B, -1, 3)
        g = _points_vs_floor(m, pts, m.cap_radius.repeat_interleave(2),
                             tuple(f.repeat_interleave(2) for f in fc))
        groups.append(g[:2] + (_gate(m, "cap_floor", s.cap_floor, 2, g[2]),)
                      + g[3:])
    if s.nbox:
        pts = _corners(m, box_c, box_R, m.box_size).reshape(B, -1, 3)
        g = _points_vs_floor(m, pts, pts.new_zeros(8 * s.nbox),
                             tuple(f.repeat_interleave(8) for f in fbx))
        groups.append(g[:2] + (_gate(m, "box_floor", s.box_floor, 8, g[2]),)
                      + g[3:])

    # --- sphere-sphere pairs ---
    if s.npair:
        ia = _index(m, "pair_a", s.pair_a, dev)
        ib = _index(m, "pair_b", s.pair_b, dev)
        groups.append(_sphere_pair_group(
            centers[:, ia], centers[:, ib], m.sph_radius[ia],
            m.sph_radius[ib], _pair_friction(fs, fs, ia, ib)))

    # --- sphere-capsule pairs: exact point-segment ---
    if s.pair_sc:
        ia = _index(m, "sc_a", [p[0] for p in s.pair_sc], dev)
        ic = _index(m, "sc_b", [p[1] for p in s.pair_sc], dev)
        p0, p1 = cap_e0[:, ic], cap_e1[:, ic]
        ca = centers[:, ia]
        d = p1 - p0
        t = pm.clip(torch.sum((ca - p0) * d, dim=-1)
                    / torch.clamp(torch.sum(d * d, dim=-1), min=1e-12),
                    0.0, 1.0)
        groups.append(_sphere_pair_group(
            ca, p0 + t[..., None] * d, m.sph_radius[ia], m.cap_radius[ic],
            _pair_friction(fs, fc, ia, ic)))

    # --- capsule-capsule pairs: exact segment-segment ---
    if s.pair_cc:
        ia = _index(m, "cc_a", [p[0] for p in s.pair_cc], dev)
        ib = _index(m, "cc_b", [p[1] for p in s.pair_cc], dev)
        pa, pb = _seg_seg_closest(cap_e0[:, ia], cap_e1[:, ia],
                                  cap_e0[:, ib], cap_e1[:, ib])
        groups.append(_sphere_pair_group(
            pa, pb, m.cap_radius[ia], m.cap_radius[ib],
            _pair_friction(fc, fc, ia, ib)))

    # --- sphere-box pairs: exact point-box, the inside handled ---
    if s.pair_sb:
        ia = _index(m, "sb_a", [p[0] for p in s.pair_sb], dev)
        ib = _index(m, "sb_b", [p[1] for p in s.pair_sb], dev)
        p = centers[:, ia]
        dc, grad, _ = _point_box_world(p, box_c[:, ib], box_R[:, ib],
                                       m.box_size[ib])
        ra = m.sph_radius[ia]
        n = -grad                    # pushes the box (body b) off the sphere
        dist = dc - ra
        groups.append((p + n * (ra + 0.5 * dist)[..., None], n, dist)
                      + _pair_friction(fs, fbx, ia, ib))

    # --- capsule-box pairs: 5 samples of the segment, the deepest wins ---
    if s.pair_cb:
        ia = _index(m, "cb_a", [p[0] for p in s.pair_cb], dev)
        ib = _index(m, "cb_b", [p[1] for p in s.pair_cb], dev)
        ts = torch.linspace(0.0, 1.0, 5, dtype=xpos.dtype, device=dev)
        p0, p1 = cap_e0[:, ia], cap_e1[:, ia]
        samples = p0[:, :, None] + ts[:, None] * (p1 - p0)[:, :, None]
        dc, grad, _ = _point_box_world(
            samples, box_c[:, ib][:, :, None], box_R[:, ib][:, :, None],
            m.box_size[ib][:, None])
        # the first of equal depths, as jnp.argmin; indices carry no
        # tangent
        k = torch.argmin(dc, dim=2, keepdim=True)
        dcb = torch.gather(dc, 2, k)[..., 0]
        k3 = k[..., None].expand(-1, -1, -1, 3)
        gradb = torch.gather(grad, 2, k3)[:, :, 0]
        pstar = torch.gather(samples, 2, k3)[:, :, 0]
        ra = m.cap_radius[ia]
        n = -gradb
        dist = dcb - ra
        groups.append((pstar + n * (ra + 0.5 * dist)[..., None], n, dist)
                      + _pair_friction(fc, fbx, ia, ib))

    # --- box-box pairs: 8 corners of B in A, then 8 of A in B ---
    if s.pair_bb:
        ia = _index(m, "bb_a", [p[0] for p in s.pair_bb], dev)
        ib = _index(m, "bb_b", [p[1] for p in s.pair_bb], dev)
        ca, Ra, sa = box_c[:, ia], box_R[:, ia], m.box_size[ia]
        cb, Rb, sb = box_c[:, ib], box_R[:, ib], m.box_size[ib]
        vb = _corners(m, cb, Rb, sb)                       # (B, P, 8, 3)
        dA, gA, _ = _point_box_world(vb, ca[:, :, None], Ra[:, :, None],
                                     sa[:, None])
        va = _corners(m, ca, Ra, sa)
        dB, gB, _ = _point_box_world(va, cb[:, :, None], Rb[:, :, None],
                                     sb[:, None])
        groups.append((torch.cat([vb, va], dim=2).reshape(B, -1, 3),
                       torch.cat([gA, -gB], dim=2).reshape(B, -1, 3),
                       torch.cat([dA, dB], dim=2).reshape(B, -1))
                      + tuple(f.repeat_interleave(16) for f in
                              _pair_friction(fbx, fbx, ia, ib)))

    if not groups:
        z = xpos.new_zeros((B, 0))
        return Contacts(pos=z[..., None].expand(B, 0, 3),
                        normal=z[..., None].expand(B, 0, 3), dist=z,
                        friction=z, friction_tor=z, friction_roll=z)
    pos, normal, dist = (torch.cat([g[i] for g in groups], dim=1)
                         for i in range(3))
    fric, tor, roll = (torch.cat([g[i].expand(B, g[2].shape[1])
                                  for g in groups], dim=1)
                       for i in range(3, 6))
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
