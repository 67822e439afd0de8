"""Quaternion / rotation / spatial-vector math on trailing axes.

Counterpart of humanoid_mujoco_tpu/physics/math.py. Every function works
on the last axis (or last two for matrices), so leading batch axes pass
through. Quaternions use MuJoCo's (w, x, y, z) convention.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, with broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (active rotation): v + w t + qv × t, t = 2 qv × v."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix R with R @ v == quat_rotate(q, v), (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor
                       ) -> torch.Tensor:
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def safe_norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-20) -> torch.Tensor:
    """sqrt(|v|^2 + eps): smooth at v = 0, zero gradient there."""
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim) + eps)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(max(x, lo), hi), as jnp.clip: at x on a bound the tangent is
    split evenly, where torch.clamp passes it whole (the derivative of a
    saturated control, for one)."""
    lo = torch.as_tensor(lo, device=x.device)
    hi = torch.as_tensor(hi, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (axis * angle) -> quaternion."""
    angle = safe_norm(v, keepdim=True)
    s = torch.where(angle < 1e-6, 0.5 - angle * angle / 48.0,
                    torch.sin(0.5 * angle) / angle)
    return torch.cat([torch.cos(0.5 * angle), v * s], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> rotation vector (inverse of quat_exp)."""
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0).to(q.dtype)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    vnorm = safe_norm(q[..., 1:4], keepdim=True)
    angle = 2.0 * torch.atan2(vnorm, w)
    return q[..., 1:4] * (angle / vnorm)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """q' = q ⊗ exp(ω_local dt) (mju_quatIntegrate semantics)."""
    return quat_normalize(quat_mul(q, quat_exp(omega * dt)))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """ω_local such that qa = qb ⊗ exp(ω)."""
    return quat_log(quat_mul(quat_conj(qb), qa))


# spatial vectors: 6-vectors [angular(3); linear(3)] about a common anchor

def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v ×m m (motion × motion)."""
    vang, vlin = v[..., :3], v[..., 3:]
    mang, mlin = m[..., :3], m[..., 3:]
    return torch.cat([cross(vang, mang),
                      cross(vlin, mang) + cross(vang, mlin)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """v ×f f (motion × force)."""
    vang, vlin = v[..., :3], v[..., 3:]
    fang, flin = f[..., :3], f[..., 3:]
    return torch.cat([cross(vang, fang) + cross(vlin, flin),
                      cross(vang, flin)], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """skew(v) @ u == cross(v, u)."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v.unbind(-1)
    rows = torch.stack([z, -w, y, w, z, -x, -y, x, z], dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass: torch.Tensor, inertia_world: torch.Tensor,
                    com_offset: torch.Tensor) -> torch.Tensor:
    """Spatial inertia (..., 6, 6) about the anchor, [angular; linear]."""
    cx = skew(com_offset)
    m = mass[..., None, None]
    cxt = cx.transpose(-1, -2)
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    top = torch.cat([inertia_world + m * (cx @ cxt), m * cx], dim=-1)
    bot = torch.cat([m * cxt, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=dim, keepdim=True),
                           min=_EPS)
