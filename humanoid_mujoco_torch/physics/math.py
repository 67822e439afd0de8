"""Quaternion / rotation / spatial-vector math on trailing axes.

Counterpart of humanoid_mujoco_tpu/physics/math.py. Every function works
on the last axis (or last two for matrices), so leading batch axes pass
through. Quaternions use MuJoCo's (w, x, y, z) convention.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def quat_id(dtype: torch.dtype = torch.float32,
            device="cuda") -> torch.Tensor:
    """The identity quaternion (1, 0, 0, 0)."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


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


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), branch-free:
    the four Shepperd constructions, the one with the largest pivot
    taken, then the sign that makes w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    piv = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                       1 - m00 + m11 - m22, 1 - m00 - m11 + m22], dim=-1)
    piv = torch.sqrt(torch.clamp(piv, min=_EPS)) * 0.5
    w0, x1, y2, z3 = piv.unbind(-1)
    cand = torch.stack([
        torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                     (m10 - m01) / (4 * w0)], dim=-1),
        torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1),
                     (m02 + m20) / (4 * x1)], dim=-1),
        torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2,
                     (m12 + m21) / (4 * y2)], dim=-1),
        torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3),
                     (m12 + m21) / (4 * z3), z3], dim=-1),
    ], dim=-2)                                          # (..., 4, 4)
    best = torch.argmax(piv, dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    return quat_normalize(
        q * torch.where(q[..., 0:1] < 0, -1.0, 1.0).to(q.dtype))


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


def local_gravity(quat_wxyz: torch.Tensor) -> torch.Tensor:
    """World -z in the body frame of the quaternions (..., 4): the IMU's
    gravity direction, (..., 3)."""
    down = quat_wxyz.new_tensor([0.0, 0.0, -1.0]).expand(
        quat_wxyz.shape[:-1] + (3,))
    return quat_rotate_inv(quat_wxyz, down)
