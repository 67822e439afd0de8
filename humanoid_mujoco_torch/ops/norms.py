"""Scalar penalty norms with analytic value, gradient and Hessian.

Counterpart of humanoid_mujoco_tpu/ops/norms.py (the reference's
mjpc/norm.cc shapes, same enum numbering). Each norm maps x (..., n) to
(...), its gradient is (..., n) and its Hessian (..., n, n).
"""

from __future__ import annotations

import enum

import torch

_MINVAL = 1e-15


class NormType(enum.IntEnum):
    NULL = -1
    QUADRATIC = 0
    L22 = 1
    L2 = 2
    COSH = 3
    POWER_LOSS = 5
    SMOOTH_ABS = 6
    SMOOTH_ABS2 = 7
    RECTIFY = 8


def _null(x, p, q):
    return x[..., 0]


def _quadratic(x, p, q):
    return 0.5 * torch.sum(x * x, dim=-1)


def _l22(x, p, q):
    c = torch.sum(x * x, dim=-1)
    a = torch.pow(torch.clamp(c, min=_MINVAL), q / 2) + torch.pow(p, q)
    return torch.pow(a, 1.0 / q) - p


def _l2(x, p, q):
    return torch.sqrt(torch.sum(x * x, dim=-1) + p * p) - p


def _cosh(x, p, q):
    return torch.sum(p * p * (torch.cosh(x / p) - 1.0), dim=-1)


def _power(x, p, q):
    return torch.sum(torch.pow(torch.abs(x) + _MINVAL, p), dim=-1)


def _smooth_abs(x, p, q):
    return torch.sum(torch.sqrt(x * x + p * p) - p, dim=-1)


def _smooth_abs2(x, p, q):
    e = torch.pow(torch.abs(x) + _MINVAL, q) + torch.pow(p, q)
    return torch.sum(torch.pow(e, 1.0 / q) - p, dim=-1)


def _rectify(x, p, q):
    # p log(1 + exp(x / p)); p == 0 degenerates to relu(x)
    y = x / torch.clamp(p, min=_MINVAL)
    soft = p * torch.logaddexp(torch.zeros_like(y), y)
    return torch.sum(torch.where(p > 0, soft, torch.clamp(x, min=0.0)),
                     dim=-1)


_NORM_FNS = {
    NormType.NULL: _null,
    NormType.QUADRATIC: _quadratic,
    NormType.L22: _l22,
    NormType.L2: _l2,
    NormType.COSH: _cosh,
    NormType.POWER_LOSS: _power,
    NormType.SMOOTH_ABS: _smooth_abs,
    NormType.SMOOTH_ABS2: _smooth_abs2,
    NormType.RECTIFY: _rectify,
}


def norm_param_dim(norm_type: int) -> int:
    """How many parameters the norm takes (its p, q)."""
    return {
        NormType.NULL: 0,
        NormType.QUADRATIC: 0,
        NormType.L22: 2,
        NormType.L2: 1,
        NormType.COSH: 1,
        NormType.POWER_LOSS: 1,
        NormType.SMOOTH_ABS: 1,
        NormType.SMOOTH_ABS2: 2,
        NormType.RECTIFY: 1,
    }[NormType(norm_type)]


def norm_value(x: torch.Tensor, norm_type: int, p=0.0, q=0.0
               ) -> torch.Tensor:
    """Norm value over the last axis; p, q are floats or 0-d tensors."""
    p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return _NORM_FNS[NormType(norm_type)](x, p, q)


def norm_grad(x: torch.Tensor, norm_type: int, p=0.0, q=0.0):
    """(value (...), gradient (..., n)) in the analytic forms."""
    t = NormType(norm_type)
    p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if t == NormType.NULL:
        return _null(x, p, q), torch.ones_like(x)
    if t == NormType.QUADRATIC:
        return _quadratic(x, p, q), x
    if t == NormType.L22:
        cs = torch.clamp(torch.sum(x * x, dim=-1, keepdim=True), min=_MINVAL)
        a = torch.pow(cs, q / 2) + torch.pow(p, q)
        s = torch.pow(a, 1.0 / q)
        return s[..., 0] - p, s / a * torch.pow(cs, q / 2 - 1) * x
    if t == NormType.L2:
        s = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + p * p)
        return s[..., 0] - p, x / torch.clamp(s, min=_MINVAL)
    if t == NormType.COSH:
        return _cosh(x, p, q), p * torch.sinh(x / p)
    if t == NormType.POWER_LOSS:
        a = torch.abs(x) + _MINVAL
        return _power(x, p, q), torch.sign(x) * p * torch.pow(a, p - 1)
    if t == NormType.SMOOTH_ABS:
        s = torch.sqrt(x * x + p * p)
        return torch.sum(s - p, dim=-1), x / torch.clamp(s, min=_MINVAL)
    if t == NormType.SMOOTH_ABS2:
        a = torch.abs(x) + _MINVAL
        e = torch.pow(a, q) + torch.pow(p, q)
        s = torch.pow(e, 1.0 / q)
        return (torch.sum(s - p, dim=-1),
                s * torch.pow(a, q - 2) / e * x)
    # RECTIFY
    sig = torch.sigmoid(x / torch.clamp(p, min=_MINVAL))
    return _rectify(x, p, q), torch.where(p > 0, sig, (x > 0).to(x.dtype))


def norm_hess(x: torch.Tensor, norm_type: int, p=0.0, q=0.0):
    """(value (...), gradient (..., n), Hessian (..., n, n))."""
    t = NormType(norm_type)
    y, g = norm_grad(x, norm_type, p, q)
    p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)

    def diag(h):
        return eye * h[..., None, :]
    if t == NormType.NULL:
        H = x.new_zeros(x.shape + (n,))
    elif t == NormType.QUADRATIC:
        H = eye.expand(x.shape + (n,))
    elif t == NormType.L22:
        cs = torch.clamp(torch.sum(x * x, dim=-1, keepdim=True), min=_MINVAL)
        a = torch.pow(cs, q / 2) + torch.pow(p, q)
        s = torch.pow(a, 1.0 / q)
        d = torch.pow(cs, q / 2 - 1)
        b = (s / a * d)[..., None]
        cc = ((1 - q) * d / a + (q - 2) / cs)[..., None]
        H = b * (eye + x[..., :, None] * x[..., None, :] * cc)
    elif t == NormType.L2:
        s = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + p * p)
        H = (eye - g[..., :, None] * g[..., None, :]) / torch.clamp(
            s[..., None], min=_MINVAL)
    elif t == NormType.COSH:
        H = diag(torch.cosh(x / p))
    elif t == NormType.POWER_LOSS:
        a = torch.abs(x) + _MINVAL
        H = diag((p - 1) * p * torch.pow(a, p - 2))
    elif t == NormType.SMOOTH_ABS:
        s = torch.clamp(torch.sqrt(x * x + p * p), min=_MINVAL)
        H = diag((1 - g * g) / s)
    elif t == NormType.SMOOTH_ABS2:
        a = torch.abs(x) + _MINVAL
        d = torch.pow(a, q)
        e = d + torch.pow(p, q)
        cc = torch.pow(e, 1.0 / q) * torch.pow(a, q - 2) / e
        H = diag(cc * (q - 1) * (1 - d / e))
    else:  # RECTIFY
        sig = torch.sigmoid(x / torch.clamp(p, min=_MINVAL))
        H = diag(torch.where(p > 0, sig * (1 - sig) / torch.clamp(
            p, min=_MINVAL), torch.zeros_like(x)))
    return y, g, H
