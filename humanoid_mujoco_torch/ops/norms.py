"""Scalar penalty norms (values only).

Counterpart of the value half of humanoid_mujoco_tpu/ops/norms.py (the
reference's mjpc/norm.cc shapes, same enum numbering). Each norm maps
x (..., n) to (...). Gradients and Hessians come with a later slice.
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


def norm_value(x: torch.Tensor, norm_type: int, p=0.0, q=0.0
               ) -> torch.Tensor:
    """Norm value over the last axis; p, q are floats or 0-d tensors."""
    p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return _NORM_FNS[NormType(norm_type)](x, p, q)
