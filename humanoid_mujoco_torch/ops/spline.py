"""Time-indexed control splines (zero / linear / cubic Hermite).

Counterpart of humanoid_mujoco_tpu/ops/spline.py. A spline is
`(times (K,), values (..., K, dim))`: the knot times are shared, the
values may carry a leading batch axis.
"""

from __future__ import annotations

import enum

import torch

_EPS = 1e-9


class SplineOrder(enum.IntEnum):
    ZERO = 0    # piecewise-constant hold
    LINEAR = 1
    CUBIC = 2   # Hermite with finite-difference slopes


def fd_slopes(times: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per-knot slopes by finite differences: interior knots average the
    adjacent secants, the first uses the first secant, the last the last
    secant (zero when K == 2). values (..., K, dim)."""
    K = times.shape[0]
    if K == 1:
        return torch.zeros_like(values)
    dt = torch.clamp(times[1:] - times[:-1], min=_EPS)[:, None]
    secant = (values[..., 1:, :] - values[..., :-1, :]) / dt
    first = secant[..., 0:1, :]
    if K == 2:
        return torch.cat([first, torch.zeros_like(first)], dim=-2)
    interior = 0.5 * (secant[..., 1:, :] + secant[..., :-1, :])
    return torch.cat([first, interior, secant[..., -1:, :]], dim=-2)


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[..., idx, :]: shared (K, dim) values at any idx shape, or
    per-env (B, K, dim) values at idx (B,)."""
    if values.ndim == 2:
        return values[idx]
    return values[torch.arange(values.shape[0], device=values.device), idx]


def spline_sample(times: torch.Tensor, values: torch.Tensor, t,
                  order: int = SplineOrder.ZERO) -> torch.Tensor:
    """Sample the spline at times t; out-of-range queries clamp to the
    end knots. Shared values (K, dim) take any t shape and return
    t.shape + (dim,); per-env values (B, K, dim) take t (B,)."""
    K = times.shape[0]
    t = torch.as_tensor(t, dtype=times.dtype,
                        device=times.device).contiguous()
    if K == 1:
        out_shape = (t.shape if values.ndim == 2 else values.shape[:1])
        return values[..., 0, :].expand(out_shape + values.shape[-1:])
    idx = torch.clamp(torch.searchsorted(times, t, right=True) - 1, 0, K - 1)
    if order == SplineOrder.ZERO:
        return _take(values, idx)
    lo = torch.clamp(idx, 0, K - 2)
    hi = lo + 1
    t_lo, t_hi = times[lo], times[hi]
    h = torch.clamp(t_hi - t_lo, min=_EPS)
    s = torch.clamp((t - t_lo) / h, 0.0, 1.0)[..., None]
    v_lo, v_hi = _take(values, lo), _take(values, hi)
    if order == SplineOrder.LINEAR:
        return v_lo * (1.0 - s) + v_hi * s
    if order == SplineOrder.CUBIC:
        slopes = fd_slopes(times, values)
        m_lo, m_hi = _take(slopes, lo), _take(slopes, hi)
        s2, s3 = s * s, s * s * s
        hh = h[..., None]
        return ((2 * s3 - 3 * s2 + 1) * v_lo + (s3 - 2 * s2 + s) * hh * m_lo
                + (-2 * s3 + 3 * s2) * v_hi + (s3 - s2) * hh * m_hi)
    raise ValueError(f"unknown spline order {order}")


def spline_resample(times: torch.Tensor, values: torch.Tensor,
                    new_times: torch.Tensor,
                    order: int = SplineOrder.ZERO) -> torch.Tensor:
    """The spline's values at a new knot grid (a policy shifted to now):
    spline_sample at `new_times`."""
    return spline_sample(times, values, new_times, order)
