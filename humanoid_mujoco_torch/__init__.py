"""PyTorch/CUDA port of humanoid_mujoco_tpu, one slice at a time.

This package is the second implementation of the rigid-body engine,
rollouts, task costs and planners, written for PyTorch on an NVIDIA
H100. The JAX package beside it is the reference each part is tested
against. Functions take batch-leading `(B, ...)` tensors; the model
is shared across the batch.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
On a machine without a card they raise instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless told otherwise.

    Raises when `cuda` is asked for (explicitly or by default) and no
    card is present: the port never falls back to the CPU quietly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "humanoid_mujoco_torch runs on cuda by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


from .agent import Agent  # noqa: E402  (needs resolve_device above)

__all__ = ["resolve_device", "Agent"]
