"""Batched rigid-body physics: model, kinematics, dynamics, contacts,
and the step with its two CUDA kernels."""
