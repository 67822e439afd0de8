"""Visualization: the sphere-cloud software renderer and the browser
viewer (counterpart of humanoid_mujoco_tpu/viz)."""

from .render import Camera, render_frame, render_trajectory

__all__ = ["Camera", "render_frame", "render_trajectory"]
