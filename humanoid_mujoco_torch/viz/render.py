"""Software renderer for policy/trajectory visualization.

Counterpart of humanoid_mujoco_tpu/viz/render.py. The reference renders
policies through MuJoCo's OpenGL pipeline: the interactive viewer (its
rl/visualize_policy.py) and green-screen MP4 export (its
rl/generate_policy_videos.py:36-51, cv2.VideoWriter). Without a GL
stack, and since the engine's native geometry is the sphere cloud (the
collision proxies of physics/model.py), this renderer draws exactly
what the physics simulates: depth-sorted, Lambert-shaded collision
spheres over the floor heightfield, projected through a simple pinhole
camera. The kinematics run on the model's device (`fwd_position`,
`sphere_world_centers`); the drawing is numpy + cv2 on the host, and
cv2 is imported inside the drawing functions, so the module imports
without it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..physics.collision import sphere_world_centers
from ..physics.engine import fwd_position
from ..physics.model import Model

GREEN = (0, 255, 0)                  # green-screen background
SKY = (235, 206, 135)                # BGR light blue
_PALETTE = [                          # BGR per body (cycled)
    (60, 76, 203), (32, 165, 218), (113, 179, 60), (182, 89, 155),
    (167, 151, 59), (43, 57, 192), (140, 110, 70),
]


@dataclasses.dataclass
class Camera:
    """Orbit camera (the MuJoCo viewer's azimuth/elevation/distance)."""

    lookat: Sequence[float] = (0.0, 0.0, -0.25)
    distance: float = 1.6
    azimuth: float = 135.0      # degrees
    elevation: float = -15.0    # degrees
    fov: float = 45.0           # vertical, degrees

    def pose(self):
        az = np.deg2rad(self.azimuth)
        el = np.deg2rad(self.elevation)
        look = np.asarray(self.lookat, dtype=np.float64)
        # camera position on the orbit sphere
        fwd = np.array([np.cos(el) * np.cos(az),
                        np.cos(el) * np.sin(az),
                        np.sin(el)])          # eye -> lookat direction
        eye = look - self.distance * fwd
        # camera basis: +z forward, +x right, +y down (image coords)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        nr = np.linalg.norm(right)
        right = (np.array([1.0, 0.0, 0.0]) if nr < 1e-9 else right / nr)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])      # world -> cam rows
        return R, eye


def _project(R, eye, f, cx, cy, pts):
    """World points (N,3) -> pixel coords (N,2) + depth (N,)."""
    p = (pts - eye) @ R.T
    z = np.maximum(p[:, 2], 1e-6)
    u = cx + f * p[:, 0] / z
    v = cy + f * p[:, 1] / z
    return np.stack([u, v], axis=1), p[:, 2]


def to_host(x) -> np.ndarray:
    """x (a tensor on any device, or array-like) as a float64 numpy array."""
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x,
                      dtype=np.float64)


def hfield(m: Model) -> np.ndarray:
    """The floor's heightfield (nhrow, nhcol) on the host; a model
    patched for one env (its leaves batch-first) gives that env's."""
    h = to_host(m.hfield_data)
    return h[0] if h.ndim == 3 else h


def world_centers(m: Model, qpos) -> np.ndarray:
    """World centres (T, nsph, 3) of the collision spheres at each of
    qpos (T, nq), float64 on the host: one batched forward kinematics
    on the model's device, in its dtype."""
    q = torch.as_tensor(np.asarray(qpos), dtype=m.dtype, device=m.device)
    kin = fwd_position(m, q)
    return to_host(sphere_world_centers(m, kin.xpos, kin.xmat))


def render_frame(m: Model, qpos, width: int = 480, height: int = 360,
                 camera: Optional[Camera] = None,
                 greenscreen: bool = False,
                 track_root: bool = True) -> np.ndarray:
    """One frame (H, W, 3) uint8 BGR of the model at `qpos`."""
    import cv2

    cam = camera or Camera()
    qpos = np.asarray(qpos, dtype=np.float64)
    if track_root and m.struct.nbody > 0 and qpos.shape[0] >= 3:
        # follow the root in x/y (the reference viewer tracks the torso)
        cam = dataclasses.replace(
            cam, lookat=(qpos[0], qpos[1], cam.lookat[2]))
    R, eye = cam.pose()
    f = 0.5 * height / np.tan(0.5 * np.deg2rad(cam.fov))
    cx, cy = 0.5 * width, 0.5 * height

    img = np.empty((height, width, 3), dtype=np.uint8)
    img[:] = GREEN if greenscreen else SKY

    floor_z = float(to_host(m.floor_z))
    if not greenscreen:
        # floor: checkerboard quads on z = floor_z (+ hfield if present)
        _draw_floor(img, m, R, eye, f, cx, cy, cam, floor_z)

    # spheres, painter's algorithm (far -> near)
    centers = world_centers(m, qpos[None])[0]
    radii = to_host(m.sph_radius)
    bodies = np.asarray(m.struct.sph_body, dtype=np.int64)
    if centers.shape[0]:
        px, depth = _project(R, eye, f, cx, cy, centers)
        order = np.argsort(-depth)
        light = np.array([-0.4, 0.3, 0.85])
        light /= np.linalg.norm(light)
        for i in order:
            z = depth[i]
            if z <= 1e-3:
                continue
            r_pix = int(max(1, round(f * radii[i] / z)))
            color = np.asarray(
                _PALETTE[bodies[i] % len(_PALETTE)], dtype=np.float64)
            # Lambert shade from the sphere normal facing the light
            to_cam = eye - centers[i]
            to_cam /= max(np.linalg.norm(to_cam), 1e-9)
            shade = 0.45 + 0.55 * max(0.0, float(np.dot(to_cam, light)))
            c = tuple(int(v) for v in np.clip(color * shade, 0, 255))
            cv2.circle(img, (int(round(px[i, 0])), int(round(px[i, 1]))),
                       r_pix, c, -1, lineType=cv2.LINE_AA)
            # rim highlight for depth perception
            cv2.circle(img, (int(round(px[i, 0])), int(round(px[i, 1]))),
                       r_pix, tuple(int(v * 0.6) for v in c), 1,
                       lineType=cv2.LINE_AA)
    return img


def _draw_floor(img, m: Model, R, eye, f, cx, cy, cam: Camera,
                floor_z: float):
    import cv2

    tile = 0.25
    n = 10
    x0 = np.floor(cam.lookat[0] / tile) * tile
    y0 = np.floor(cam.lookat[1] / tile) * tile
    hx, hy = to_host(m.hfield_halfsize)
    hdata = hfield(m)

    def zat(x, y):
        if hdata.size <= 4 or not np.any(hdata):
            return floor_z
        # bilinear sample matching collision.hfield_height
        gx = np.clip((x / hx + 1.0) * 0.5 * (hdata.shape[1] - 1),
                     0, hdata.shape[1] - 1.001)
        gy = np.clip((y / hy + 1.0) * 0.5 * (hdata.shape[0] - 1),
                     0, hdata.shape[0] - 1.001)
        i0, j0 = int(gy), int(gx)
        fy, fx_ = gy - i0, gx - j0
        h = (hdata[i0, j0] * (1 - fx_) * (1 - fy)
             + hdata[i0, j0 + 1] * fx_ * (1 - fy)
             + hdata[i0 + 1, j0] * (1 - fx_) * fy
             + hdata[i0 + 1, j0 + 1] * fx_ * fy)
        return floor_z + h

    for i in range(-n, n):
        for j in range(-n, n):
            xa, ya = x0 + i * tile, y0 + j * tile
            quad = np.array([
                [xa, ya, zat(xa, ya)],
                [xa + tile, ya, zat(xa + tile, ya)],
                [xa + tile, ya + tile, zat(xa + tile, ya + tile)],
                [xa, ya + tile, zat(xa, ya + tile)]])
            px, depth = _project(R, eye, f, cx, cy, quad)
            if np.any(depth <= 1e-3):
                continue
            shade = 190 if (i + j) % 2 == 0 else 150
            cv2.fillConvexPoly(img, px.astype(np.int32),
                               (shade, shade, shade),
                               lineType=cv2.LINE_AA)


def render_trajectory(m: Model, qpos_traj, path: str, fps: float = 50.0,
                      width: int = 480, height: int = 360,
                      camera: Optional[Camera] = None,
                      greenscreen: bool = False) -> str:
    """Write an MP4 (cv2.VideoWriter, the generate_policy_videos.py
    mechanism) of the qpos trajectory. Returns the written path."""
    import cv2

    qpos_traj = np.asarray(qpos_traj)
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (width, height))
    if not wr.isOpened():    # codec unavailable -> fall back to .avi
        path = path.rsplit(".", 1)[0] + ".avi"
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"),
                             fps, (width, height))
    for q in qpos_traj:
        wr.write(render_frame(m, q, width, height, camera,
                              greenscreen=greenscreen))
    wr.release()
    return path
