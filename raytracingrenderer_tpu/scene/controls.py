"""Fly-camera controls: WASD/QE moves + yaw rotation on a Camera.

Parity with reference RTCamera (RTBase/SceneLoader.h:8-90):
forward/back along the view direction, strafe left/right, up/down, and
left/right yaw via Rodrigues rotation of the offset about `up`.  Pure
functions Camera -> Camera (no global viewcamera singleton); the caller
resets the film on movement, as the reference's main loop does
(Main.cpp:84-109 calls rt.clear()).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..core import matrix
from ..core.vec import V3
from .types import Camera


class FlyCamera:
    """Host-side mutable from/to/up state, producing Camera pytrees."""

    def __init__(self, from_p, to_p, up, projection: np.ndarray,
                 width: int, height: int, movespeed: float = 1.0,
                 rotspeed_deg: float = 5.0):
        self.from_p = np.asarray(from_p, np.float64)
        self.to_p = np.asarray(to_p, np.float64)
        self.up = np.asarray(up, np.float64)
        self.p = np.asarray(projection, np.float32)
        self.width = width
        self.height = height
        self.movespeed = movespeed
        self.rotspeed = math.radians(rotspeed_deg)

    # -- movement (reference SceneLoader.h:20-60) ----------------------
    def _dir(self):
        d = self.to_p - self.from_p
        return d / np.linalg.norm(d)

    def forward(self, sign=1.0):
        step = self._dir() * (sign * self.movespeed)
        self.from_p += step
        self.to_p += step

    def back(self):
        self.forward(-1.0)

    def strafe(self, sign=1.0):
        right = np.cross(self._dir(), self.up)
        right /= np.linalg.norm(right)
        step = right * (sign * self.movespeed)
        self.from_p += step
        self.to_p += step

    def rise(self, sign=1.0):
        u = self.up / np.linalg.norm(self.up)
        step = u * (sign * self.movespeed)
        self.from_p += step
        self.to_p += step

    def yaw(self, sign=1.0):
        """Rodrigues rotation of (to - from) about up
        (reference SceneLoader.h:61-86)."""
        theta = sign * self.rotspeed
        k = self.up / np.linalg.norm(self.up)
        v = self.to_p - self.from_p
        v_rot = (v * math.cos(theta) + np.cross(k, v) * math.sin(theta)
                 + k * k.dot(v) * (1 - math.cos(theta)))
        self.to_p = self.from_p + v_rot

    # -- key dispatch (reference keys W/S/A/D/Q/E + arrows) ------------
    def key(self, k: str):
        k = k.lower()
        if k == "w":
            self.forward()
        elif k == "s":
            self.back()
        elif k == "a":
            self.strafe(-1.0)
        elif k == "d":
            self.strafe(1.0)
        elif k == "q":
            self.rise(1.0)
        elif k == "e":
            self.rise(-1.0)
        elif k == "left":
            self.yaw(1.0)
        elif k == "right":
            self.yaw(-1.0)

    def camera(self) -> Camera:
        V = matrix.look_at(self.from_p, self.to_p, self.up)
        c2w = matrix.invert(V)
        w_lens = 2.0 / self.p[1, 1]
        h_lens = w_lens * (self.p[0, 0] / self.p[1, 1])
        origin = matrix.mul_point_np(c2w, [0.0, 0.0, 0.0])
        return Camera(
            p=jnp.asarray(self.p), p_inv=jnp.asarray(matrix.invert(self.p)),
            cam_to_world=jnp.asarray(c2w), world_to_cam=jnp.asarray(V),
            width=self.width, height=self.height,
            origin=V3.of(*origin),
            a_film=jnp.float32(abs(w_lens * h_lens)))
