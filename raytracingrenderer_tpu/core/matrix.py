"""4x4 matrix helpers (host-side numpy + batched jnp application).

Row-major 4x4 matrices matching the conventions of the reference math core
(RTBase/Core.h:205-505): DirectX-style perspective
(z in [0,1], row 3 = [0,0,-1,0]), lookAt that maps world->view, and
mulPoint / mulVec / mulPointAndPerspectiveDivide application semantics.

Matrices are tiny and built once per scene on the host, so they live in
numpy; the batched `apply_*` functions take jnp V3 batches for the hot path.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from .vec import V3


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def perspective(n: float, f: float, aspect: float, fov_deg: float) -> np.ndarray:
    """DX-style perspective; FOV in degrees is the *vertical* field of view.

    Matches reference Core.h:460-472 (Matrix::perspective).
    """
    t = 1.0 / math.tan(math.radians(fov_deg) * 0.5)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = t / aspect
    P[1, 1] = t
    P[2, 2] = -f / (f - n)
    P[2, 3] = -(f * n) / (f - n)
    P[3, 2] = -1.0
    return P


def look_at(from_p, to_p, up) -> np.ndarray:
    """World -> view matrix. Matches reference Core.h:439-459 (Matrix::lookAt)."""
    from_p = np.asarray(from_p, np.float64)
    to_p = np.asarray(to_p, np.float64)
    up = np.asarray(up, np.float64)
    dir_ = from_p - to_p
    dir_ = dir_ / np.linalg.norm(dir_)
    left = np.cross(up, dir_)
    left = left / np.linalg.norm(left)
    new_up = np.cross(dir_, left)
    M = np.zeros((4, 4), dtype=np.float64)
    M[0, :3] = left
    M[1, :3] = new_up
    M[2, :3] = dir_
    M[0, 3] = -from_p.dot(left)
    M[1, 3] = -from_p.dot(new_up)
    M[2, 3] = -from_p.dot(dir_)
    M[3, 3] = 1.0
    return M.astype(np.float32)


def invert(M: np.ndarray) -> np.ndarray:
    return np.linalg.inv(M.astype(np.float64)).astype(np.float32)


def mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    return (A.astype(np.float64) @ B.astype(np.float64)).astype(np.float32)


# ---- host-side single-point application (numpy) -------------------------

def mul_point_np(M: np.ndarray, p) -> np.ndarray:
    p = np.asarray(p, np.float64)
    q = M[:3, :3].astype(np.float64) @ p + M[:3, 3].astype(np.float64)
    return q.astype(np.float32)


def mul_vec_np(M: np.ndarray, v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return (M[:3, :3].astype(np.float64) @ v).astype(np.float32)


def mul_point_perspective_np(M: np.ndarray, p) -> np.ndarray:
    p = np.asarray(p, np.float64)
    q = M.astype(np.float64) @ np.append(p, 1.0)
    return (q[:3] / q[3]).astype(np.float32)


# ---- batched device application (jnp, V3 batches) -----------------------

def apply_point(M, p: V3) -> V3:
    """(M @ [p,1]).xyz for a batch of points; M is a (4,4) array."""
    M = jnp.asarray(M)
    return V3(M[0, 0] * p.x + M[0, 1] * p.y + M[0, 2] * p.z + M[0, 3],
              M[1, 0] * p.x + M[1, 1] * p.y + M[1, 2] * p.z + M[1, 3],
              M[2, 0] * p.x + M[2, 1] * p.y + M[2, 2] * p.z + M[2, 3])


def apply_vec(M, v: V3) -> V3:
    M = jnp.asarray(M)
    return V3(M[0, 0] * v.x + M[0, 1] * v.y + M[0, 2] * v.z,
              M[1, 0] * v.x + M[1, 1] * v.y + M[1, 2] * v.z,
              M[2, 0] * v.x + M[2, 1] * v.y + M[2, 2] * v.z)


def apply_point_perspective(M, p: V3) -> V3:
    M = jnp.asarray(M)
    q = apply_point(M, p)
    w = M[3, 0] * p.x + M[3, 1] * p.y + M[3, 2] * p.z + M[3, 3]
    inv_w = 1.0 / w
    return q * inv_w
