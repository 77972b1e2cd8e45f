"""Structure-of-arrays 3-vectors.

Layout choice: a vector batch is three flat ``(N,)`` arrays rather than one
``(N, 3)`` array, so every elementwise op runs over contiguous, unit-stride
component arrays (coalesced on a GPU, vectorised on a CPU) and no op has a
minor axis of length 3.

Mirrors the capabilities of the reference math core
(RTBase/Core.h:16-195 — Vec3/Colour operators, dot, cross,
normalize, luminance) as a batched, differentiable JAX pytree.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

Scalar = Union[float, jax.Array]


class V3(NamedTuple):
    """A batch of 3-vectors (or RGB colours) as three component arrays."""

    x: jax.Array
    y: jax.Array
    z: jax.Array

    # ---- constructors -------------------------------------------------
    @staticmethod
    def of(x, y, z) -> "V3":
        return V3(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                  jnp.asarray(z, jnp.float32))

    @staticmethod
    def full(shape, x: float, y: float, z: float, dtype=jnp.float32) -> "V3":
        return V3(jnp.full(shape, x, dtype), jnp.full(shape, y, dtype),
                  jnp.full(shape, z, dtype))

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "V3":
        z = jnp.zeros(shape, dtype)
        return V3(z, z, z)

    @staticmethod
    def from_stacked(a: jax.Array) -> "V3":
        """From an (..., 3) array (host/scene code only; not the hot path)."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def stacked(self) -> jax.Array:
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # ---- arithmetic ----------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # ---- geometry ------------------------------------------------------
    def dot(self, o: "V3") -> jax.Array:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y,
                  self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def length_sq(self) -> jax.Array:
        return self.dot(self)

    def length(self) -> jax.Array:
        return jnp.sqrt(self.length_sq())

    def normalize(self, eps: float = 1e-20) -> "V3":
        inv = jax.lax.rsqrt(jnp.maximum(self.length_sq(), eps))
        return self * inv

    # ---- colour --------------------------------------------------------
    def lum(self) -> jax.Array:
        """Rec.709 luminance (reference Colour::Lum, Core.h:88-92)."""
        return 0.2126 * self.x + 0.7152 * self.y + 0.0722 * self.z

    def max_comp(self) -> jax.Array:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    # ---- utility -------------------------------------------------------
    def where(self, pred: jax.Array, other: "V3") -> "V3":
        """Select self where pred else other (broadcasts)."""
        return V3(jnp.where(pred, self.x, other.x),
                  jnp.where(pred, self.y, other.y),
                  jnp.where(pred, self.z, other.z))

    def gather(self, idx: jax.Array) -> "V3":
        # small tables: one gather for all 3 components (see
        # ops/gather.gather_cols)
        from ..ops.gather import gather_cols
        return V3(*gather_cols((self.x, self.y, self.z), idx))

    def astype(self, dtype) -> "V3":
        return V3(self.x.astype(dtype), self.y.astype(dtype),
                  self.z.astype(dtype))

    @property
    def shape(self):
        return jnp.shape(self.x)


def vdot(a: V3, b: V3) -> jax.Array:
    return a.dot(b)


def vcross(a: V3, b: V3) -> V3:
    return a.cross(b)


def vmax(a: V3, b: V3) -> V3:
    return V3(jnp.maximum(a.x, b.x), jnp.maximum(a.y, b.y),
              jnp.maximum(a.z, b.z))


def vmin(a: V3, b: V3) -> V3:
    return V3(jnp.minimum(a.x, b.x), jnp.minimum(a.y, b.y),
              jnp.minimum(a.z, b.z))


def vclamp(a: V3, lo: Scalar, hi: Scalar) -> V3:
    return V3(jnp.clip(a.x, lo, hi), jnp.clip(a.y, lo, hi),
              jnp.clip(a.z, lo, hi))


def vwhere(pred: jax.Array, a: V3, b: V3) -> V3:
    return a.where(pred, b)


def vlerp(a: V3, b: V3, t: Scalar) -> V3:
    return a * (1.0 - t) + b * t


def reflect_z(w: V3) -> V3:
    """Mirror about the local +z axis: (-x, -y, z)."""
    return V3(-w.x, -w.y, w.z)
