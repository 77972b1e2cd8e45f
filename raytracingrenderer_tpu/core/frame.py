"""Orthonormal shading frames for vector batches.

Capability parity with the reference Frame (RTBase/Core.h:507-542):
build a tangent frame from a normal, transform directions local<->world.
We use the branchless Duff et al. 2017 construction instead of the
reference's Gram-Schmidt-with-branch — identical semantics (any valid
tangent frame), but free of data-dependent branches, which matters under
vectorization on the VPU.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .vec import V3


class Frame(NamedTuple):
    t: V3  # tangent  (local +x)
    b: V3  # bitangent (local +y)
    n: V3  # normal   (local +z)

    @staticmethod
    def from_normal(n: V3) -> "Frame":
        # Branchless ONB (Duff et al., JCGT 2017).
        s = jnp.where(n.z >= 0.0, 1.0, -1.0)
        a = -1.0 / (s + n.z)
        b = n.x * n.y * a
        t = V3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
        bt = V3(b, s + n.y * n.y * a, -n.y)
        return Frame(t, bt, n)

    def to_world(self, w: V3) -> V3:
        return self.t * w.x + self.b * w.y + self.n * w.z

    def to_local(self, w: V3) -> V3:
        return V3(w.dot(self.t), w.dot(self.b), w.dot(self.n))
