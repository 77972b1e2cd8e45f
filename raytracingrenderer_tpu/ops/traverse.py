"""Per-ray BVH traversal on NVIDIA GPUs: a CUDA kernel called via jax.ffi.

The kernel (`native/traverse.cu`) runs one thread per ray with a
private `MAX_STACK`-entry stack, visits the nearer child first, skips
stacked subtrees that start beyond the closest hit found so far, and in
its any-hit form stops at the first occluder.  This module packs the
tables it reads, pads the ray batch, builds and registers the library at
first use, and calls it.  `geometry.intersect` selects it for BVH scenes
when the computation is lowered for CUDA; everywhere else the XLA
traversal in `geometry.intersect` runs, and it is also this kernel's
plain reference.

Table layouts (mirrored by `native/traverse.cu`):
- nodes (B, 16) f32, one 64-byte row per BVH node.  An inner node's row
  holds both children: [lo_l, hi_l, lo_r, hi_r, code_l, code_r, 0, 0]
  with the codes stored as int32 bits.  A child code >= 0 is the child's
  node index (its own row); a code < 0 is a leaf,
  `leaf_code(start, count)`.  A leaf's own row holds the leaf itself as
  its left child and an empty right child, so a root that is a leaf
  needs no special case.
- tris (T, 12) f32: [p0, 0, e1, 0, e2, 0], three 16-byte loads.

Outputs are not differentiable (hit structure is detached, see
`intersect.closest_hit`), so the call has no VJP.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.vec import V3
from ..utils import native

MAX_STACK = 64    # traverse.cu kMaxStack: a tree's depth may not exceed it
BLOCK = 128       # traverse.cu kBlock: rays are padded to a multiple of it
MAX_LEAF = 15     # a leaf code keeps the triangle count in 4 bits

_TARGETS = {False: "rt_closest_hit", True: "rt_any_hit"}


def leaf_code(start, count):
    """Negative int32 child code of a leaf of `count` triangles from
    `start`."""
    return -(1 + start * 16 + count)


def check(bvh) -> None:
    """Refuse trees the kernel cannot walk: deeper than its stack, or
    with leaves too large for the 4-bit count field."""
    if bvh.depth > MAX_STACK:
        raise ValueError(f"BVH depth {bvh.depth} exceeds the traversal "
                         f"kernel's stack of {MAX_STACK}")
    if bvh.leaf_max > MAX_LEAF:
        raise ValueError(f"BVH leaves of {bvh.leaf_max} triangles exceed "
                         f"the traversal kernel's {MAX_LEAF}")


def pack_nodes(bvh) -> jax.Array:
    """(B, 16) f32 node rows (module docstring)."""
    b = bvh.right.shape[0]
    i = jnp.arange(b, dtype=jnp.int32)
    is_leaf = bvh.right < 0
    left = jnp.where(is_leaf, i, jnp.minimum(i + 1, b - 1))
    right = jnp.where(is_leaf, i, bvh.right)

    def code(c):
        return jnp.where(bvh.right[c] < 0,
                         leaf_code(bvh.start[c], bvh.count[c]), c)

    leaf_col = is_leaf[:, None]
    ints = jnp.stack([code(left), jnp.where(is_leaf, leaf_code(0, 0),
                                            code(right)),
                      jnp.zeros_like(i), jnp.zeros_like(i)], axis=-1)
    return jnp.concatenate([
        bvh.lo[left], bvh.hi[left],
        jnp.where(leaf_col, jnp.inf, bvh.lo[right]),
        jnp.where(leaf_col, -jnp.inf, bvh.hi[right]),
        jax.lax.bitcast_convert_type(ints.astype(jnp.int32), jnp.float32),
    ], axis=-1).astype(jnp.float32)


def pack_tris(tris) -> jax.Array:
    """(T, 12) f32 triangle rows (module docstring)."""
    z = jnp.zeros_like(tris.p0.x)
    return jnp.stack([tris.p0.x, tris.p0.y, tris.p0.z, z,
                      tris.e1.x, tris.e1.y, tris.e1.z, z,
                      tris.e2.x, tris.e2.y, tris.e2.z, z], axis=-1)


def cuda_present() -> bool:
    """Whether this process has a CUDA backend to lower the kernel for."""
    try:
        return bool(jax.devices("cuda"))
    except RuntimeError:
        return False


@functools.lru_cache(maxsize=None)
def register() -> str:
    """Build `native/build/libtraverse.so` (once per process, skipped when
    up to date) and register its two FFI targets for CUDA."""
    path = native.build("build/libtraverse.so",
                        FFI_INCLUDE=jax.ffi.include_dir())
    lib = ctypes.cdll.LoadLibrary(path)
    jax.ffi.register_ffi_target(_TARGETS[False],
                                jax.ffi.pycapsule(lib.RtClosestHit),
                                platform="CUDA")
    jax.ffi.register_ffi_target(_TARGETS[True],
                                jax.ffi.pycapsule(lib.RtAnyHit),
                                platform="CUDA")
    return path


def _kernel_call(any_hit: bool, nodes, tris, *rays
                 ) -> Tuple[jax.Array, ...]:
    """The FFI call on padded (N,) ray arrays -> (t, tri, u, v)."""
    n = rays[0].shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    out = jax.ffi.ffi_call(
        _TARGETS[any_hit],
        (f32, jax.ShapeDtypeStruct((n,), jnp.int32), f32, f32),
        vmap_method="sequential")(nodes, tris, *rays)
    # under shard_map the result varies over the same mesh axes as rays
    vma = tuple(jax.typeof(rays[0]).vma)
    if vma:
        out = tuple(jax.lax.pcast(a, vma, to="varying") for a in out)
    return out


def traverse(bvh, tris, o: V3, d: V3, t_init: jax.Array,
             any_hit: bool = False, call=_kernel_call):
    """Closest (or any) hit within t_init per ray -> (t, tri, u, v).

    Misses keep t = t_init and tri = -1; lanes with t_init <= 0 are
    inactive.  `call` is the kernel launch (tests substitute a host
    reference of the same contract)."""
    check(bvh)
    n = o.x.shape[0]
    pad = (-n) % BLOCK

    def p(a, fill):
        return jnp.pad(a.astype(jnp.float32), (0, pad), constant_values=fill)

    rays = ([p(c, 0.0) for c in (o.x, o.y, o.z)]
            + [p(c, 1.0) for c in (d.x, d.y, d.z)] + [p(t_init, -1.0)])
    nodes = pack_nodes(jax.lax.stop_gradient(bvh))
    tri_rows = pack_tris(jax.lax.stop_gradient(tris))
    t, tri, u, v = call(any_hit, nodes, tri_rows, *rays)
    return t[:n], tri[:n], u[:n], v[:n]
