"""Deterministic counter-based RNG for rendering.

The reference uses one MT19937 per worker thread, all seeded identically
(RTBase/Sampling.h:13-26, Renderer.h:55) — which correlates
tiles.  Here every random decision is keyed by (base seed, spp index,
bounce, decision id), and each lane of the flat ray batch draws an
independent value from a single batched threefry call, so renders are
bit-reproducible regardless of device count or sharding.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Decision ids: stable enumeration of every RNG consumption point so that
# adding a new decision never perturbs existing streams.
PIXEL_JITTER_X = 0
PIXEL_JITTER_Y = 1
LIGHT_PICK = 2
LIGHT_POS_U = 3
LIGHT_POS_V = 4
RR = 5
BSDF_U = 6
BSDF_V = 7
BSDF_LOBE = 8
LENS_U = 9
LENS_V = 10
LIGHT_AUX = 11   # alias-table accept test + in-texel u offset
# Boundary-term edge sampling (integrators/boundary.py); per-sample
# streams are decorrelated by folding the sample index into the key,
# so three decision ids cover any boundary_samples count.
BND_PICK = 12
BND_EDGE = 13
BND_T = 14
BND_CELL = 15   # guided-cell pick + mixture branch (one uniform)
_NUM_DECISIONS = 16


def spp_key(base_key: jax.Array, spp_index) -> jax.Array:
    return jax.random.fold_in(base_key, spp_index)


def decision_key(key: jax.Array, bounce, decision: int) -> jax.Array:
    return jax.random.fold_in(key, bounce * _NUM_DECISIONS + decision)


def uniform(key: jax.Array, bounce, decision: int, shape) -> jax.Array:
    """U[0,1) array of `shape` for one decision point of one bounce."""
    return jax.random.uniform(decision_key(key, bounce, decision), shape,
                              dtype=jnp.float32)


def uniform_ids(key: jax.Array, bounce, decision: int,
                ids: jax.Array) -> jax.Array:
    """U[0,1) per lane, keyed by the lane's PIXEL id instead of its
    position: one threefry block per (key, bounce, decision, pixel).

    This makes every stream invariant under lane permutation, so the
    wavefront integrator's sort + live-ray compaction (and any ray
    resharding) is bit-transparent — the per-pixel estimate is the same
    whether a ray is traced at lane 3 or lane 300000.

    Counter layout matters: threefry_2x32 hashes counter lanes in PAIRS
    (lane i with lane i+n/2), so hashing the raw ids array would couple
    a lane's value to whatever id happens to sit a half-array away.
    Instead each lane's 2x32 counter block is (pixel id, bounce*16 +
    decision) — one hash per lane, pure in that lane's id.
    """
    from jax.extend.random import threefry_2x32
    n = ids.shape[0]
    kd = jax.random.key_data(key).reshape(2).astype(jnp.uint32)
    hi = jnp.broadcast_to(
        (jnp.uint32(bounce) * jnp.uint32(_NUM_DECISIONS)
         + jnp.uint32(decision)), (n,))
    bits = threefry_2x32(kd, jnp.concatenate(
        [ids.astype(jnp.uint32), hi]))[:n]
    # top 24 bits -> [0, 1) with a full float32 mantissa
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2**-24)
