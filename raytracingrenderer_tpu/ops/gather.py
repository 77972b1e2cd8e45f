"""Row gather for hot per-ray lookups into small tables.

Lookups into a table of at most `ONEHOT_MAX_ROWS` rows go through a
one-hot matmul at HIGHEST precision instead of an XLA gather.  The point
is the backward pass: the transpose of a gather is a scatter-add, which
on a GPU becomes about a million atomic adds contending for a few dozen
rows, while the transpose of the matmul is another matmul.  On an H100
(700 W) cornell's 512^2 fwd+bwd step took 13.9 ms with the one-hot form
and 25.7-26.4 ms with plain indexing (PERF.md, PR 1).  HIGHEST keeps
full float32: 0/1 weights then select rows exactly, where TF32 would
round them.

This replaces the reference's pointer-chasing attribute reads (Triangle
fields + BSDF* dispatch, RTBase/Scene.h:174-203, Materials.h:94-116).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Above this row count the (N, T) one-hot operand's traffic outweighs the
# scatter it replaces; larger tables use a native row gather.
ONEHOT_MAX_ROWS = 128


def gather_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """table (T, K) f32, idx (N,) int -> (N, K) rows.

    Out-of-range indices must be pre-clipped by the caller.
    """
    t = table.shape[0]
    if t <= ONEHOT_MAX_ROWS:
        onehot = (idx[:, None]
                  == jnp.arange(t, dtype=idx.dtype)[None, :]
                  ).astype(table.dtype)
        return jax.lax.dot_general(
            onehot, table, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)
    return table[idx]


def gather_cols(cols, idx: jax.Array):
    """Gather k same-length 1-D float columns by a shared (N,) index.

    Small tables route through ONE one-hot matmul for all k columns
    (module docstring); big tables, 2-D index blocks (the brute-force
    intersector) and host-side numpy indices use native gathers.
    """
    t = cols[0].shape[0]
    # isinstance: host-side numpy gathers (scene loading) stay numpy
    if (isinstance(idx, jax.Array) and idx.ndim == 1
            and t <= ONEHOT_MAX_ROWS
            and all(jnp.issubdtype(c.dtype, jnp.floating) for c in cols)):
        table = jnp.stack(cols, axis=-1)            # (T, k)
        rows = gather_rows(table, idx)              # (N, k)
        return tuple(rows[:, i] for i in range(len(cols)))
    return tuple(c[idx] for c in cols)
