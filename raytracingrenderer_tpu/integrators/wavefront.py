"""Compacting wavefront path tracer: host-level bounce loop with
live-ray compaction into power-of-two width buckets.

The scan-mode integrator (path.py) pays full batch width at every
bounce even though Russian roulette and escapes kill most rays after a
couple of bounces — on bathroom the mean live fraction over 6 bounces
is ~45%, so nearly half the shading/NEE/BSDF vector work burns on dead
lanes.  Here each bounce is its own device dispatch at a width that
tracks the live count:

  per bounce:  [sort by coherence key + flush dead radiance]  (jit)
               -> host reads live count, slices the live prefix to the
                  next power-of-two bucket (few distinct widths => few
                  compiles; the XLA dispatch between jits is host code)
               -> [bounce_step at the compacted width]          (jit)

The sort also groups rays by origin cell and direction octant, so
neighbouring lanes traverse similar nodes, and radiance rides compacted: a ray's accumulated radiance is scattered
into the image exactly once, when it dies (then zeroed, so dead rays
retained by bucket rounding contribute nothing twice).

Because every random decision is keyed by PIXEL id (rng.uniform_ids),
this integrator is estimator-identical to scan mode — same paths, same
numbers, different lane placement.  tests/test_render.py asserts the
images match to float-add tolerance.

This is the "sort/compact rays by liveness" design SURVEY.md §7 plans,
replacing the reference's tile queue (Renderer.h:795-853) whose threads
get both load balancing and coherence from screen tiles.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core.vec import V3
from ..geometry import intersect
from ..sampling import rng
from ..scene.camera import generate_rays
from ..scene.types import Scene
from . import path as path_mod

# Bucket widths are multiples of n/16 (floor n/8): measured bathroom
# liveness [1, .84, .63, .48, .36, .27] lands on [1, .875, .6875, .5,
# .375, .3125] — 3.75n rays of bounce work vs 4.5n with power-of-two
# buckets and 3.875n with the r3 n/8 steps, for at most ~10 distinct
# bounce-graph compiles per scene (each width is its own XLA compile,
# amortized by the persistent cache).
_MIN_WIDTH = 1 << 15


def _bucket(n_live: int, n: int) -> int:
    step = max(_MIN_WIDTH, n // 16)
    floor = max(_MIN_WIDTH, n // 8)
    w = max(((n_live + step - 1) // step) * step, floor)
    return min(w, n)


def _sort_flush_impl(scene: Scene, img: jax.Array, state: dict):
    """Sort state by the coherence key (live rays first), scatter the
    radiance of dead rays into the image (then zero it), count live.
    Pure jnp body — jitted with donation below for the forward-only
    path, and traced inside the host-chained backward
    (wavefront_diff.py) where the inputs must outlive the call."""
    alive = state["alive"]
    dead_rgb = jnp.where(alive[:, None], 0.0, state["radiance"].stacked())
    img = img.at[state["ids"]].add(dead_rgb)
    zero_r = V3(*(jnp.where(alive, c, 0.0) for c in state["radiance"]))
    state = dict(state, radiance=zero_r)

    key = intersect._sort_key(scene, state["o"], state["d"], alive)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    casts = [a.dtype for a in leaves]
    ops = [a.astype(jnp.int32) if a.dtype == jnp.bool_ else a
           for a in leaves]
    out = jax.lax.sort((key,) + tuple(ops), num_keys=1)
    sorted_leaves = [a.astype(t) if t == jnp.bool_ else a
                     for a, t in zip(out[1:], casts)]
    state = jax.tree_util.tree_unflatten(treedef, sorted_leaves)
    return img, state, jnp.sum(alive.astype(jnp.int32))


_sort_flush = functools.partial(jax.jit, donate_argnums=(1,))(
    _sort_flush_impl)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _bounce(scene: Scene, state: dict, depth: jax.Array, key: jax.Array,
            cfg: RenderConfig) -> dict:
    return path_mod.bounce_step(scene, state, depth, key, cfg)


@jax.jit
def _final_flush(img: jax.Array, state: dict) -> jax.Array:
    return img.at[state["ids"]].add(state["radiance"].stacked())


def sample_image_wavefront(scene: Scene, key: jax.Array,
                           cfg: RenderConfig) -> jax.Array:
    """One radiance sample per pixel -> (H, W, 3); estimator-identical
    to render.sample_image but with per-bounce live-ray compaction.
    Host-loop structure: NOT jittable as a whole (by design)."""
    from ..render import pixel_grid, specialize_config
    cfg = specialize_config(cfg, scene)
    cam = scene.camera
    xs, ys = pixel_grid(cam.height, cam.width)
    if cfg.jitter:
        jx = rng.uniform(key, 0, rng.PIXEL_JITTER_X, xs.shape)
        jy = rng.uniform(key, 0, rng.PIXEL_JITTER_Y, ys.shape)
    else:
        jx = jy = 0.5
    o, d = generate_rays(cam, xs + jx, ys + jy)
    n = cam.height * cam.width
    state = path_mod.init_state(o, d)
    img = jnp.zeros((n, 3), jnp.float32)
    w = n
    for depth in range(cfg.max_depth + 2):
        if depth == 0:
            # primaries: every ray is live (nothing to flush) and the
            # raster order is as coherent as the sort would make it
            # (one origin, pixel-adjacent directions) — skip the sort
            # dispatch entirely
            pass
        else:
            img, state, n_live = _sort_flush(scene, img, state)
            w2 = _bucket(int(n_live), n)
            if int(n_live) == 0:
                break
            if w2 < w:
                state = jax.tree_util.tree_map(lambda a: a[:w2], state)
                w = w2
        state = _bounce(scene, state, jnp.int32(depth), key, cfg)
    img = _final_flush(img, state)
    return img.reshape(cam.height, cam.width, 3)
