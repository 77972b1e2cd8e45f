"""Differentiable compacting wavefront: host-chained VJP over the
per-bounce dispatches.

The scan-mode training path (diff.py -> render.sample_image) pays full
batch width at every bounce; the forward wavefront integrator
(wavefront.py) compacts per bounce but its host loop cannot sit under
one jax.grad.  This module restores the gradient by doing on the host
exactly what jax.checkpoint does inside a scan:

  forward:  per bounce, run [sort_flush -> slice -> bounce] as a jitted
            dispatch at the compacted width, RECORDING (a) the step's
            inputs (img, ray state) and (b) the traversal results
            (closest hit + occlusion bits) — the same residual set the
            scan-mode remat policy saves
            (save_only_these_names("ray_hit", "ray_occ")).
  backward: walk the tape in reverse; each entry re-traces the step
            under jax.vjp with the SAVED hits replayed
            (path.bounce_step(saved=...)), so the shading/NEE/BSDF math
            recomputes at the compacted width and the BVH is never
            walked twice.  Parameter cotangents accumulate across
            bounces; ray-state cotangents chain through the sort (a
            permutation — lax.sort is linear in its payload) and the
            dead-ray radiance scatter (transpose = gather).

Because every random decision is keyed by pixel id, the taped forward
is bit-identical to wavefront.sample_image_wavefront, and the gradients
equal scan-mode jax.grad to float tolerance (tests/test_render.py).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core.vec import V3
from ..sampling import rng
from ..scene.camera import generate_rays
from ..scene.types import Scene
from . import path as path_mod
from .wavefront import _bucket, _sort_flush_impl

FLOAT_KEYS = ("o", "d", "throughput", "radiance", "prev_pdf")
NONDIFF_KEYS = ("ids", "alive", "can_hit_light")


def _split_state(state):
    return ({k: state[k] for k in FLOAT_KEYS},
            {k: state[k] for k in NONDIFF_KEYS})


@jax.jit
def _sort_flush_keep(scene: Scene, img, state):
    # non-donating: the tape holds the inputs across the host loop
    return _sort_flush_impl(scene, img, state)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _bounce_save(scene: Scene, state, depth, key, cfg: RenderConfig):
    return path_mod.bounce_step(scene, state, depth, key, cfg,
                                return_saved=True)


def _step(params, scene0: Scene, img, fstate, ndstate, depth, key,
          cfg: RenderConfig, w_out, saved):
    """One wavefront step as a pure function of (params, img, float
    state): sort_flush, slice to the recorded width, bounce with the
    recorded traversal results."""
    from ..diff import _merge_scene
    scene = _merge_scene(params, scene0)
    state = {**fstate, **ndstate}
    if depth > 0:  # depth 0 skips the sort (see _forward_tape)
        img, state, _ = _sort_flush_impl(scene, img, state)
        if saved is not None:
            state = jax.tree_util.tree_map(lambda a: a[:w_out], state)
    if saved is not None:
        state = path_mod.bounce_step(scene, state,
                                     jnp.int32(depth), key, cfg,
                                     saved=saved)
    f2, _ = _split_state(state)
    return img, f2


@functools.partial(jax.jit,
                   static_argnames=("cfg", "depth", "w_out", "has_bounce"))
def _step_vjp(params, scene0: Scene, img, fstate, ndstate, key, saved,
              ct_img, ct_fstate, *, cfg, depth, w_out, has_bounce):
    def f(params, img, fstate):
        return _step(params, scene0, img, fstate, ndstate, depth, key,
                     cfg, w_out, saved if has_bounce else None)

    _, vjp = jax.vjp(f, params, img, fstate)
    return vjp((ct_img, ct_fstate))


@jax.jit
def _final_flush_ct(ct_img_flat, ids):
    return ct_img_flat[ids]


@jax.jit
def _loss_and_ct(img, target):
    diff = img - target
    n = img.size
    return jnp.mean(diff * diff), (2.0 / n) * diff


def _forward_tape(scene: Scene, key, cfg: RenderConfig):
    """Taping twin of wavefront.sample_image_wavefront: same dispatch
    sequence and widths, plus per-bounce (inputs, traversal) records."""
    from ..render import pixel_grid
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
    tape = []
    for depth in range(cfg.max_depth + 2):
        img_in, state_in = img, state
        if depth > 0:  # depth 0 skips the sort, as in wavefront.py
            img, state, n_live = _sort_flush_keep(scene, img, state)
            w2 = _bucket(int(n_live), n)
            if int(n_live) == 0:
                tape.append((img_in, state_in, depth, w, None))
                # flush-only tail: the sorted state (radiance zeroed)
                # feeds the final flush unchanged
                break
            if w2 < w:
                state = jax.tree_util.tree_map(lambda a: a[:w2], state)
                w = w2
        state, saved = _bounce_save(scene, state, jnp.int32(depth), key,
                                    cfg)
        tape.append((img_in, state_in, depth, w, saved))
    img = img.at[state["ids"]].add(state["radiance"].stacked())
    return img.reshape(cam.height, cam.width, 3), tape, state


def loss_and_grads(scene: Scene, target, key, cfg: RenderConfig
                   ) -> Tuple[jax.Array, dict]:
    """MSE loss against `target` and its gradient w.r.t. the standard
    parameter surface (diff._split_scene), computed through the
    compacting wavefront.  Drop-in replacement for
    jax.value_and_grad(diff.render_loss) on BVH-scale scenes."""
    from ..diff import _diff_cfg, _merge_scene, _split_scene
    from ..render import specialize_config
    cfg = _diff_cfg(specialize_config(cfg, scene), scene)
    params, scene0 = _split_scene(scene)
    img, tape, last_state = _forward_tape(_merge_scene(params, scene0),
                                          key, cfg)
    loss, ct_img = _loss_and_ct(img, target)
    ct_img = ct_img.reshape(-1, 3)

    # final flush: img += scatter(radiance at ids)
    ct_fstate = jax.tree_util.tree_map(
        jnp.zeros_like, _split_state(last_state)[0])
    ct_fstate["radiance"] = V3.from_stacked(
        _final_flush_ct(ct_img, last_state["ids"]))

    grads = None
    for img_in, state_in, depth, w_out, saved in reversed(tape):
        f_in, nd_in = _split_state(state_in)
        gp, ct_img, ct_fstate = _step_vjp(
            params, scene0, img_in, f_in, nd_in, key, saved,
            ct_img, ct_fstate, cfg=cfg, depth=depth, w_out=w_out,
            has_bounce=saved is not None)
        grads = gp if grads is None else jax.tree_util.tree_map(
            jnp.add, grads, gp)
    return loss, grads


def train_step(scene: Scene, target, key, cfg: RenderConfig,
               lr: float = 0.1) -> Tuple[Scene, jax.Array]:
    """SGD step on the standard parameter surface through the wavefront
    backward (the compacted analogue of diff.train_step)."""
    from ..diff import _merge_scene, _split_scene
    loss, grads = loss_and_grads(scene, target, key, cfg)
    params, scene0 = _split_scene(scene)
    new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params,
                                        grads)
    return _merge_scene(new_params, scene0), loss
