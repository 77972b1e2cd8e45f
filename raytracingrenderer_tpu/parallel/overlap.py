"""Explicit-SPMD training step with the parameter-gradient all-reduce
placed INSIDE the backward bounce scan (SURVEY.md §2.11 row 6).

`diff._train_step_impl` leaves collective placement to XLA's SPMD
partitioner: with rays sharded and params replicated, XLA emits one
all-reduce per parameter at the very END of the backward pass — a
barrier where every device waits on communication it could have started
bounces earlier.  Here the train step is an explicit `shard_map` over
the `rays` mesh axis, and each bounce of the scan re-injects the
parameter pytree through a custom-VJP identity whose backward is a
`psum`.  Reverse-mode turns the bounce scan into a reverse scan, so the
psum of bounce k's parameter-grad partial executes inside the backward
scan body, interleaved with bounce k-1's backward compute — the
collective runs on the interconnect while the compute units keep
working (the classic DP gradient-bucket overlap, per-bounce instead of
per-layer).

Correctness: sum_k psum(partial_k) == psum(sum_k partial_k), so the
overlapped and barriered schedules produce identical gradients —
tests/test_parallel.py pins this, and against diff.param_grads.
Whether the overlap hides the collective on four GPUs is not measured.

Pixel jitter here is keyed by PIXEL ID (rng.uniform_ids) rather than
lane shape, so the estimate is invariant to the ray sharding (the
shape-keyed jitter of render.sample_image would decohere across device
counts).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from ..config import RenderConfig
from ..core.vec import V3
from ..integrators import path as path_mod
from ..sampling import rng
from ..scene.camera import generate_rays
from ..scene.types import Scene
from .mesh import RAY_AXIS


@jax.custom_vjp
def _allreduce_in_bwd(tree, salt):
    """Identity whose backward all-reduces the cotangent over the ray
    axis.  Applied per bounce, it schedules one psum per scan step of
    the backward pass instead of one barrier at the end.

    `salt` must be an iteration-dependent scalar (the bounce depth):
    applied to the loop-invariant params alone, the identity would be
    hoisted out of the scan by partial evaluation and its backward
    would collapse back into one end-of-loop reduction — the data
    dependence on the scan counter pins one application (and thus one
    backward psum) per bounce."""
    del salt
    return tree


def _arb_fwd(tree, salt):
    return tree, None


def _arb_bwd(_, g):
    return jax.lax.psum(g, RAY_AXIS), jnp.float32(0.0)


_allreduce_in_bwd.defvjp(_arb_fwd, _arb_bwd)


def _trace_shard(params, scene: Scene, xs, ys, ids, key, cfg: RenderConfig,
                 overlap: bool) -> V3:
    """Radiance for this device's ray shard; params enter per-bounce
    (overlap=True) or once outside the scan (barriered baseline)."""
    from ..diff import _merge_scene
    if cfg.jitter:
        jx = rng.uniform_ids(key, 0, rng.PIXEL_JITTER_X, ids)
        jy = rng.uniform_ids(key, 0, rng.PIXEL_JITTER_Y, ids)
    else:
        jx = jy = 0.5
    if not overlap:
        # single end-of-backward psum (the barriered baseline)
        params = _allreduce_in_bwd(params, jnp.float32(0.0))
    o, d = generate_rays(scene.camera, xs + jx, ys + jy)
    state = path_mod.init_state(o, d)
    state["ids"] = ids.astype(jnp.uint32)  # GLOBAL pixel ids, not lanes

    def bounce(state, depth):
        p = (_allreduce_in_bwd(params, depth.astype(jnp.float32))
             if overlap else params)
        sc = _merge_scene(p, scene)
        return path_mod.bounce_step(sc, state, depth, key, cfg), None

    body = bounce
    if cfg.remat:
        body = jax.checkpoint(
            bounce,
            policy=jax.checkpoint_policies.save_only_these_names(
                "ray_hit", "ray_occ"),
            prevent_cse=False)
    n_bounces = cfg.max_depth + 2
    state, _ = jax.lax.scan(body, state,
                            jnp.arange(n_bounces, dtype=jnp.int32))
    return state["radiance"]


def _loss_shard(params, scene, xs, ys, ids, target, key, cfg, n_total,
                overlap):
    rad = _trace_shard(params, scene, xs, ys, ids, key, cfg, overlap)
    err = rad.stacked() - target
    # local sum over the shard / GLOBAL pixel count: grads of replicated
    # params become global through the in-scan psums
    return jnp.sum(err * err) / (n_total * 3.0)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "mesh", "overlap", "lr"))
def _sharded_step(scene: Scene, target: jax.Array, key, cfg: RenderConfig,
                  mesh: Mesh, overlap: bool, lr: float):
    from ..diff import _merge_scene, _split_scene
    params, _ = _split_scene(scene)
    h, w = scene.camera.height, scene.camera.width
    n = h * w
    ys, xs = jnp.mgrid[0:h, 0:w]
    xs = xs.reshape(-1).astype(jnp.float32)
    ys = ys.reshape(-1).astype(jnp.float32)
    ids = jnp.arange(n, dtype=jnp.uint32)
    tgt = target.reshape(n, 3)

    def local(params, scene, xs, ys, ids, tgt, key):
        loss, grads = jax.value_and_grad(_loss_shard)(
            params, scene, xs, ys, ids, tgt, key, cfg, n, overlap)
        # loss is a local partial; grads are already global (psum in bwd)
        return jax.lax.psum(loss, RAY_AXIS), grads

    loss, grads = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS),
                  P(RAY_AXIS), P()),
        out_specs=(P(), P()),
        check_rep=False,
    )(params, scene, xs, ys, ids, tgt, key)
    new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params,
                                        grads)
    return _merge_scene(new_params, scene), loss, grads


def train_step_overlap(scene: Scene, target: jax.Array, key,
                       cfg: RenderConfig, mesh: Mesh, lr: float = 0.1,
                       overlap: bool = True
                       ) -> Tuple[Scene, jax.Array]:
    """One SGD step with explicit collective placement over `mesh`.

    overlap=True: per-bounce psum inside the backward scan (the §2.11
    north-star schedule).  overlap=False: identical math with one
    end-of-backward psum (the barriered baseline the bench compares
    against)."""
    from ..diff import _diff_cfg
    cfg = _diff_cfg(cfg, scene)
    new_scene, loss, _ = _sharded_step(scene, target, key, cfg, mesh,
                                       overlap, lr)
    return new_scene, loss


def param_grads_sharded(scene: Scene, target: jax.Array, key,
                        cfg: RenderConfig, mesh: Mesh,
                        overlap: bool = True):
    """Gradients + loss under the explicit-SPMD schedule (for tests and
    the overlap bench)."""
    from ..diff import _diff_cfg
    cfg = _diff_cfg(cfg, scene)
    _, loss, grads = _sharded_step(scene, target, key, cfg, mesh,
                                   overlap, 0.0)
    return grads, loss
