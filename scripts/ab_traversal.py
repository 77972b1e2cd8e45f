#!/usr/bin/env python3
"""A/B measurements behind the traversal and gather choices (one GPU).

    python scripts/ab_traversal.py [--seed N]

On the 330k-triangle interior at 1920x1080, for leaf sizes 4, 8 and 14:
the CUDA kernel on primaries, one bounce (coherence-sorted and
unsorted) and shadow rays, plus one full 1-spp `render()` through the
kernel; at leaf size 8 also the XLA traversal on the same rays.  Then
one full render through the XLA dispatch, the cornell 1024^2 render
rate, and cornell 512^2 fwd+bwd with the one-hot matmul gather against
plain indexing, alternated A, B, B, A.  Prints one JSON
line per measurement and writes them all to
chiprun_out/ab_traversal.json.  Times are steady-state medians on the
host clock around block_until_ready; first calls (compiles) are kept
apart.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

OUT = []


def emit(**rec):
    OUT.append(rec)
    print(json.dumps(rec), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--xla-reps", type=int, default=1)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from raytracingrenderer_tpu.config import RenderConfig
    from raytracingrenderer_tpu.geometry import bvh as bvh_mod
    from raytracingrenderer_tpu.geometry import intersect
    from raytracingrenderer_tpu.ops import gather, traverse
    from raytracingrenderer_tpu.render import render
    from raytracingrenderer_tpu.scene import synth
    from raytracingrenderer_tpu.scene.loader import load_scene
    from raytracingrenderer_tpu.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 1
    card = cs.card_line()
    emit(what="device", kind=dev.device_kind, card=card)
    traverse.register()
    sdir = os.path.join(ROOT, ".scenes", f"seed{args.seed}")
    idir = synth.interior(os.path.join(sdir, "interior"), seed=args.seed)
    cdir = synth.cornell(os.path.join(sdir, "cornell"))

    def ray_sets(sc):
        o, d = cs.primary_rays(sc)
        t = jnp.full(o.x.shape[0], intersect.BIG_T)
        xla = jax.jit(lambda o, d, t: tuple(intersect.traverse_xla(
            sc.bvh, sc.triangles, o, d, t, False)))
        hit = intersect.Hit(*xla(o, d, t))
        bo, bd, bt = cs.bounce_rays(sc, o, d, hit, jax.random.PRNGKey(1))
        so, sd, st = cs.sort_rays(sc, bo, bd, bt)
        hb = intersect.Hit(*xla(so, sd, st))
        x2 = so + sd * jnp.minimum(hb.t, 1e6)
        sh = cs.shadow_rays(sc, x2, hb.tri >= 0, jax.random.PRNGKey(2))
        return {"primaries": ((o, d, t), False),
                "bounce_sorted": ((so, sd, st), False),
                "bounce_unsorted": ((bo, bd, bt), False),
                "shadow_anyhit": (sh, True)}

    cfg = RenderConfig(mis=True, jitter=True, max_depth=4, seed=args.seed)
    for leaf in (4, 8, 14):
        bvh_mod.MAX_LEAF = leaf
        t0 = time.perf_counter()
        sc = load_scene(idir)
        load_s = time.perf_counter() - t0
        emit(what="tree", leaf=leaf, nodes=int(sc.bvh.right.shape[0]),
             depth=sc.bvh.depth, sah=bvh_mod.sah_cost(sc.bvh),
             load_s=load_s)
        tris = jax.lax.stop_gradient(sc.triangles)
        impls = {
            "kernel": lambda a: jax.jit(lambda o, d, t: traverse.traverse(
                sc.bvh, tris, o, d, t, a)),
            "xla": lambda a: jax.jit(
                lambda o, d, t: tuple(intersect.traverse_xla(
                    sc.bvh, tris, o, d, t, a))),
        }
        if leaf != 8:      # the XLA walk is timed at one leaf size
            impls = {"kernel": impls["kernel"]}
        for name, (rays, any_hit) in ray_sets(sc).items():
            for impl, make in impls.items():
                reps = 5 if impl == "kernel" else args.xla_reps
                first, steady = cs.timed(make(any_hit), *rays, reps=reps)
                emit(what="traverse", leaf=leaf, rays=name, impl=impl,
                     n=int(rays[0].x.shape[0]), first_s=first,
                     steady_s=steady)
        for rep in range(2):
            t0 = time.perf_counter()
            jax.block_until_ready(render(sc, cfg, spp=1).buffer)
            emit(what="render_1080p_1spp", leaf=leaf, impl="kernel",
                 call=rep, s=time.perf_counter() - t0)

    # the XLA dispatch end to end (the dispatch asks cuda_present() at
    # trace time; clear the jit caches so it is asked again)
    bvh_mod.MAX_LEAF = 8
    sc = load_scene(idir)
    traverse.cuda_present = lambda: False
    jax.clear_caches()
    for rep in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(render(sc, cfg, spp=1).buffer)
        emit(what="render_1080p_1spp", leaf=8, impl="xla",
             call=rep, s=time.perf_counter() - t0)

    # cornell 1024^2 forward (brute force path)
    cornell = load_scene(cdir)
    ccfg = RenderConfig(mis=True, jitter=True, max_depth=4)
    for rep in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(render(cornell, ccfg, spp=32).buffer)
        emit(what="cornell_1024_32spp", call=rep,
             s=time.perf_counter() - t0)

    # one-hot matmul gather vs plain indexing: cornell 512^2 fwd+bwd
    from raytracingrenderer_tpu import diff
    sc = cs.at_size(cornell, 512, 512)
    dcfg = RenderConfig(mis=True, jitter=True, max_depth=4)
    target = jnp.zeros((512, 512, 3), jnp.float32)
    for form in ("onehot", "plain", "plain", "onehot"):
        gather.ONEHOT_MAX_ROWS = 128 if form == "onehot" else 0
        jax.clear_caches()
        step = lambda: diff.train_step(sc, target, jax.random.PRNGKey(0),
                                       dcfg, lr=0.1)[1]
        first, steady = cs.timed(step, reps=3)
        emit(what="cornell_512_fwdbwd", gather=form, first_s=first,
             steady_s=steady)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ab_traversal.json"),
              "w") as f:
        json.dump(OUT, f, indent=1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                          "power.limit,temperature.gpu", "--format=csv"],
                         capture_output=True, text=True).stdout
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
