#!/usr/bin/env python3
"""Bring-up check of the path tracer on NVIDIA GPUs.

    python chip_smoke.py            one card: every phase below
    python chip_smoke.py --multi    four cards: the multi-device paths only

Phases (one card): devices; set-up (native builds, seeded scene
generation, loading); the CUDA traversal kernel against brute force and
against the XLA traversal at the 330k-triangle interior's real widths;
forward renders (cornell 1024^2 and its check against the independent
numpy oracle, the interior at 1920x1080 and its GPU/host-CPU agreement);
fwd+bwd steps (cornell train_steps, interior wavefront loss_and_grads
with geometry gradients, GPU/host-CPU gradient agreement); information
(compile and wall times, memory, kernel-vs-XLA traversal times).

With --multi: ray-sharded rendering, the overlapped gradient all-reduce
train step and primitive-sharded traversal, each against its one-card
result.

Any failed check raises, so the script exits non-zero; without a GPU it
exits non-zero before any phase.  The last line of standard output is
the JSON result.  `--rehearse` runs the same code at toy sizes on
whatever JAX finds (the CPU included) and never prints a result line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TIMES = {}


@contextlib.contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    TIMES[name] = time.perf_counter() - t0
    print(f"   {name}: {TIMES[name]:.1f} s", flush=True)


def check(ok, what):
    print(f"   {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    """nvidia-smi's name and power limit, from a child that does not
    touch JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def timed(fn, *args, reps=3):
    """(first call incl. compile, median steady time) in seconds."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, sorted(ts)[len(ts) // 2]


def at_size(scene, w, h):
    from raytracingrenderer_tpu.scene.types import Camera
    c = scene.camera
    return scene._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                        c.world_to_cam, w, h, c.origin,
                                        c.a_film))


def on_cpu(tree):
    import jax
    return jax.device_put(tree, jax.devices("cpu")[0])


# ---------------------------------------------------------------------------
# rays

def primary_rays(scene):
    from raytracingrenderer_tpu.render import pixel_grid
    from raytracingrenderer_tpu.scene.camera import generate_rays
    cam = scene.camera
    xs, ys = pixel_grid(cam.height, cam.width)
    return generate_rays(cam, xs + 0.5, ys + 0.5)


def bounce_rays(scene, o, d, hit, key):
    """One diffuse bounce from the hits: origin nudged off the surface,
    cosine-weighted direction about the face normal; misses inactive."""
    import jax
    import jax.numpy as jnp
    from raytracingrenderer_tpu.core.vec import V3
    from raytracingrenderer_tpu.geometry.intersect import BIG_T
    live = hit.tri >= 0
    tri = jnp.maximum(hit.tri, 0)
    n = scene.triangles.gn.gather(tri)
    n = V3(*(jnp.where(d.dot(n) > 0, -c, c) for c in n))
    x = o + d * jnp.minimum(hit.t, 1e6) + n * 1e-3
    g = jax.random.normal(key, (3, d.x.shape[0]))
    r = V3(g[0], g[1], g[2]).normalize()
    nd = (n + r).normalize()
    return x, nd, jnp.where(live, BIG_T, -1.0)


def shadow_rays(scene, x, live, key):
    """Segments from x toward a random point of a random light."""
    import jax
    import jax.numpy as jnp
    lt = scene.lights
    n = x.x.shape[0]
    k1, k2 = jax.random.split(key)
    li = jax.random.randint(k1, (n,), 0, lt.tri.shape[0])
    u = jax.random.uniform(k2, (2, n))
    su = jnp.sqrt(u[0])
    p = (lt.p0.gather(li) + lt.e1.gather(li) * (su * (1 - u[1]))
         + lt.e2.gather(li) * (su * u[1]))
    v = p - x
    dist = v.length()
    return x, v * (1.0 / jnp.maximum(dist, 1e-12)), jnp.where(
        live, dist * (1.0 - 1e-3), -1.0)


def sort_rays(scene, o, d, t0):
    import jax
    from raytracingrenderer_tpu.core.vec import V3
    from raytracingrenderer_tpu.geometry.intersect import _sort_key
    key = _sort_key(scene, o, d, t0 > 0)
    s = jax.lax.sort((key, o.x, o.y, o.z, d.x, d.y, d.z, t0), num_keys=1)
    return V3(*s[1:4]), V3(*s[4:7]), s[7]


# ---------------------------------------------------------------------------

def single(args, rehearse):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracingrenderer_tpu import diff
    from raytracingrenderer_tpu.config import RenderConfig
    from raytracingrenderer_tpu.geometry import bvh_native, intersect
    from raytracingrenderer_tpu.imaging import film as film_mod
    from raytracingrenderer_tpu.integrators import wavefront_diff
    from raytracingrenderer_tpu.ops import traverse
    from raytracingrenderer_tpu.render import render
    from raytracingrenderer_tpu.scene import synth
    from raytracingrenderer_tpu.scene.loader import load_scene
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle_pt import render_mean

    big = not rehearse
    info = {}

    with phase("set-up"):
        t0 = time.perf_counter()
        check(bvh_native.available(), "native BVH builder built")
        info["build_bvh_lib_s"] = time.perf_counter() - t0
        if traverse.cuda_present():
            t0 = time.perf_counter()
            traverse.register()
            info["build_traverse_lib_s"] = time.perf_counter() - t0
        sdir = os.path.join(ROOT, ".scenes", f"seed{args.seed}")
        t0 = time.perf_counter()
        cdir = synth.cornell(os.path.join(sdir, "cornell"))
        idir = synth.interior(os.path.join(sdir, "interior"),
                              triangles=330_000 if big else 3000,
                              seed=args.seed)
        info["generate_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cornell = load_scene(cdir)
        info["load_cornell_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        interior = load_scene(idir)
        info["load_interior_s"] = time.perf_counter() - t0
        print(f"   interior: {interior.triangles.count} triangles, "
              f"{interior.materials.count} materials, "
              f"{interior.num_lights} light triangles, BVH depth "
              f"{interior.bvh.depth}, leaves <= {interior.bvh.leaf_max}")
        print("   " + json.dumps({k: round(v, 2) for k, v in info.items()}))
        check(interior.triangles.count >= (300_000 if big else 2000),
              "interior at full scale")

    bvh, tris = interior.bvh, jax.lax.stop_gradient(interior.triangles)
    kernel = {a: jax.jit(lambda o, d, t, a=a: traverse.traverse(
        bvh, tris, o, d, t, a)) for a in (False, True)}
    xla = {a: jax.jit(lambda o, d, t, a=a: tuple(intersect.traverse_xla(
        bvh, tris, o, d, t, a))) for a in (False, True)}
    ab = {}

    with phase("kernel check"):
        check(traverse.cuda_present() or rehearse, "CUDA backend present")
        run_k = kernel if traverse.cuda_present() else xla
        n = 8192
        view = interior if big else at_size(interior, 64, 36)
        cam = view.camera
        o, d = primary_rays(view)
        rng = np.random.default_rng(args.seed)
        pix = cam.width * cam.height
        pick = jnp.asarray(rng.choice(pix, n // 2, replace=pix < n // 2))
        c = np.asarray([interior.bounds.centre.x, interior.bounds.centre.y,
                        interior.bounds.centre.z], np.float32)
        ro = c + rng.normal(size=(n // 2, 3)).astype(np.float32) * 1.5
        rd = rng.normal(size=(n // 2, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=1, keepdims=True)
        from raytracingrenderer_tpu.core.vec import V3
        o8 = V3(*(jnp.concatenate([a[pick], jnp.asarray(ro[:, i])])
                  for i, a in enumerate(o)))
        d8 = V3(*(jnp.concatenate([a[pick], jnp.asarray(rd[:, i])])
                  for i, a in enumerate(d)))
        t8 = jnp.full(n, intersect.BIG_T)
        hk = run_k[False](o8, d8, t8)
        hb = jax.jit(lambda o, d: intersect.closest_hit_brute(
            tris, o, d))(o8, d8)
        same = float(np.mean(np.asarray(hk[1]) == np.asarray(hb.tri)))
        check(same >= 0.999, f"kernel vs brute force on {n} rays: "
              f"triangle ids equal on {same:.5f} >= 0.999")
        both = (np.asarray(hk[1]) >= 0) & (np.asarray(hb.tri) >= 0)
        rel = float(np.max(np.abs(np.asarray(hk[0])[both]
                                  - np.asarray(hb.t)[both])
                           / np.abs(np.asarray(hb.t)[both])))
        check(rel <= 1e-4, f"kernel vs brute force: max rel t error "
              f"{rel:.2e} <= 1e-4")

        t_prim = jnp.full(o.x.shape[0], intersect.BIG_T)
        bk, bo = run_k[False](o, d, t_prim), xla[False](o, d, t_prim)
        cmp_hits(bk, bo, "1080p primaries" if big else "primaries")
        hit = intersect.Hit(*bo)
        bo_, bd_, bt_ = bounce_rays(interior, o, d, hit,
                                    jax.random.PRNGKey(args.seed))
        so, sd, st = sort_rays(interior, bo_, bd_, bt_)
        cmp_hits(run_k[False](so, sd, st), xla[False](so, sd, st),
                 "one sorted bounce")
        hb2 = intersect.Hit(*xla[False](bo_, bd_, bt_))
        x2 = bo_ + bd_ * jnp.minimum(hb2.t, 1e6)
        sho, shd, sht = shadow_rays(interior, x2, hb2.tri >= 0,
                                    jax.random.PRNGKey(args.seed + 1))
        occ_k = np.asarray(run_k[True](sho, shd, sht)[1] >= 0)
        occ_x = np.asarray(xla[True](sho, shd, sht)[1] >= 0)
        diff_n = int((occ_k != occ_x).sum())
        check(diff_n == 0, f"any-hit on {occ_k.size} shadow rays: "
              f"{diff_n} differ from the XLA traversal (must be 0)")

        # information: kernel vs XLA traversal, steady state
        for name, a, args_ in (
                ("primaries", False, (o, d, t_prim)),
                ("bounce_sorted", False, (so, sd, st)),
                ("bounce_unsorted", False, (bo_, bd_, bt_)),
                ("shadow_anyhit", True, (sho, shd, sht))):
            ab[name] = {
                "kernel_s": timed(run_k[a], *args_)[1],
                "xla_s": timed(xla[a], *args_, reps=1)[1],
                "rays": int(args_[0].x.shape[0])}
        ab["sort_s"] = timed(jax.jit(
            lambda o, d, t: sort_rays(interior, o, d, t)), bo_, bd_, bt_)[1]
        print("   " + json.dumps(ab))

    with phase("forward"):
        res = 1024 if big else 64
        cfg = RenderConfig(mis=True, jitter=True, max_depth=4)
        first, steady = timed(lambda: render(
            at_size(cornell, res, res), cfg, spp=16).buffer, reps=1)
        info["cornell_16spp_s"] = {"first": first, "steady": steady}
        print(f"   cornell {res}^2 16 spp: first {first:.1f} s, steady "
              f"{steady:.3f} s", flush=True)
        img = film_mod.to_hdr(render(at_size(cornell, res, res), cfg,
                                     spp=16))
        check(img.shape == (res, res, 3)
              and bool(jnp.isfinite(img).all()),
              f"cornell {res}^2 finite {img.shape}")
        sm = at_size(cornell, 64, 64) if big else at_size(cornell, 16, 16)
        ocfg = RenderConfig(mis=False, jitter=False, max_depth=4)
        ours = float(film_mod.to_hdr(render(sm, ocfg, spp=64)).mean())
        ref = float(render_mean(sm, spp=64, max_depth=4,
                                seed=args.seed).mean())
        check(abs(ours / ref - 1) <= 0.03, f"cornell vs numpy oracle at "
              f"{sm.camera.width}^2, 64 spp: mean ratio "
              f"{ours / ref:.4f} within 3%")

        w, h = (1920, 1080) if big else (64, 36)
        icfg = RenderConfig(mis=True, jitter=True, max_depth=4,
                            seed=args.seed)
        first, steady = timed(lambda: render(
            at_size(interior, w, h), icfg, spp=4).buffer, reps=1)
        info["interior_4spp_s"] = {"first": first, "steady": steady}
        print(f"   interior {w}x{h} 4 spp: first {first:.1f} s, steady "
              f"{steady:.3f} s", flush=True)
        img = film_mod.to_hdr(render(at_size(interior, w, h), icfg, spp=4))
        check(bool(jnp.isfinite(img).all()) and float(img.mean()) > 0,
              f"interior {w}x{h} 4 spp finite, mean {float(img.mean()):.4f}")

        small = at_size(interior, 96, 54)
        g_img = np.asarray(film_mod.to_hdr(render(small, icfg, spp=4)))
        with jax.default_device(jax.devices("cpu")[0]):
            c_img = np.asarray(film_mod.to_hdr(render(on_cpu(small), icfg,
                                                      spp=4)))
        corr = float(np.corrcoef(g_img.ravel(), c_img.ravel())[0, 1])
        ratio = float(g_img.mean() / c_img.mean())
        check(corr >= 0.99 and abs(ratio - 1) <= 0.02,
              f"interior 96x54 GPU vs host CPU: correlation {corr:.5f} "
              f">= 0.99, mean ratio {ratio:.5f} within 2%")

    with phase("fwd+bwd"):
        res = 512 if big else 32
        sc = at_size(cornell, res, res)
        cfg = RenderConfig(mis=True, jitter=False, max_depth=2)
        target = jnp.zeros((res, res, 3), jnp.float32)
        key = jax.random.PRNGKey(args.seed)
        t0 = time.perf_counter()
        trained, losses = diff.train_steps(sc, target, key, cfg, lr=0.5,
                                           n=3)
        losses = np.asarray(losses)
        info["cornell_train_steps3_first_s"] = time.perf_counter() - t0
        print(f"   cornell train_steps: "
              f"{info['cornell_train_steps3_first_s']:.1f} s", flush=True)
        # the trained scene's loss under the first step's key
        dcfg = diff._diff_cfg(cfg, sc)
        loss_at = jax.jit(lambda s: diff.render_loss(
            diff._split_scene(s)[0], s, target, jax.random.fold_in(key, 0),
            dcfg))
        after = float(loss_at(trained))
        check(np.isfinite(losses).all() and after < losses[0],
              f"cornell {res}^2 train_steps {losses.tolist()}: loss "
              f"under the first key falls {losses[0]:.5f} -> {after:.5f}")

        sc = at_size(interior, res, res)
        params, scene0 = diff._split_scene(sc)
        losses = []
        t0 = time.perf_counter()
        for i in range(3):
            loss, grads = wavefront_diff.loss_and_grads(
                diff._merge_scene(params, scene0), target, key, cfg)
            fin = all(bool(jnp.isfinite(g).all())
                      for g in jax.tree_util.tree_leaves(grads))
            check(fin, f"interior step {i}: gradients finite")
            losses.append(float(loss))
            params = jax.tree_util.tree_map(lambda p, g: p - 0.5 * g,
                                            params, grads)
        info["interior_3steps_s"] = time.perf_counter() - t0
        print(f"   interior fwd+bwd 3 steps: "
              f"{info['interior_3steps_s']:.1f} s", flush=True)
        check("tri_p0" in grads and losses[-1] < losses[0],
              f"interior {res}^2 wavefront fwd+bwd with geometry "
              f"gradients: losses {losses} fall")

        # GPU vs host-CPU gradients, cornell 64x64 (jitter off): sums run
        # in another order on the GPU (atomic scatter-adds, other
        # fusions), so each leaf agrees to 1e-2 of its largest magnitude
        gcfg = RenderConfig(mis=True, jitter=False, max_depth=2)
        s = at_size(cornell, 64, 64)
        tgt = jnp.zeros((64, 64, 3), jnp.float32)
        g_gpu = diff.param_grads(s, tgt, key, gcfg)
        with jax.default_device(jax.devices("cpu")[0]):
            g_cpu = diff.param_grads(on_cpu(s), tgt, key, gcfg)
        errs = {}
        for name in g_gpu:
            for i, (a, b) in enumerate(zip(
                    jax.tree_util.tree_leaves(g_gpu[name]),
                    jax.tree_util.tree_leaves(g_cpu[name]))):
                a, b = np.asarray(a), np.asarray(b)
                scale = max(float(np.abs(b).max()), 1e-12)
                errs[f"{name}[{i}]"] = float(np.abs(a - b).max()) / scale
        print("   " + json.dumps({k: f"{v:.1e}" for k, v in errs.items()}))
        worst = max(errs, key=errs.get)
        check(errs[worst] <= 1e-2, f"cornell 64^2 gradients GPU vs host "
              f"CPU: worst leaf {worst} off by {errs[worst]:.2e} of its "
              f"scale <= 1e-2")

    with phase("information"):
        dev = jax.devices()[0]
        from raytracingrenderer_tpu import render as render_mod
        from raytracingrenderer_tpu.render import specialize_config
        sc = at_size(cornell, 1024 if big else 64, 1024 if big else 64)
        cfg = specialize_config(RenderConfig(mis=True, jitter=True), sc)
        film = film_mod.new_film(sc.camera.height, sc.camera.width)
        mem = {}
        ma = render_mod._render_chunk.lower(
            sc, film, jax.random.PRNGKey(0), jnp.int32(0), cfg=cfg,
            n=16).compile().memory_analysis()
        mem["cornell_render_chunk16"] = mem_dict(ma)
        sc = at_size(cornell, 512 if big else 32, 512 if big else 32)
        # the fwd+bwd phase's own configuration, so its compile is reused
        dcfg = diff._diff_cfg(RenderConfig(mis=True, jitter=False,
                                           max_depth=2), sc)
        ma = diff._train_steps_impl.lower(
            sc, jnp.zeros((sc.camera.height, sc.camera.width, 3)),
            jax.random.PRNGKey(0), cfg=dcfg, lr=0.5,
            n=3).compile().memory_analysis()
        mem["cornell_train_steps3"] = mem_dict(ma)
        stats = dev.memory_stats() or {}
        info["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        info["memory_analysis"] = mem
        info["phase_s"] = dict(TIMES)
        info["traversal_ab"] = ab
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
                  "w") as f:
            json.dump(info, f, indent=1, default=str)
        print("   " + json.dumps(info, default=str))


def cmp_hits(a, b, what):
    """Kernel hits vs XLA traversal hits: ids equal on >= 99.9% of rays
    and t within rtol 1e-4 where they are.  (Rays whose ids differ are
    rounding cases on triangle edges: about one in a million primaries
    on the interior, PERF.md.)"""
    import numpy as np
    ta, tria = np.asarray(a[0]), np.asarray(a[1])
    tb, trib = np.asarray(b[0]), np.asarray(b[1])
    eq = tria == trib
    check(eq.mean() >= 0.999, f"{what} ({tria.size} rays): kernel and "
          f"XLA triangle ids equal on {eq.mean():.7f} >= 0.999 "
          f"({int((~eq).sum())} differ)")
    both = eq & (trib >= 0)
    rel = float(np.max(np.abs(ta[both] - tb[both]) / np.abs(tb[both]),
                       initial=0.0))
    check(rel <= 1e-4, f"{what}: max rel t error {rel:.2e} <= 1e-4 where "
          f"the ids agree")


def mem_dict(ma):
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(ma, k, None) for k in keys}


# ---------------------------------------------------------------------------

def multi(args, rehearse):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracingrenderer_tpu import diff
    from raytracingrenderer_tpu.config import RenderConfig
    from raytracingrenderer_tpu.geometry import intersect
    from raytracingrenderer_tpu.parallel.mesh import make_mesh, render_sharded
    from raytracingrenderer_tpu.parallel.overlap import train_step_overlap
    from raytracingrenderer_tpu.parallel.scene_shard import (place_sharded,
                                                             traverse_sharded)
    from raytracingrenderer_tpu.render import sample_image, specialize_config
    from raytracingrenderer_tpu.scene import synth
    from raytracingrenderer_tpu.scene.loader import load_scene

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices >= 4")
    mesh = make_mesh(4)
    big = not rehearse
    with phase("set-up"):
        sdir = os.path.join(ROOT, ".scenes", f"seed{args.seed}")
        cornell = load_scene(synth.cornell(os.path.join(sdir, "cornell")))
        idir = synth.interior(os.path.join(sdir, "interior"),
                              triangles=330_000 if big else 3000,
                              seed=args.seed)
        interior = load_scene(idir)
        sharded = load_scene(idir, scene_shards=4)
        sharded = sharded._replace(bvh=place_sharded(sharded.bvh, mesh))

    with phase("ray-sharded render"):
        res = 512 if big else 32
        sc = at_size(cornell, res, res)
        cfg = specialize_config(RenderConfig(mis=True, jitter=True), sc)
        key = jax.random.PRNGKey(args.seed)
        one = np.asarray(jax.jit(lambda s, k: sample_image(s, k, cfg))(
            sc, key))
        four = np.asarray(render_sharded(sc, key, cfg, mesh))
        # Same keys, same paths; but XLA compiles the 4-device program
        # with other fusions, so last bits differ on some pixels and a
        # last-bit difference can flip one path's roulette or lobe
        # choice (a handful of 262k pixels on the H100; PERF.md).  So:
        # all but 1e-4 of the pixels within 1e-5, and equal means.
        far = np.abs(one - four).max(-1) > 1e-5 * (1 + np.abs(one).max(-1))
        ratio = float(four.mean() / one.mean())
        check(far.mean() <= 1e-4 and abs(ratio - 1) <= 1e-5,
              f"render_sharded {res}^2 on 4 devices vs sample_image on one:"
              f" {int(far.sum())} of {far.size} pixels differ by > 1e-5 "
              f"(<= 1e-4 of them), max abs difference "
              f"{float(np.abs(one - four).max()):.2e}, mean ratio "
              f"{ratio:.8f}")

    with phase("overlapped train step"):
        res = 64 if big else 16
        sc = at_size(cornell, res, res)
        cfg = RenderConfig(mis=True, jitter=False, max_depth=2)
        target = jnp.zeros((res, res, 3), jnp.float32)
        key = jax.random.PRNGKey(args.seed + 1)
        s4, l4 = train_step_overlap(sc, target, key, cfg, mesh, lr=0.5)
        s1, l1 = diff._train_step_impl(sc, target, key,
                                       diff._diff_cfg(cfg, sc), 0.5)
        check(abs(float(l4) / float(l1) - 1) <= 1e-4,
              f"overlap loss {float(l4):.6f} vs one device "
              f"{float(l1):.6f} (rtol 1e-4)")
        p4, _ = diff._split_scene(s4)
        p1, _ = diff._split_scene(s1)
        worst = 0.0
        for a, b in zip(jax.tree_util.tree_leaves(p4),
                        jax.tree_util.tree_leaves(p1)):
            a, b = np.asarray(a), np.asarray(b)
            worst = max(worst, float(np.max(np.abs(a - b)
                                            / (np.abs(b) + 1e-6))))
        check(worst <= 2e-3, f"overlap parameters after one step vs one "
              f"device: max rel difference {worst:.2e} <= 2e-3")

    with phase("primitive-sharded traversal"):
        o, d = primary_rays(at_size(interior, 960, 540) if big
                            else at_size(interior, 64, 36))
        n = o.x.shape[0]
        t0 = jnp.full(n, intersect.BIG_T)
        rep = jax.jit(lambda o, d, t: intersect.closest_hit(interior, o, d))
        hs = traverse_sharded(sharded.bvh, o, d, t0, mesh=mesh)
        hr = rep(o, d, t0)
        vs, vr = np.asarray(hs.tri) >= 0, np.asarray(hr.tri) >= 0
        agree = float(np.mean(vs == vr))
        both = vs & vr
        rel = float(np.max(np.abs(np.asarray(hs.t)[both]
                                  - np.asarray(hr.t)[both])
                           / np.asarray(hr.t)[both], initial=0.0))
        check(agree >= 0.9999 and rel <= 1e-4,
              f"sharded vs replicated closest hit on {n} rays: hit masks "
              f"agree on {agree:.6f}, max rel t error {rel:.2e}")
        mt = jnp.where(jnp.asarray(vr), jnp.asarray(hr.t) * 0.5, 1.0)
        occ_s = np.asarray(traverse_sharded(sharded.bvh, o, d, mt,
                                            any_hit=True, mesh=mesh).tri
                           >= 0)
        occ_r = np.asarray(jax.jit(lambda o, d, m: intersect.occluded(
            interior, o, d, m))(o, d, mt))
        check(bool((occ_s == occ_r).all()),
              f"sharded vs replicated any-hit on {n} rays: "
              f"{int((occ_s != occ_r).sum())} differ (must be 0)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the generated scenes and rays")
    p.add_argument("--multi", action="store_true",
                   help="run the four-device paths only")
    p.add_argument("--rehearse", action="store_true",
                   help="toy sizes on any platform; prints no result")
    args = p.parse_args(argv)

    import jax
    sys.path.insert(0, ROOT)
    from raytracingrenderer_tpu.utils import compile_cache
    print(f"compile cache: {compile_cache.enable()}")
    devs = jax.devices()
    dev = devs[0]
    print(f"devices: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devs)}", flush=True)
    if dev.platform != "gpu" and not args.rehearse:
        print("no GPU: JAX found only " + dev.platform, file=sys.stderr)
        return 1
    if not args.rehearse:
        print("card: " + card_line().replace("\n", " | "), flush=True)
    (multi if args.multi else single)(args, args.rehearse)
    if args.rehearse:
        print("rehearsal finished (no result line)")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
