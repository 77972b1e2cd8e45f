"""Command-line renderer.

Flag-compatible with the reference app (RTBase/Main.cpp:
19-66: -scene, -outputFilename, -SPP) plus the knobs the reference bakes
in as compile-time constants (Renderer.h:18-24) or commented-out lines
(integrator switch, Renderer.h:876-885).  Headless: renders, reports
progress, writes HDR (and optional PNG preview), auto-checkpoints the
film.  Replaces the reference's D3D11 interactive window with -preview
PNG snapshots every N spp.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracingrenderer_tpu",
                                description=__doc__)
    p.add_argument("-scene", required=True,
                   help="scene directory containing scene.json (write one "
                        "with python -m raytracingrenderer_tpu.scene.synth)")
    p.add_argument("-outputFilename", default="GI.hdr")
    p.add_argument("-SPP", type=int, default=8192)
    p.add_argument("-integrator", default="path",
                   choices=["path", "direct", "albedo", "normals",
                            "lighttrace", "vpl", "adaptive"])
    p.add_argument("-maxDepth", type=int, default=4)
    p.add_argument("-noMIS", action="store_true",
                   help="reference-parity NEE without MIS")
    p.add_argument("-noJitter", action="store_true",
                   help="pixel centres only, like the reference")
    p.add_argument("-preview", type=int, default=0, metavar="N",
                   help="write <output>.png preview every N spp")
    p.add_argument("-checkpoint", default="",
                   help="film checkpoint path (resume if it exists)")
    p.add_argument("-checkpointEvery", type=int, default=0)
    p.add_argument("-timeBudget", type=float, default=0.0,
                   help="stop after this many seconds (reference stops at "
                        "10 s, Main.cpp:132-137); 0 = no budget")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-width", type=int, default=0,
                   help="override scene.json resolution")
    p.add_argument("-height", type=int, default=0)
    p.add_argument("-denoise", action="store_true",
                   help="edge-aware denoise of the final image")
    p.add_argument("-sceneShards", type=int, default=0,
                   help="shard the BVH + triangle geometry over this "
                        "many devices (beyond-HBM scenes); 0 = replicate")
    p.add_argument("-interactive", action="store_true",
                   help="fly-camera loop on stdin (reference Main.cpp "
                        "main loop: keys move + clear film, p/l save)")
    p.add_argument("-keys", default="",
                   help="scripted interactive session: comma-separated "
                        "keys applied between render ticks")
    p.add_argument("-profile", action="store_true",
                   help="phase timing report (load/render/denoise/write) "
                        "+ device memory stats at exit")
    p.add_argument("-trace", default="", metavar="DIR",
                   help="capture a jax.profiler trace of the render to "
                        "DIR (view with xprof/TensorBoard)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from .config import RenderConfig
    from .imaging import film as film_mod
    from .io.hdr import write_hdr
    from .io.png import write_png
    from .render import render
    from .scene.loader import load_scene
    from .utils.checkpoint import load_film, save_film
    from .utils.log import get_logger

    log = get_logger("cli")
    from .utils import compile_cache
    compile_cache.enable()
    # multi-host bootstrap (no-op single-process; a cluster manager's
    # env vars autodetect the cluster — SURVEY §2.11 comms backend row)
    from .parallel.distributed import init_distributed
    init_distributed()
    from .utils.profiling import Timer
    prof = Timer() if args.profile else None
    t0 = time.time()
    scene = load_scene(args.scene, scene_shards=args.sceneShards)
    if prof is not None:
        prof.totals["load"] = time.time() - t0
        prof.counts["load"] = 1
    if args.sceneShards:
        from .parallel.mesh import make_mesh
        from .parallel.scene_shard import place_sharded
        scene = scene._replace(bvh=place_sharded(
            scene.bvh, make_mesh(args.sceneShards)))
    if args.width or args.height:
        from .scene.types import Camera
        c = scene.camera
        scene = scene._replace(camera=Camera(
            c.p, c.p_inv, c.cam_to_world, c.world_to_cam,
            args.width or c.width, args.height or c.height,
            c.origin, c.a_film))
    log.info("scene %s: %d tris, %d materials, %d lights (%.1fs)",
             args.scene, scene.triangles.count, scene.materials.count,
             scene.num_lights, time.time() - t0)

    cfg = RenderConfig(spp=args.SPP, max_depth=args.maxDepth,
                       mis=not args.noMIS, jitter=not args.noJitter,
                       integrator=args.integrator, seed=args.seed)

    if args.interactive or args.keys:
        from .interactive import run_scripted, run_stdin
        out_base = args.outputFilename.rsplit(".", 1)[0]
        if args.keys:
            s = run_scripted(scene, args.scene, cfg, args.keys,
                             output=out_base)
        else:
            s = run_stdin(scene, args.scene, cfg, output=out_base)
        img = np.asarray(film_mod.to_hdr(s.film))
        write_hdr(args.outputFilename, img)
        log.info("wrote %s (%d spp, mean %.4f)", args.outputFilename,
                 s.spp, float(img.mean()))
        return 0

    film = None
    if args.checkpoint:
        film = load_film(args.checkpoint)
        if film is not None:
            log.info("resumed checkpoint at %d spp", int(film.spp))

    state = {"t_start": time.time(), "t_last": time.time(), "stop": False}

    def on_sample(s, f):
        f.buffer.block_until_ready()  # honest per-frame timing
        state["film"] = f  # survives a time-budget interrupt
        now = time.time()
        dt = now - state["t_last"]
        state["t_last"] = now
        h, w = f.buffer.shape[:2]
        log.info("spp %d  %.3fs/frame  %.2f Mpaths/s  total %.1fs",
                 s + 1, dt, h * w / max(dt, 1e-9) / 1e6,
                 now - state["t_start"])
        if args.preview and (s + 1) % args.preview == 0:
            write_png(args.outputFilename + ".png",
                      np.asarray(film_mod.tonemap(f)))
        if args.checkpoint and args.checkpointEvery and \
                (s + 1) % args.checkpointEvery == 0:
            save_film(args.checkpoint, f)
        if args.timeBudget and now - state["t_start"] > args.timeBudget:
            state["stop"] = True
            raise StopIteration

    import contextlib

    from .utils.profiling import trace
    trace_ctx = trace(args.trace) if args.trace else contextlib.nullcontext()
    prof_render = (prof.phase("render") if prof is not None
                   else contextlib.nullcontext())
    try:
        with trace_ctx, prof_render:
            if args.integrator == "path":
                film = render(scene, cfg, spp=args.SPP, film=film,
                              on_sample=on_sample)
            else:
                from .integrators.dispatch import render_with
                film = render_with(scene, cfg, spp=args.SPP, film=film,
                                   on_sample=on_sample)
    except StopIteration:
        log.info("time budget reached")
        film = state.get("film", film)
    if film is None:
        log.error("no samples rendered before the budget expired")
        return 1

    img = np.asarray(film_mod.to_hdr(film))
    if args.denoise:
        # OIDN-style auxiliary-guided filtering: albedo + normal AOVs
        # (reference passes beauty only, Renderer.h:752-793; guides are
        # strictly better and cheap — 1 spp each)
        import jax as _jax

        from .imaging.denoise import denoise as dn
        from .integrators import aov
        with (prof.phase("denoise") if prof is not None
              else contextlib.nullcontext()):
            aov_cfg = RenderConfig(jitter=False, seed=cfg.seed)
            guide_key = _jax.random.PRNGKey(cfg.seed)
            alb = aov.albedo_image(scene, guide_key, aov_cfg)
            nrm = aov.normals_image(scene, guide_key, aov_cfg)
            img = np.asarray(dn(img, albedo=alb, normal=nrm))
    with (prof.phase("write") if prof is not None
          else contextlib.nullcontext()):
        write_hdr(args.outputFilename, img)
    log.info("wrote %s (%d spp, mean %.4f)", args.outputFilename,
             int(film.spp), float(img.mean()))
    if args.checkpoint:
        save_film(args.checkpoint, film)
    if prof is not None:
        from .utils.profiling import device_memory_stats
        h, w = img.shape[:2]
        log.info("phase report:\n%s",
                 prof.report(rays=h * w * int(film.spp)))
        mem = device_memory_stats()
        if mem:
            log.info("device memory: %s",
                     {k: v for k, v in mem.items() if "bytes" in k})
    return 0


if __name__ == "__main__":
    sys.exit(main())
