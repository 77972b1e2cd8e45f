"""Multi-process and cross-shard communication tests (CPU backends).

SURVEY.md §4 calls for multi-process CPU-backend tests so pod-scale code
paths run without a cluster; §2.11's comms-backend row is this
framework's distribution layer (the reference is single-process shared
memory).  Two levels are exercised:

- REAL multi-process: two OS processes joined via
  jax.distributed.initialize (Gloo collectives on CPU), running the
  distributed-progressive-rendering pattern — each process renders
  different spp samples of the same scene and the films are reduced
  across processes (the film is the natural unit of distribution, as in
  the reference where it is the resumable accumulator, Imaging.h:253).
- in-process mesh: the sharded light tracer's psum'd film partials must
  match the unsharded run bit-for-bit (lighttracer.py's docstring
  contract).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import scene_path
from raytracingrenderer_tpu.config import RenderConfig
from raytracingrenderer_tpu.imaging import film as film_mod
from raytracingrenderer_tpu.integrators.lighttracer import light_trace_pass
from raytracingrenderer_tpu.parallel.mesh import make_mesh
from raytracingrenderer_tpu.scene.loader import load_scene
from raytracingrenderer_tpu.scene.types import Camera


_WORKER = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import sys
    pid = int(sys.argv[1])
    port = sys.argv[2]
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.multihost_utils import process_allgather
    from raytracingrenderer_tpu.config import RenderConfig
    from raytracingrenderer_tpu.parallel.distributed import pod_mesh
    from raytracingrenderer_tpu.render import (sample_image,
                                               specialize_config)
    from raytracingrenderer_tpu.sampling import rng
    from raytracingrenderer_tpu.scene.loader import load_scene
    from raytracingrenderer_tpu.scene.types import Camera

    assert jax.process_count() == 2
    mesh = pod_mesh()
    assert mesh.devices.size == len(jax.devices())

    sc = load_scene("%(scene)s")
    c = sc.camera
    sc = sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                   c.world_to_cam, 16, 16, c.origin,
                                   c.a_film))
    cfg = specialize_config(RenderConfig(max_depth=2, mis=True,
                                         jitter=True), sc)
    base = jax.random.PRNGKey(0)
    # distributed progressive rendering: process i renders spp sample i,
    # the (host-local) partial films are allgathered and summed — the
    # cross-host film reduction of SURVEY §2.11
    img = sample_image(sc, rng.spp_key(base, pid), cfg)
    partials = process_allgather(img)
    total = np.asarray(partials).sum(axis=0)
    print("SUM", float(total.sum()))
    # determinism across processes: same key -> identical image
    img0 = np.asarray(sample_image(sc, rng.spp_key(base, 0), cfg))
    g = np.asarray(process_allgather(img0))
    assert np.array_equal(g[0], g[1]), "cross-process determinism broken"
    print("OK", pid)
""")


@pytest.mark.slow
class TestMultiProcess:
    def test_two_process_film_reduction(self, tmp_path):
        scene = scene_path("cornell")
        code = _WORKER % {"scene": scene}
        port = "29741"
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(i), port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))) for i in range(2)]
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
            assert p.returncode == 0, out[-2000:]
        sums = [line for o in outs for line in o.splitlines()
                if line.startswith("SUM")]
        assert len(sums) == 2
        # both processes computed the same reduced film
        assert sums[0] == sums[1]

        # the reduced 2-sample film equals a single-process 2-spp render
        sc = load_scene(scene)
        c = sc.camera
        sc = sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                       c.world_to_cam, 16, 16, c.origin,
                                       c.a_film))
        from raytracingrenderer_tpu.render import render
        cfg = RenderConfig(max_depth=2, mis=True, jitter=True)
        f = render(sc, cfg, spp=2)
        expect = float(np.asarray(f.buffer).sum())
        got = float(sums[0].split()[1])
        np.testing.assert_allclose(got, expect, rtol=1e-5)


@pytest.mark.slow
class TestElasticRecovery:
    """SURVEY §5 failure-detection/elastic-recovery row: a worker killed
    mid-render is respawned from its film checkpoint and the final film
    is bit-identical to an uninterrupted render — every sample is keyed
    by (seed, spp index, pixel), so recovery replays nothing and loses
    nothing."""

    def test_kill_and_resume_matches_uninterrupted(self, tmp_path):
        from raytracingrenderer_tpu.parallel.elastic import (
            _ckpt_spp, render_elastic)
        from raytracingrenderer_tpu.render import render
        scene_dir = scene_path("cornell")
        out = str(tmp_path)
        spp = 4
        extra = ["-width", "16", "-height", "16", "-maxDepth", "2"]
        ck0 = f"{out}/worker0.npz"
        state = {"killed": False}

        def injector(procs):
            # fault injection: kill worker 0 (exact spawned PID) once it
            # has checkpointed at least 1 spp but before it finishes
            if state["killed"]:
                return
            p = procs.get(0)
            if p is not None and p.poll() is None and \
                    1 <= _ckpt_spp(ck0) < spp:
                p.kill()
                state["killed"] = True

        f = render_elastic(scene_dir, out, n_workers=2,
                           spp_per_worker=spp, seed=0, extra_args=extra,
                           on_poll=injector, poll_s=0.2)
        assert state["killed"], "fault injection never fired"
        assert float(f.spp) == 2 * spp

        # uninterrupted oracle, SAME pipeline: one fresh worker run with
        # worker 0's seed and no fault — the killed-and-resumed film
        # must match it bitwise (every sample is (seed, spp, pixel)
        # keyed, and resume replays nothing)
        out2 = str(tmp_path / "oracle")
        f2 = render_elastic(scene_dir, out2, n_workers=1,
                            spp_per_worker=spp, seed=0, extra_args=extra)
        from raytracingrenderer_tpu.utils.checkpoint import load_film
        w0 = load_film(ck0)
        w0_oracle = load_film(f"{out2}/worker0.npz")
        np.testing.assert_array_equal(np.asarray(w0.buffer),
                                      np.asarray(w0_oracle.buffer))
        # and the reduced film is exactly the sum of the worker films
        w1 = load_film(f"{out}/worker1.npz")
        np.testing.assert_allclose(
            np.asarray(f.buffer),
            np.asarray(w0.buffer) + np.asarray(w1.buffer), rtol=1e-7)


class TestShardedLightTracer:
    def test_sharded_matches_unsharded(self):
        sc = load_scene(scene_path("cornell"))
        c = sc.camera
        sc = sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                       c.world_to_cam, 32, 32, c.origin,
                                       c.a_film))
        cfg = RenderConfig(max_depth=2, mis=False, jitter=False)
        film0 = film_mod.new_film(32, 32)
        key = jax.random.PRNGKey(7)
        n_paths = 1024

        plain = jax.jit(lambda f, k: light_trace_pass(
            sc, f, k, cfg, n_paths))(film0, key)
        mesh = make_mesh(8)
        sharded = jax.jit(lambda f, k: light_trace_pass(
            sc, f, k, cfg, n_paths, mesh=mesh))(film0, key)
        np.testing.assert_allclose(np.asarray(plain.buffer),
                                   np.asarray(sharded.buffer),
                                   rtol=1e-5, atol=1e-7)
        assert float(np.asarray(sharded.buffer).sum()) > 0.0
