"""Multi-device tests on the virtual 8-device CPU mesh.

The key property: renders are bit-identical (or numerically identical)
regardless of device count, because randomness is drawn as one global
array keyed by (seed, spp) — the fix for the reference's duplicated
per-thread seeds (Renderer.h:55).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import scene_path
from raytracingrenderer_tpu.config import RenderConfig
from raytracingrenderer_tpu.parallel.mesh import RAY_AXIS, make_mesh
from raytracingrenderer_tpu.render import sample_image
from raytracingrenderer_tpu.scene.loader import load_scene
from raytracingrenderer_tpu.scene.types import Camera


@pytest.fixture(scope="module")
def scene():
    sc = load_scene(scene_path("cornell"))
    c = sc.camera
    return sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                     c.world_to_cam, 32, 32, c.origin,
                                     c.a_film))


CFG = RenderConfig(max_depth=2, mis=True, jitter=True)


class TestSharding:
    def test_eight_devices_available(self):
        assert len(jax.devices()) == 8

    def test_sharded_matches_single(self, scene):
        key = jax.random.PRNGKey(3)
        img1 = np.asarray(sample_image(scene, key, CFG))

        mesh = make_mesh(8)
        sharded = jax.device_put(scene, NamedSharding(mesh, P()))
        fn = jax.jit(lambda sc, k: sample_image(sc, k, CFG),
                     out_shardings=NamedSharding(mesh, P(RAY_AXIS, None,
                                                         None)))
        img8 = np.asarray(fn(sharded, key))
        np.testing.assert_allclose(img1, img8, rtol=1e-4, atol=1e-5)

    def test_mesh_sizes(self, scene):
        key = jax.random.PRNGKey(4)
        imgs = []
        for n in (2, 4):
            mesh = make_mesh(n)
            sharded = jax.device_put(scene, NamedSharding(mesh, P()))
            fn = jax.jit(lambda sc, k: sample_image(sc, k, CFG))
            imgs.append(np.asarray(fn(sharded, key)))
        np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-4, atol=1e-5)


@pytest.mark.slow
class TestDryrun:
    def test_dryrun_multichip(self):
        import sys
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import __graft_entry__ as ge
        ge.dryrun_multichip(8)

    def test_entry_compiles(self):
        import sys
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import __graft_entry__ as ge
        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert out.shape == (128, 128, 3)
        assert bool(jnp.isfinite(out).all())


class TestOverlapTrainStep:
    """Explicit-SPMD train step with per-bounce gradient psums inside
    the backward scan (SURVEY §2.11 row 6) — schedules differ,
    gradients must not."""

    def test_overlap_matches_barriered(self, scene):
        from raytracingrenderer_tpu.parallel.overlap import (
            param_grads_sharded)
        cfg = RenderConfig(max_depth=2, mis=True, jitter=True)
        key = jax.random.PRNGKey(5)
        target = jnp.zeros((32, 32, 3), jnp.float32)
        mesh = make_mesh(8)
        g_ov, l_ov = param_grads_sharded(scene, target, key, cfg, mesh,
                                         overlap=True)
        g_ba, l_ba = param_grads_sharded(scene, target, key, cfg, mesh,
                                         overlap=False)
        assert float(l_ov) == pytest.approx(float(l_ba), rel=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(g_ov),
                        jax.tree_util.tree_leaves(g_ba)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)
        # gradients are real (non-trivial) and finite
        assert float(jnp.abs(g_ov["albedo"].x).sum()) > 0
        for leaf in jax.tree_util.tree_leaves(g_ov):
            assert bool(jnp.isfinite(leaf).all())

    def test_overlap_matches_xla_spmd(self, scene):
        """Same gradients as the XLA-placed jit path (jitter off: the
        jit path keys jitter by lane shape, the shard_map path by pixel
        id — with jitter disabled the estimators coincide exactly)."""
        from raytracingrenderer_tpu.diff import param_grads
        from raytracingrenderer_tpu.parallel.overlap import (
            param_grads_sharded)
        cfg = RenderConfig(max_depth=2, mis=True, jitter=False)
        key = jax.random.PRNGKey(6)
        target = jnp.zeros((32, 32, 3), jnp.float32)
        g_ov, _ = param_grads_sharded(scene, target, key, cfg,
                                      make_mesh(4), overlap=True)
        g_ref = param_grads(scene, target, key, cfg)
        for k in g_ref:
            for a, b in zip(jax.tree_util.tree_leaves(g_ov[k]),
                            jax.tree_util.tree_leaves(g_ref[k])):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=2e-3, atol=1e-6)

    def test_device_count_invariant(self, scene):
        from raytracingrenderer_tpu.parallel.overlap import (
            param_grads_sharded)
        cfg = RenderConfig(max_depth=2, mis=True, jitter=True)
        key = jax.random.PRNGKey(7)
        target = jnp.zeros((32, 32, 3), jnp.float32)
        g2, _ = param_grads_sharded(scene, target, key, cfg, make_mesh(2))
        g8, _ = param_grads_sharded(scene, target, key, cfg, make_mesh(8))
        for a, b in zip(jax.tree_util.tree_leaves(g2),
                        jax.tree_util.tree_leaves(g8)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)

    def test_train_step_descends(self, scene):
        from raytracingrenderer_tpu.parallel.overlap import (
            train_step_overlap)
        cfg = RenderConfig(max_depth=2, mis=True, jitter=True)
        key = jax.random.PRNGKey(8)
        target = jnp.zeros((32, 32, 3), jnp.float32)
        mesh = make_mesh(8)
        sc, l0 = train_step_overlap(scene, target, key, cfg, mesh, lr=0.5)
        sc, l1 = train_step_overlap(sc, target, key, cfg, mesh, lr=0.5)
        assert float(l1) < float(l0)


class TestSceneSharding:
    """Primitive-sharded intersection must match the replicated oracle."""

    def test_sharded_matches_replicated(self, scene):
        from raytracingrenderer_tpu.geometry.intersect import (
            closest_hit_brute)
        from raytracingrenderer_tpu.parallel.scene_shard import (
            closest_hit_sharded, pad_triangles, shard_triangles)
        mesh = make_mesh(8)
        tris = pad_triangles(scene.triangles, 8)
        tris_sh = shard_triangles(mesh, tris)
        import numpy as np_
        rng = np_.random.default_rng(0)
        n = 512
        from raytracingrenderer_tpu.core.vec import V3
        o = V3.from_stacked(jnp.asarray(
            (rng.uniform(-1, 1, (n, 3)) * 0.5 + [0, 1, 2])
            .astype(np_.float32)))
        d = V3.from_stacked(jnp.asarray(
            rng.standard_normal((n, 3)).astype(np_.float32))).normalize()
        hs = closest_hit_sharded(tris_sh, o, d, mesh)
        hb = closest_hit_brute(scene.triangles, o, d)
        np.testing.assert_allclose(np.asarray(hs.t), np.asarray(hb.t),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(hs.tri),
                                      np.asarray(hb.tri))


class TestSceneShardingBVH:
    """The real scene-sharding path: per-shard sub-BVH traversal under
    shard_map (loader scene_shards=N), matching the replicated render."""

    def test_traverse_sharded_matches_oracle(self):
        from raytracingrenderer_tpu.core.vec import V3
        from raytracingrenderer_tpu.geometry.intersect import (
            BIG_T, closest_hit_brute)
        from raytracingrenderer_tpu.parallel.scene_shard import (
            place_sharded, traverse_sharded)
        sc_rep = load_scene(scene_path("interior"))
        sc = load_scene(scene_path("interior"), scene_shards=8)
        mesh = make_mesh(8)
        sb = place_sharded(sc.bvh, mesh)
        rng = np.random.default_rng(0)
        n = 512
        c = np.asarray([sc.bounds.centre.x, sc.bounds.centre.y,
                        sc.bounds.centre.z], np.float32)
        r = float(sc.bounds.radius)
        o = V3.from_stacked(jnp.asarray(
            (c + rng.normal(size=(n, 3)) * r * 0.5).astype(np.float32)))
        d = V3.from_stacked(jnp.asarray(
            rng.standard_normal((n, 3)).astype(np.float32))).normalize()
        hs = traverse_sharded(sb, o, d, jnp.full(n, BIG_T), mesh=mesh)
        hb = closest_hit_brute(sc_rep.triangles, o, d)
        np.testing.assert_allclose(np.asarray(hs.t), np.asarray(hb.t),
                                   rtol=1e-4, atol=1e-4)
        # shadow segments: occluded set matches the brute oracle
        from raytracingrenderer_tpu.geometry.intersect import any_hit_brute
        max_t = jnp.full(n, r * 0.5)
        os_ = traverse_sharded(sb, o, d, max_t, any_hit=True,
                               mesh=mesh).tri >= 0
        ob = any_hit_brute(sc_rep.triangles, o, d, max_t)
        np.testing.assert_array_equal(np.asarray(os_), np.asarray(ob))

    def test_empty_shards_never_hit(self):
        """n_shards > triangle count: empty shards get an explicit
        never-hit leaf (advisor r2: the native builder's n=0 behavior is
        undefined) and the merge still matches brute force."""
        from raytracingrenderer_tpu.core.vec import V3
        from raytracingrenderer_tpu.geometry.intersect import (
            BIG_T, closest_hit_brute)
        from raytracingrenderer_tpu.parallel.scene_shard import (
            build_sharded, traverse_sharded)
        from raytracingrenderer_tpu.scene.types import Triangles
        rng = np.random.default_rng(3)
        tp = rng.uniform(-1, 1, (3, 3, 3)).astype(np.float32)
        sb, order = build_sharded(tp, n_shards=8)
        assert (order < 0).sum() == 8 * sb.shard_size - 3
        mesh = make_mesh(8)
        n = 128
        o = V3.from_stacked(jnp.asarray(
            rng.uniform(-2, 2, (n, 3)).astype(np.float32)))
        d = V3.from_stacked(jnp.asarray(
            rng.standard_normal((n, 3)).astype(np.float32))).normalize()
        hs = traverse_sharded(sb, o, d, jnp.full(n, BIG_T), mesh=mesh)
        z = jnp.zeros(3)
        zv = V3(z, z, z)
        tris = Triangles(
            p0=V3.from_stacked(jnp.asarray(tp[:, 0])),
            e1=V3.from_stacked(jnp.asarray(tp[:, 1] - tp[:, 0])),
            e2=V3.from_stacked(jnp.asarray(tp[:, 2] - tp[:, 0])),
            gn=zv, n0=zv, n1=zv, n2=zv,
            uv0=jnp.zeros((3, 2)), uv1=jnp.zeros((3, 2)),
            uv2=jnp.zeros((3, 2)), area=z,
            mat_id=jnp.zeros(3, jnp.int32),
            light_id=jnp.full(3, -1, jnp.int32))
        hb = closest_hit_brute(tris, o, d)
        np.testing.assert_allclose(np.asarray(hs.t), np.asarray(hb.t),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.slow
    def test_sharded_render_matches_replicated_interior(self):
        """SURVEY §2.11 done-criterion: the interior renders with scene
        sharding on the 8-device mesh matching the replicated image."""
        from raytracingrenderer_tpu.parallel.scene_shard import (
            place_sharded)
        from raytracingrenderer_tpu.render import sample_image
        cfg = RenderConfig(max_depth=2, mis=True, jitter=True)

        def tiny(sc):
            c = sc.camera
            return sc._replace(camera=Camera(
                c.p, c.p_inv, c.cam_to_world, c.world_to_cam, 32, 32,
                c.origin, c.a_film))

        key = jax.random.PRNGKey(0)
        rep = tiny(load_scene(scene_path("interior")))
        img_rep = np.asarray(sample_image(rep, key, cfg))
        sh = tiny(load_scene(scene_path("interior"), scene_shards=8))
        sh = sh._replace(bvh=place_sharded(sh.bvh, make_mesh(8)))
        img_sh = np.asarray(sample_image(sh, key, cfg))
        np.testing.assert_allclose(img_rep, img_sh, rtol=1e-3, atol=1e-3)
