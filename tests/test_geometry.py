"""Geometry tests: BVH build/traversal vs brute-force oracle on real scenes."""
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import scene_path
from raytracingrenderer_tpu.core.vec import V3
from raytracingrenderer_tpu.geometry import intersect
from raytracingrenderer_tpu.geometry.bvh import build, validate
from raytracingrenderer_tpu.scene.loader import load_scene


def rays_toward(scene, n, seed):
    """Random rays from a shell around the scene, pointed inward-ish."""
    rng = np.random.default_rng(seed)
    c = np.array([float(scene.bounds.centre.x),
                  float(scene.bounds.centre.y),
                  float(scene.bounds.centre.z)])
    r = float(scene.bounds.radius)
    o = c + rng.standard_normal((n, 3)) * r
    target = c + rng.standard_normal((n, 3)) * (0.5 * r)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (V3.from_stacked(jnp.asarray(o.astype(np.float32))),
            V3.from_stacked(jnp.asarray(d.astype(np.float32))))


def _tris_of(tp):
    """Minimal Triangles SoA over a (T, 3, 3) vertex soup."""
    from raytracingrenderer_tpu.scene.types import Triangles
    t = len(tp)
    z = jnp.zeros(t)
    zv = V3(z, z, z)
    return Triangles(
        p0=V3.from_stacked(jnp.asarray(tp[:, 0])),
        e1=V3.from_stacked(jnp.asarray(tp[:, 1] - tp[:, 0])),
        e2=V3.from_stacked(jnp.asarray(tp[:, 2] - tp[:, 0])),
        gn=zv, n0=zv, n1=zv, n2=zv,
        uv0=jnp.zeros((t, 2)), uv1=jnp.zeros((t, 2)),
        uv2=jnp.zeros((t, 2)), area=z,
        mat_id=jnp.zeros(t, jnp.int32),
        light_id=jnp.full(t, -1, jnp.int32))


def _soup_rays(tp, n, seed):
    """Random rays aimed at the soup's bounding region."""
    rng = np.random.default_rng(seed)
    c = tp.reshape(-1, 3).mean(0)
    r = float(np.abs(tp.reshape(-1, 3) - c).max())
    o = c + rng.standard_normal((n, 3)) * r
    d = (c + rng.standard_normal((n, 3)) * 0.5 * r) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (V3.from_stacked(jnp.asarray(o.astype(np.float32))),
            V3.from_stacked(jnp.asarray(d.astype(np.float32))))


@pytest.fixture(scope="module")
def cornell():
    return load_scene(scene_path("cornell"))


@pytest.fixture(scope="module")
def interior():
    return load_scene(scene_path("interior"))


class TestBVH:
    def test_invariants_cornell(self, cornell):
        t = cornell.triangles
        tp = np.stack([np.asarray(t.p0.stacked()),
                       np.asarray((t.p0 + t.e1).stacked()),
                       np.asarray((t.p0 + t.e2).stacked())], axis=1)
        validate(cornell.bvh, tp)

    def test_traversal_matches_brute_cornell(self, cornell):
        o, d = rays_toward(cornell, 1500, 0)
        hb = intersect.closest_hit_brute(cornell.triangles, o, d)
        hv = intersect.closest_hit_bvh(cornell.bvh, cornell.triangles, o, d)
        # hit distance must agree everywhere; triangle ids may differ only
        # on coincident-surface ties (walls sharing edges, equal t)
        np.testing.assert_allclose(np.asarray(hb.t), np.asarray(hv.t),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(np.asarray(hb.valid),
                                      np.asarray(hv.valid))
        agree = (np.asarray(hb.tri) == np.asarray(hv.tri)).mean()
        assert agree > 0.99

    def test_traversal_matches_brute_interior(self, interior):
        sc = interior
        o, d = rays_toward(sc, 800, 1)
        hb = intersect.closest_hit_brute(sc.triangles, o, d)
        hv = intersect.closest_hit_bvh(sc.bvh, sc.triangles, o, d)
        # t must agree; tri ids may differ only on exactly-coincident hits
        np.testing.assert_allclose(np.asarray(hb.t), np.asarray(hv.t),
                                   rtol=1e-4, atol=1e-4)
        agree = (np.asarray(hb.tri) == np.asarray(hv.tri)).mean()
        assert agree > 0.999

    def test_any_hit_consistent(self, cornell):
        o, d = rays_toward(cornell, 1000, 2)
        hb = intersect.closest_hit_brute(cornell.triangles, o, d)
        max_t = jnp.where(hb.valid, hb.t + 0.01, 1e5)
        occ = intersect.any_hit_bvh(cornell.bvh, cornell.triangles, o, d,
                                    max_t)
        # every ray with a closest hit within max_t must be occluded
        np.testing.assert_array_equal(np.asarray(occ),
                                      np.asarray(hb.valid))
        # shrinking max_t below the hit must clear occlusion
        occ2 = intersect.any_hit_bvh(cornell.bvh, cornell.triangles, o, d,
                                     jnp.where(hb.valid, hb.t * 0.5, 1e-3))
        assert not np.asarray(occ2).any()

    def test_barycentrics_reconstruct_point(self, cornell):
        t = cornell.triangles
        o, d = rays_toward(cornell, 500, 3)
        h = intersect.closest_hit_bvh(cornell.bvh, t, o, d)
        m = np.asarray(h.valid)
        tri = np.asarray(h.tri)[m]
        u = np.asarray(h.u)[m]
        v = np.asarray(h.v)[m]
        p0 = np.asarray(t.p0.stacked())[tri]
        e1 = np.asarray(t.e1.stacked())[tri]
        e2 = np.asarray(t.e2.stacked())[tri]
        p_bary = p0 + e1 * u[:, None] + e2 * v[:, None]
        on = np.asarray(o.stacked())[m]
        dn = np.asarray(d.stacked())[m]
        p_ray = on + dn * np.asarray(h.t)[m][:, None]
        np.testing.assert_allclose(p_bary, p_ray, atol=2e-3)

    def test_empty_and_single(self):
        tp = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
        bvh, order = build(tp)
        validate(bvh, tp[order])
        assert np.asarray(bvh.count)[0] == 1


class TestNativeBuilder:
    def test_native_matches_contract(self):
        from raytracingrenderer_tpu.geometry import bvh_native
        if not bvh_native.available():
            pytest.skip("native builder not built")
        rng = np.random.default_rng(5)
        tp = rng.standard_normal((5000, 3, 3)).astype(np.float32)
        bvh, order = bvh_native.build(tp)
        from raytracingrenderer_tpu.geometry.bvh import validate
        validate(bvh, tp[order])

    def test_quality_build_contract_and_hits(self):
        """Round-5 all-axes/64-bin quality build (the load-path
        default): contract invariants hold, native == Python oracle on
        global SAH cost, and hit t's match the baseline tree exactly
        (same geometry, different topology)."""
        from raytracingrenderer_tpu.geometry import bvh_native
        from raytracingrenderer_tpu.geometry.bvh import (build, sah_cost,
                                                         validate)
        if not bvh_native.available():
            pytest.skip("native builder not built")
        rng = np.random.default_rng(11)
        tp = rng.standard_normal((4000, 3, 3)).astype(np.float32)
        tp[:4] *= 25.0  # a few huge triangles, bathroom-style
        nat, n_order = bvh_native.build(tp, max_leaf=14, bins=64,
                                        all_axes=True)
        validate(nat, tp[n_order])
        py, p_order = build(tp, max_leaf=14, bins=64, all_axes=True)
        validate(py, tp[p_order])
        assert abs(sah_cost(nat) - sah_cost(py)) < 0.05 * sah_cost(py)
        # (No "quality <= legacy cost" assert: greedy top-down SAH is
        # not monotone in local search quality on unstructured soups —
        # the 32% bathroom win is pinned in docs/BUILD_QUALITY_r5.md.)
        base, b_order = bvh_native.build(tp, max_leaf=14)
        tris_n = _tris_of(tp[n_order])
        tris_b = _tris_of(tp[b_order])
        o, d = _soup_rays(tp, 512, 3)
        hn = intersect.closest_hit_bvh(nat, tris_n, o, d)
        hb = intersect.closest_hit_bvh(base, tris_b, o, d)
        np.testing.assert_allclose(np.asarray(hn.t), np.asarray(hb.t),
                                   rtol=1e-5, atol=1e-5)

    def test_native_traversal_matches_brute(self):
        from raytracingrenderer_tpu.geometry import bvh_native
        from raytracingrenderer_tpu.scene.types import Triangles
        from raytracingrenderer_tpu.scene.loader import load_scene
        from conftest import scene_path
        if not bvh_native.available():
            pytest.skip("native builder not built")
        sc = load_scene(scene_path("cornell"))  # loader now uses native
        o, d = rays_toward(sc, 1000, 7)
        hb = intersect.closest_hit_brute(sc.triangles, o, d)
        hv = intersect.closest_hit_bvh(sc.bvh, sc.triangles, o, d)
        np.testing.assert_allclose(np.asarray(hb.t), np.asarray(hv.t),
                                   rtol=1e-4, atol=1e-4)
