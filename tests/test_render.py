"""End-to-end integrator tests on a tiny cornell render (CPU).

Cross-integrator consistency is the key check: the light tracer and VPL
render the same scene as the path tracer, so their images must agree in
overall brightness and structure (they share no estimator code paths).
"""
import jax
import numpy as np
import pytest

from conftest import scene_path
from raytracingrenderer_tpu.config import RenderConfig
from raytracingrenderer_tpu.imaging import film as film_mod
from raytracingrenderer_tpu.integrators.dispatch import render_with
from raytracingrenderer_tpu.render import render
from raytracingrenderer_tpu.scene.loader import load_scene
from raytracingrenderer_tpu.scene.types import Camera

RES = 32


@pytest.fixture(scope="module")
def scene():
    sc = load_scene(scene_path("cornell"))
    c = sc.camera
    return sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                     c.world_to_cam, RES, RES, c.origin,
                                     c.a_film))


@pytest.fixture(scope="module")
def path_img(scene):
    cfg = RenderConfig(mis=True, jitter=True, max_depth=3)
    f = render(scene, cfg, spp=32)
    return np.asarray(film_mod.to_hdr(f))


class TestIntegrators:
    def test_path_nonzero(self, path_img):
        assert path_img.mean() > 0.01
        assert np.isfinite(path_img).all()

    def test_direct_below_path(self, scene, path_img):
        cfg = RenderConfig(integrator="direct", jitter=True, mis=False)
        f = render_with(scene, cfg, spp=16)
        img = np.asarray(film_mod.to_hdr(f))
        assert 0 < img.mean() < path_img.mean() * 1.05

    def test_albedo_and_normals(self, scene):
        for which, lo, hi in (("albedo", 0.05, 1.0), ("normals", 0.1, 1.0)):
            cfg = RenderConfig(integrator=which, jitter=False)
            f = render_with(scene, cfg, spp=1)
            img = np.asarray(film_mod.to_hdr(f))
            assert lo < img.mean() < hi, (which, img.mean())
            assert np.isfinite(img).all()

    @pytest.mark.slow
    def test_lighttracer_agrees_with_path(self, scene, path_img):
        cfg = RenderConfig(integrator="lighttrace", max_depth=3)
        f = render_with(scene, cfg, spp=48)
        img = np.asarray(film_mod.to_hdr(f))
        assert np.isfinite(img).all()
        # exclude the emitter area (path tracer sees it directly, the
        # light tracer doesn't splat the camera-visible emitter)
        mask = path_img.mean(-1) < 1.0
        ratio = img.mean(-1)[mask].mean() / path_img.mean(-1)[mask].mean()
        assert 0.7 < ratio < 1.4, ratio
        corr = np.corrcoef(img.mean(-1)[mask], path_img.mean(-1)[mask])[0, 1]
        assert corr > 0.7, corr

    def test_vpl_runs_and_correlates(self, scene, path_img):
        cfg = RenderConfig(integrator="vpl", max_depth=3)
        f = render_with(scene, cfg, spp=8)
        img = np.asarray(film_mod.to_hdr(f))
        assert np.isfinite(img).all()
        assert img.mean() > 0.01
        mask = path_img.mean(-1) < 1.0
        corr = np.corrcoef(img.mean(-1)[mask], path_img.mean(-1)[mask])[0, 1]
        assert corr > 0.6, corr

    def test_adaptive_matches_uniform(self, scene, path_img):
        cfg = RenderConfig(integrator="adaptive", jitter=True, max_depth=3)
        f = render_with(scene, cfg, spp=8)
        img = np.asarray(film_mod.to_hdr(f))
        assert np.isfinite(img).all()
        mask = path_img.mean(-1) < 1.0
        ratio = img.mean(-1)[mask].mean() / path_img.mean(-1)[mask].mean()
        assert 0.8 < ratio < 1.2, ratio

    def test_checkpoint_resume_continues(self, scene, tmp_path):
        from raytracingrenderer_tpu.utils.checkpoint import (load_film,
                                                             save_film)
        cfg = RenderConfig(mis=True, jitter=True, max_depth=2)
        f1 = render(scene, cfg, spp=4)
        p = str(tmp_path / "ckpt.npz")
        save_film(p, f1)
        f2 = render(scene, cfg, spp=4, film=load_film(p))
        assert float(f2.spp) == 8.0
        # resumed result identical to uninterrupted 8spp (same keys)
        f_full = render(scene, cfg, spp=8)
        np.testing.assert_allclose(np.asarray(f2.buffer),
                                   np.asarray(f_full.buffer), rtol=1e-5,
                                   atol=1e-6)

    def test_wavefront_matches_scan(self, scene):
        """The compacting wavefront integrator must be estimator-
        identical to the in-device scan: every random decision is keyed
        by pixel id (rng.uniform_ids), so compaction only moves lanes."""
        from raytracingrenderer_tpu.integrators.wavefront import (
            sample_image_wavefront)
        from raytracingrenderer_tpu.render import sample_image
        cfg = RenderConfig(mis=True, jitter=True, max_depth=3)
        key = jax.random.PRNGKey(5)
        a = np.asarray(sample_image(scene, key, cfg))
        b = np.asarray(sample_image_wavefront(scene, key, cfg))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    def test_wavefront_backward_matches_scan(self, scene):
        """Host-chained wavefront backward (wavefront_diff.py): loss
        and parameter gradients must equal scan-mode jax.grad — the
        taped forward is the same estimator, and the backward replays
        saved traversal results through the same shading math."""
        import jax.numpy as jnp
        from raytracingrenderer_tpu.diff import (_diff_cfg, _split_scene,
                                                 render_loss)
        from raytracingrenderer_tpu.integrators import wavefront_diff
        cfg = RenderConfig(mis=True, jitter=True, max_depth=3)
        key = jax.random.PRNGKey(9)
        target = jnp.zeros((RES, RES, 3), jnp.float32)
        loss_wf, g_wf = wavefront_diff.loss_and_grads(scene, target, key,
                                                      cfg)
        dcfg = _diff_cfg(cfg, scene)
        params, _ = _split_scene(scene)
        loss_sc, g_sc = jax.value_and_grad(render_loss)(
            params, scene, target, key, dcfg)
        assert float(loss_wf) == pytest.approx(float(loss_sc), rel=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(g_wf),
                        jax.tree_util.tree_leaves(g_sc)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-3, atol=1e-6)

    def test_wavefront_train_step_descends(self, scene):
        import jax.numpy as jnp
        from raytracingrenderer_tpu.integrators import wavefront_diff
        cfg = RenderConfig(mis=True, jitter=True, max_depth=2)
        key = jax.random.PRNGKey(10)
        target = jnp.zeros((RES, RES, 3), jnp.float32)
        sc, l0 = wavefront_diff.train_step(scene, target, key, cfg,
                                           lr=0.5)
        sc, l1 = wavefront_diff.train_step(sc, target, key, cfg, lr=0.5)
        assert float(l1) < float(l0)

    def test_train_step_autodispatch_matches(self, scene):
        """diff.train_step routes BVH-scale scenes to the wavefront
        backward (r4 weak #5: the benchmark path and the user API must
        be the same code); forced via cfg.wavefront here, the two
        routes must produce the same step."""
        import jax.numpy as jnp
        from raytracingrenderer_tpu.diff import train_step
        from raytracingrenderer_tpu.integrators import wavefront_diff
        from raytracingrenderer_tpu.render import _use_wavefront
        key = jax.random.PRNGKey(11)
        target = jnp.zeros((RES, RES, 3), jnp.float32)
        cfg_wf = RenderConfig(mis=True, jitter=True, max_depth=2,
                              wavefront=True)
        assert _use_wavefront(scene, cfg_wf)
        sc_a, l_a = train_step(scene, target, key, cfg_wf, lr=0.5)
        sc_b, l_b = wavefront_diff.train_step(scene, target, key, cfg_wf,
                                              lr=0.5)
        assert float(l_a) == pytest.approx(float(l_b), rel=1e-6)
        np.testing.assert_allclose(
            np.asarray(sc_a.materials.albedo.x),
            np.asarray(sc_b.materials.albedo.x), rtol=1e-6)
        # scan route (wavefront=False) agrees to float tolerance
        cfg_sc = RenderConfig(mis=True, jitter=True, max_depth=2,
                              wavefront=False)
        sc_c, l_c = train_step(scene, target, key, cfg_sc, lr=0.5)
        assert float(l_a) == pytest.approx(float(l_c), rel=1e-5)
        np.testing.assert_allclose(
            np.asarray(sc_a.materials.albedo.x),
            np.asarray(sc_c.materials.albedo.x), rtol=1e-3, atol=1e-6)

    def test_wavefront_render_path(self, scene, path_img):
        cfg = RenderConfig(mis=True, jitter=True, max_depth=3,
                           wavefront=True)
        f = render(scene, cfg, spp=16)
        img = np.asarray(film_mod.to_hdr(f))
        assert np.isfinite(img).all()
        mask = path_img.mean(-1) < 1.0
        ratio = img.mean(-1)[mask].mean() / path_img.mean(-1)[mask].mean()
        assert 0.9 < ratio < 1.1, ratio

    def test_layered_coat_renders(self, scene, path_img):
        """End-to-end layered coating: coat cornell's diffuse walls with
        an absorbing layer -> image stays finite, differs from the
        uncoated render, and the absorbing coat darkens it (r4 weak #7:
        the reference only stores these params)."""
        import jax.numpy as jnp
        m = scene.materials
        em = np.asarray(m.is_emissive)
        thick = jnp.asarray(np.where(em, 0.0, 0.6).astype(np.float32))
        sc = scene._replace(materials=m._replace(
            coat_thickness=thick,
            coat_sigma_a=type(m.coat_sigma_a)(
                jnp.full_like(thick, 0.5), jnp.full_like(thick, 0.5),
                jnp.full_like(thick, 0.5))))
        cfg = RenderConfig(mis=True, jitter=True, max_depth=3)
        from raytracingrenderer_tpu.render import specialize_config
        from raytracingrenderer_tpu.materials.bsdf import COAT
        scfg = specialize_config(cfg, sc)
        assert COAT in scfg.mat_types  # sentinel gates the coat lobe
        img = np.asarray(film_mod.to_hdr(render(sc, cfg, spp=16)))
        assert np.isfinite(img).all()
        mask = path_img.mean(-1) < 1.0
        ratio = img.mean(-1)[mask].mean() / path_img.mean(-1)[mask].mean()
        assert 0.05 < ratio < 0.9, ratio  # absorbing coat darkens

    def test_denoise_reduces_noise(self, scene):
        from raytracingrenderer_tpu.imaging.denoise import denoise
        from raytracingrenderer_tpu.integrators import aov
        cfg = RenderConfig(mis=True, jitter=True, max_depth=3)
        noisy = np.asarray(film_mod.to_hdr(render(scene, cfg, spp=2)))
        clean = np.asarray(film_mod.to_hdr(render(
            scene, RenderConfig(mis=True, jitter=True, max_depth=3,
                                seed=7), spp=48)))
        aov_cfg = RenderConfig(jitter=False)
        alb = aov.albedo_image(scene, jax.random.PRNGKey(0), aov_cfg)
        nrm = aov.normals_image(scene, jax.random.PRNGKey(0), aov_cfg)
        dn = np.asarray(denoise(noisy, albedo=alb, normal=nrm,
                                sigma_col=0.2))
        mask = clean.mean(-1) < 1.0
        err_before = np.abs(noisy - clean).mean(-1)[mask].mean()
        err_after = np.abs(dn - clean).mean(-1)[mask].mean()
        assert err_after < err_before


@pytest.mark.slow
class TestEnvmapSceneConsistency:
    """Sky-lit cornell: NEE-only and MIS estimators must agree —
    exercises env CDF importance sampling + MIS weights end-to-end."""

    def test_nee_vs_mis_mean(self):
        sc = load_scene(scene_path("cornell-env"))
        c = sc.camera
        sc = sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                       c.world_to_cam, 48, 27, c.origin,
                                       c.a_film))
        means = {}
        for tag, mis in (("nee", False), ("mis", True)):
            cfg = RenderConfig(mis=mis, jitter=True, max_depth=3, seed=1)
            f = render(sc, cfg, spp=24)
            means[tag] = float(np.asarray(film_mod.to_hdr(f)).mean())
        assert means["mis"] == pytest.approx(means["nee"], rel=0.08), means


class TestAdaptiveContract:
    """Film/resume/on_sample semantics + the cross-shard round
    (SURVEY §2.11 load-balancing row, Renderer.h:583-749)."""

    def test_sharded_adaptive_matches_uniform(self, scene, path_img):
        from raytracingrenderer_tpu.integrators.adaptive import (
            adaptive_render)
        from raytracingrenderer_tpu.parallel.mesh import make_mesh
        cfg = RenderConfig(integrator="adaptive", jitter=True, max_depth=3)
        f = adaptive_render(scene, cfg, total_spp=8, mesh=make_mesh(8))
        img = np.asarray(film_mod.to_hdr(f))
        assert np.isfinite(img).all()
        mask = path_img.mean(-1) < 1.0
        ratio = img.mean(-1)[mask].mean() / path_img.mean(-1)[mask].mean()
        assert 0.8 < ratio < 1.2, ratio

    def test_adaptive_resume_and_on_sample(self, scene):
        from raytracingrenderer_tpu.integrators.adaptive import (
            adaptive_render)
        cfg = RenderConfig(integrator="adaptive", jitter=True, max_depth=2)
        seen = []
        f1 = render(scene, RenderConfig(jitter=True, max_depth=2), spp=2)
        f2 = adaptive_render(scene, cfg, total_spp=4, film=f1,
                             on_sample=lambda s, f: seen.append(s))
        assert float(f2.spp) > float(f1.spp)  # prior counts + new work
        assert len(seen) >= 2  # init passes and rounds both reported
        img = np.asarray(film_mod.to_hdr(f2))
        assert np.isfinite(img).all() and img.mean() > 0.01
