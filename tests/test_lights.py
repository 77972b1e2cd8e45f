"""Light tests: env-map CDF importance sampling correctness."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import sky_image
from raytracingrenderer_tpu.core.vec import V3
from raytracingrenderer_tpu.lights import envmap as em

N = 100_000


@pytest.fixture(scope="module")
def env():
    return em.build_envmap(sky_image(128, 128))


def uv(seed, n=N):
    k = jax.random.PRNGKey(seed)
    u = jax.random.uniform(k, (2, n))
    return u[0], u[1]


class TestEnvmap:
    def test_uv_dir_roundtrip(self):
        r1, r2 = uv(0, 1000)
        d = em.uv_to_dir(r1, r2)
        np.testing.assert_allclose(np.asarray(d.length()), 1.0, atol=1e-5)
        u, v = em.dir_to_uv(d)
        np.testing.assert_allclose(np.asarray(u), np.asarray(r1), atol=1e-3)
        np.testing.assert_allclose(np.asarray(v), np.asarray(r2), atol=1e-3)

    def test_sample_pdf_consistency(self, env):
        """1/pdf under importance sampling integrates to 4pi."""
        r1, r2 = uv(1)
        wi, pdf = em.sample(env, r1, r2)
        est = float(jnp.mean(1.0 / jnp.maximum(pdf, 1e-12)))
        assert est == pytest.approx(4 * np.pi, rel=0.03)

    def test_sample_matches_pdf_fn(self, env):
        """pdf() evaluated at sampled directions equals the sampling pdf."""
        r1, r2 = uv(2)
        wi, pdf_s = em.sample(env, r1, r2)
        pdf_q = em.pdf(env, wi)
        ratio = np.asarray(pdf_q / jnp.maximum(pdf_s, 1e-12))
        assert np.median(np.abs(ratio - 1.0)) < 0.02

    def test_importance_estimates_power(self, env):
        """E[L/pdf] under importance sampling == the analytic texel-sum
        integral of the map's luminance."""
        img = np.asarray(env.data)
        h, w = img.shape[:2]
        lum = (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
               + 0.0722 * img[..., 2])
        st = np.sin((np.arange(h) + 0.5) / h * np.pi)
        analytic = 2 * np.pi ** 2 / (w * h) * (lum * st[:, None]).sum()
        r1, r2 = uv(3)
        wi, pdf = em.sample(env, r1, r2)
        li = em.evaluate(env, wi).lum()
        est_imp = float(jnp.mean(li / jnp.maximum(pdf, 1e-12)))
        assert est_imp == pytest.approx(float(analytic), rel=0.03)

    def test_variance_reduction(self, env):
        """The importance estimator's dispersion must be far below the
        worst-case: its 99th percentile stays within a few x of its mean
        (pdf tracks the bilinear signal; point-pdf would spike 100x)."""
        r1, r2 = uv(4)
        wi, pdf = em.sample(env, r1, r2)
        x = np.asarray(em.evaluate(env, wi).lum()
                       / jnp.maximum(pdf, 1e-12))
        assert np.percentile(x, 99) < 5.0 * x.mean()

    def test_evaluate_matches_reference_mapping(self, env):
        """+y maps to v=0 (zenith row), per Lights.h:150-157."""
        up = V3.of(jnp.asarray([0.0]), jnp.asarray([1.0]),
                   jnp.asarray([0.0]))
        u, v = em.dir_to_uv(V3(jnp.zeros(1), jnp.ones(1), jnp.zeros(1)))
        assert float(v[0]) == pytest.approx(0.0, abs=1e-5)
        u, v = em.dir_to_uv(V3(jnp.zeros(1), -jnp.ones(1), jnp.zeros(1)))
        assert float(v[0]) == pytest.approx(1.0, abs=1e-5)


class TestPowerWeightedSelection:
    """cfg.power_lights: NEE light selection proportional to the
    reference's totalIntegratedPower (SURVEY §2.6 'uniform or
    power-weighted'): unbiased, and a variance win when emitters are
    asymmetric — the upgrade the reference's uniform pmf leaves on the
    table (its power methods are computed but never drive selection)."""

    @pytest.fixture(scope="class")
    def two_light_scene(self, tmp_path_factory):
        import json
        import shutil

        from conftest import scene_path
        from raytracingrenderer_tpu.scene.loader import load_scene
        dst = tmp_path_factory.mktemp("cb") / "cornell2"
        shutil.copytree(scene_path("cornell"), dst)
        with open(dst / "scene.json") as f:
            desc = json.load(f)
        cubes = [i for i, inst in enumerate(desc["instances"])
                 if inst["filename"] == "Cube.gem"]
        # the short box becomes a very dim second emitter (12 tris)
        desc["instances"][cubes[0]]["emission"] = "0.05 0.05 0.05"
        with open(dst / "scene.json", "w") as f:
            json.dump(desc, f)
        sc = load_scene(str(dst))
        assert sc.num_lights == 14  # 2 light-rect tris + 12 box tris
        return sc

    def test_pmf_concentrates_on_bright_light(self, two_light_scene):
        from raytracingrenderer_tpu.lights.lights import selection_pmf
        pmf, pmf_bg = selection_pmf(two_light_scene, True)
        p = np.asarray(pmf)
        assert p.sum() == pytest.approx(1.0, abs=1e-5)
        le = np.asarray(two_light_scene.lights.le.lum())
        bright = le > 1.0
        assert p[bright].sum() > 0.95  # the rect light dominates
        pmf_u, _ = selection_pmf(two_light_scene, False)
        assert float(pmf_u[0]) == pytest.approx(1.0 / 14)

    def test_unbiased_and_lower_variance(self, two_light_scene):
        import dataclasses

        from raytracingrenderer_tpu.config import RenderConfig
        from raytracingrenderer_tpu.render import sample_image
        from raytracingrenderer_tpu.scene.types import Camera
        sc = two_light_scene
        c = sc.camera
        sc = sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                       c.world_to_cam, 24, 24, c.origin,
                                       c.a_film))
        # jitter off: both modes share the same per-seed jitter (same
        # key), whose pixel-edge variance would swamp the comparison
        base = RenderConfig(max_depth=2, mis=True, jitter=False)
        imgs = {}
        for power in (False, True):
            cfg = dataclasses.replace(base, power_lights=power)
            f = jax.jit(lambda k, cfg=cfg: sample_image(sc, k, cfg))
            imgs[power] = np.stack([
                np.asarray(f(jax.random.PRNGKey(s))) for s in range(24)])
        mean_u = imgs[False].mean()
        mean_p = imgs[True].mean()
        # both estimate the same integral
        assert mean_p == pytest.approx(mean_u, rel=0.05)
        # per-pixel variance across seeds: power-weighted lower on
        # average (uniform wastes half the NEE draws on the dim box)
        var_u = imgs[False].var(axis=0).mean()
        var_p = imgs[True].var(axis=0).mean()
        # measured ~10x on this scene (ratio ~0.1); assert a safe 2x
        assert var_p < 0.5 * var_u, (var_p, var_u)
