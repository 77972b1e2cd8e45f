"""Test config: run everything on a virtual 8-device CPU mesh, on scenes
generated from a seed (raytracingrenderer_tpu/scene/synth.py).

Multi-device code paths (shard_map over a Mesh) are exercised without
several accelerators via --xla_force_host_platform_device_count,
mirroring the multi-host test strategy SURVEY.md §4 calls for.  Tests of
the CUDA traversal kernel carry the `gpu` marker and skip here; run them
on a machine with an NVIDIA card with `pytest -m gpu tests/`.
"""
import atexit
import functools
import json
import os
import shutil
import tempfile

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from raytracingrenderer_tpu.utils import compile_cache  # noqa: E402


def pytest_configure(config):
    if config.getoption("markexpr", "") == "gpu":
        return  # the card's own run: keep JAX's default platform
    os.environ["JAX_PLATFORMS"] = "cpu"
    # backends initialize lazily, so the config knob still forces CPU as
    # long as no computation ran yet
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", (
        "tests must run on the virtual CPU mesh, got "
        + jax.default_backend())
    assert len(jax.devices()) >= 8, \
        "xla_force_host_platform_device_count lost"


jax.config.update("jax_enable_x64", False)
compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# the small interior: same generator as the chip's 330k-triangle scene
INTERIOR_TRIANGLES = 3000

_SCENES = tempfile.mkdtemp(prefix="rt_scenes_")
atexit.register(shutil.rmtree, _SCENES, True)


@functools.lru_cache(maxsize=None)
def _generate(name: str) -> str:
    from raytracingrenderer_tpu.io.hdr import write_hdr
    from raytracingrenderer_tpu.scene import synth
    out = os.path.join(_SCENES, name)
    if name == "cornell":
        return synth.cornell(out)
    if name == "interior":
        return synth.interior(out, triangles=INTERIOR_TRIANGLES, seed=0)
    if name == "cornell-env":
        # the cornell box opened to a sky: front wall absent, back wall
        # removed, glossy boxes (plastic GGX and a rough conductor)
        shutil.copytree(_generate("cornell"), out)
        with open(os.path.join(out, "scene.json")) as f:
            desc = json.load(f)
        inst = desc["instances"]
        del inst[2]                                   # back wall
        inst[4].update(bsdf="plastic", intIOR=1.5, roughness=0.3)
        inst[5].update(bsdf="conductor", eta="0.2 0.92 1.1",
                       k="3.9 2.45 2.14", roughness=0.2)
        desc["envmap"] = "sky.hdr"
        with open(os.path.join(out, "scene.json"), "w") as f:
            json.dump(desc, f)
        write_hdr(os.path.join(out, "sky.hdr"), sky_image(64, 128))
        return out
    raise KeyError(name)


def scene_path(name: str, *parts: str) -> str:
    """Path of a generated scene directory ("cornell", "interior",
    "cornell-env"), or of a file inside it."""
    return os.path.join(_generate(name), *parts)


def sky_image(h: int, w: int) -> np.ndarray:
    """Lat-long sky radiance: a blue gradient and one small bright sun,
    so importance sampling has something to concentrate on."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    vv, uu = np.meshgrid(v, u, indexing="ij")
    img = np.stack([0.3 + 0.4 * (1 - vv), 0.45 + 0.4 * (1 - vv),
                    0.9 + 0.3 * (1 - vv)], -1)
    sun = np.exp(-(((uu - 0.3) / 0.02) ** 2 + ((vv - 0.3) / 0.03) ** 2))
    img += 60.0 * sun[..., None] * np.array([1.0, 0.9, 0.7])
    return img.astype(np.float32)


@pytest.fixture
def cuda():
    """Skips a `gpu`-marked test unless JAX has a CUDA device."""
    try:
        jax.devices("gpu")
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run pytest -m gpu on the card)")
