"""Device-mesh distribution of ray batches.

The reference's parallelism is a mutex-guarded 32x32 tile queue drained
by std::threads (RTBase/Renderer.h:795-853).  The
Equivalent here: the flat ray/pixel batch is sharded over a 1-D
`rays` mesh axis with jax.sharding.NamedSharding and the *same* jitted
render pass runs SPMD — XLA partitions every elementwise op and inserts
collectives only where needed (film assembly, adaptive-sampling stats,
gradient reductions).  Because randomness is drawn as one global array
keyed by (seed, spp), every device count traces the same paths — fixing
the reference's duplicated per-thread seed hazard (Renderer.h:55).  The
images are bit-identical on the CPU; on GPUs XLA compiles each device
count with other fusions, so last bits differ on some pixels and a few
paths in a million flip a roulette or lobe choice (PERF.md, PR 1).

Scale-out story (SURVEY.md §2.11): rays/pixels = data parallel; the scene
is replicated (every reference scene is <=40 MB SoA); primitive-sharding
is the model-parallel analogue for beyond-HBM scenes; multi-host runs use
the same code over a multi-host mesh via jax.distributed.initialize.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def make_mesh(n_devices: Optional[int] = None,
              devices=None) -> Mesh:
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (RAY_AXIS,))


def shard_rays(mesh: Mesh, tree):
    """Shard leading (ray/pixel) axis of every leaf across the mesh."""
    s = NamedSharding(mesh, P(RAY_AXIS))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), tree)


def shard_rows(mesh: Mesh, tree):
    """Shard (H, W, 3)-style image leaves by rows."""
    s = NamedSharding(mesh, P(RAY_AXIS, None, None))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), tree)


def replicate(mesh: Mesh, tree):
    s = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), tree)


_SHARDED_CACHE = {}


def render_sharded(scene, key, cfg, mesh: Mesh):
    """One SPMD sample pass over `mesh`: scene replicated, image rows
    sharded across the `rays` axis (jit-cached per mesh+cfg)."""
    from ..render import sample_image, specialize_config
    cfg = specialize_config(cfg, scene)
    ck = (tuple(d.id for d in mesh.devices.flat), cfg)
    fn = _SHARDED_CACHE.get(ck)
    if fn is None:
        fn = jax.jit(
            lambda sc, k: sample_image(sc, k, cfg),
            out_shardings=NamedSharding(mesh, P(RAY_AXIS, None, None)))
        _SHARDED_CACHE[ck] = fn
    return fn(replicate(mesh, scene), key)
