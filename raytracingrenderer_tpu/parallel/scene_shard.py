"""Primitive-sharded intersection: the model-parallel axis.

Ray data-parallelism (parallel/mesh.py) replicates the scene; for scenes
exceeding a chip's HBM the *traversal working set* — triangle geometry
plus a per-shard BVH — shards across the mesh instead (SURVEY.md §2.11
"scene-sharding by primitive").  Each device traverses the full ray
batch against its local sub-BVH, then the per-shard closest hits merge
with an argmin over t (any-hit: an OR) — one small collective of
(rays, 4) floats per traversal instead of any triangle movement.

Shards are CONTIGUOUS ranges of the globally SAH-ordered triangle array,
so each sub-BVH covers a spatially coherent chunk and prunes well.
Triangle ids stay global (shard i's local id j maps to i*shard+j).
Attribute tables shard too (attach_attrs/gather_attrs_sharded: a
gather-by-owner + psum after the hit merge), reducing the replicated
triangle SoA to a 1-row stub.

COST MODEL (read before reaching for this mode): every device traverses
the FULL ray batch against its sub-BVH, so closest-hit work is paid
n_shards times (each shard prunes most rays at its root, but the
traversal dispatch itself is full-width), and per-bounce wavefront
compaction is disabled on this path (render._use_wavefront) — sharded
renders run the scan integrator at full batch width.  This is an
escape hatch for scenes that exceed a chip's HBM, not a speedup for
scenes that fit; for those, replicate the scene and shard rays.

Reachable as a first-class path: `load_scene(..., scene_shards=N)` (or
CLI `-sceneShards N`) builds the sharded form, and geometry.intersect
dispatches on it transparently.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.vec import V3
from ..geometry.intersect import BIG_T, Hit, closest_hit_brute
from ..scene.types import Triangles
from .mesh import RAY_AXIS, make_mesh


@jax.tree_util.register_pytree_node_class
class ShardedBVH:
    """Per-shard flat BVHs + triangle geometry, leading axis = shard.

    Every array's axis 0 has length n_shards and is placed sharded over
    the mesh's `rays` axis; node arrays are padded to the max node count
    across shards so the SPMD program is shape-uniform.
    """

    def __init__(self, lo, hi, right, start, count,
                 p0: V3, e1: V3, e2: V3,
                 leaf_max: int, n_shards: int, shard_size: int,
                 attrs=None, depth: int = 0):
        self.lo = lo          # (D, B, 3)
        self.hi = hi          # (D, B, 3)
        self.right = right    # (D, B)
        self.start = start    # (D, B)
        self.count = count    # (D, B)
        self.p0 = p0          # V3 of (D, S)
        self.e1 = e1
        self.e2 = e2
        # (D, S, 44) packed shading-attribute rows
        # (integrators.common.pack_attrs layout), sharded with the
        # geometry so the full-scene attribute table never lives on one
        # device either — with this, NO per-triangle array is replicated
        # in scene-sharded mode (the Scene carries a 1-row stub SoA).
        self.attrs = attrs
        self.leaf_max = int(leaf_max)
        self.n_shards = int(n_shards)
        self.shard_size = int(shard_size)
        self.depth = int(depth)      # deepest shard tree (root = 1)

    def tree_flatten(self):
        return ((self.lo, self.hi, self.right, self.start, self.count,
                 self.p0, self.e1, self.e2, self.attrs),
                (self.leaf_max, self.n_shards, self.shard_size, self.depth))

    @classmethod
    def tree_unflatten(cls, aux, children):
        *rest, attrs = children
        return cls(*rest, leaf_max=aux[0], n_shards=aux[1],
                   shard_size=aux[2], attrs=attrs, depth=aux[3])


def build_sharded(tp: np.ndarray, n_shards: int, max_leaf: int = None
                  ) -> Tuple[ShardedBVH, np.ndarray]:
    """(T, 3, 3) vertex positions -> (ShardedBVH, global order).

    A global binned-SAH build supplies the spatial ordering; contiguous
    chunks of that order become the shards, each with its own sub-BVH.
    The returned order has the padded length n_shards*shard_size with -1
    marking padding slots (callers pad their triangle SoA to match).
    """
    from ..geometry import bvh_native
    from ..geometry.bvh import MAX_LEAF

    max_leaf = max_leaf or MAX_LEAF
    t = len(tp)
    _, order = bvh_native.build(tp, max_leaf=max_leaf, bins=64,
                                all_axes=True)
    shard = -(-t // n_shards)
    padded = np.full(n_shards * shard, -1, np.int64)
    padded[:t] = order

    los, his, rights, starts, counts = [], [], [], [], []
    p0 = np.zeros((n_shards, shard, 3), np.float32)
    e1 = np.zeros((n_shards, shard, 3), np.float32)
    e2 = np.zeros((n_shards, shard, 3), np.float32)
    leaf_max = depth = 1
    for i in range(n_shards):
        ids = padded[i * shard:(i + 1) * shard]
        ids = ids[ids >= 0]
        if len(ids):
            sub, sub_order = bvh_native.build(tp[ids], max_leaf=max_leaf,
                                              bins=64, all_axes=True)
            # reorder the chunk by the sub-build's own order
            ids = ids[sub_order]
            padded[i * shard:i * shard + len(ids)] = ids
        else:
            # empty shard (n_shards > triangle count): one explicit
            # never-hit leaf instead of trusting the native builder's
            # undefined n=0 behavior (advisor r2 finding)
            from ..scene.types import BVH
            sub = BVH(lo=jnp.full((1, 3), np.inf),
                      hi=jnp.full((1, 3), -np.inf),
                      right=jnp.full(1, -1, jnp.int32),
                      start=jnp.zeros(1, jnp.int32),
                      count=jnp.zeros(1, jnp.int32),
                      leaf_max=1, depth=1)
        v = tp[ids] if len(ids) else np.zeros((0, 3, 3), np.float32)
        p0[i, :len(ids)] = v[:, 0]
        e1[i, :len(ids)] = v[:, 1] - v[:, 0]
        e2[i, :len(ids)] = v[:, 2] - v[:, 0]
        los.append(np.asarray(sub.lo))
        his.append(np.asarray(sub.hi))
        rights.append(np.asarray(sub.right))
        starts.append(np.asarray(sub.start))
        counts.append(np.asarray(sub.count))
        leaf_max = max(leaf_max, sub.leaf_max)
        depth = max(depth, sub.depth)

    b_max = max(len(r) for r in rights)

    def padn(a, fill, width=None):
        out = []
        for x in a:
            x = np.asarray(x)
            pad = [(0, b_max - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
            out.append(np.pad(x, pad, constant_values=fill))
        return jnp.asarray(np.stack(out))

    def v3s(a):
        return V3(jnp.asarray(a[..., 0]), jnp.asarray(a[..., 1]),
                  jnp.asarray(a[..., 2]))

    # pad nodes with never-hit leaves (empty boxes, right=-1, count=0)
    sb = ShardedBVH(
        lo=padn(los, np.inf), hi=padn(his, -np.inf),
        right=padn(rights, -1), start=padn(starts, 0),
        count=padn(counts, 0),
        p0=v3s(p0), e1=v3s(e1), e2=v3s(e2),
        leaf_max=leaf_max, n_shards=n_shards, shard_size=shard,
        depth=depth)
    return sb, padded


def place_sharded(sb: ShardedBVH, mesh: Mesh) -> ShardedBVH:
    """Shard every leading axis over the mesh (the HBM win)."""
    s = NamedSharding(mesh, P(RAY_AXIS))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), sb)


def attach_attrs(sb: ShardedBVH, tris, materials) -> ShardedBVH:
    """Pack + shard the shading-attribute table (load time).

    `tris` is the PADDED, globally-ordered triangle SoA (the same order
    traverse_sharded's global ids index)."""
    from ..integrators.common import pack_attrs
    attrs = pack_attrs(tris, materials)          # (D*S, 44)
    attrs = attrs.reshape(sb.n_shards, sb.shard_size, attrs.shape[-1])
    return ShardedBVH(sb.lo, sb.hi, sb.right, sb.start, sb.count,
                      sb.p0, sb.e1, sb.e2,
                      leaf_max=sb.leaf_max, n_shards=sb.n_shards,
                      shard_size=sb.shard_size, attrs=attrs,
                      depth=sb.depth)


def stub_triangles(tris) -> "Triangles":
    """1-row stand-in for the replicated triangle SoA: in scene-sharded
    mode every per-triangle consumer reads either the sharded traversal
    geometry (ShardedBVH), the sharded attribute rows (attrs), or the
    light table's own emitter geometry — so the full SoA (~29 floats x T)
    need not exist on any device.  Keeping one row preserves shapes for
    code that merely inspects dtypes/structure."""
    return jax.tree_util.tree_map(lambda a: a[:1], tris)


def gather_attrs_sharded(sb: ShardedBVH, tri, mesh: Mesh = None):
    """(N,) global triangle ids -> (N, 44) attribute rows via
    gather-by-owner: each shard serves the rows it owns and a psum
    merges them (SURVEY §2.11 scene-sharding; the collective replaces a
    replicated-table gather at n_shards x less HBM per device)."""
    mesh = mesh or make_mesh(sb.n_shards)
    shard = sb.shard_size

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(RAY_AXIS), P()), out_specs=P(), check_vma=False)
    def run(attrs_local, tri):
        idx = jax.lax.axis_index(RAY_AXIS)
        owner = tri // shard
        local = jnp.clip(tri - idx * shard, 0, shard - 1)
        rows = attrs_local[0][local]             # (N, 44)
        rows = jnp.where((owner == idx)[:, None], rows, 0.0)
        return jax.lax.psum(rows, RAY_AXIS)

    return run(sb.attrs, tri)


def _local_tris(sb: ShardedBVH) -> Triangles:
    """Squeeze the (1, S) shard-local geometry into a minimal Triangles
    carrier for the traversal core (attribute fields unused there)."""
    sq = lambda v: V3(v.x[0], v.y[0], v.z[0])
    s = sb.shard_size
    z = jnp.zeros(s)
    zv = V3(z, z, z)
    return Triangles(p0=sq(sb.p0), e1=sq(sb.e1), e2=sq(sb.e2),
                     gn=zv, n0=zv, n1=zv, n2=zv,
                     uv0=jnp.zeros((s, 2)), uv1=jnp.zeros((s, 2)),
                     uv2=jnp.zeros((s, 2)), area=z,
                     mat_id=jnp.zeros(s, jnp.int32),
                     light_id=jnp.full(s, -1, jnp.int32))


def traverse_sharded(sb: ShardedBVH, o: V3, d: V3, t_init,
                     any_hit: bool = False,
                     mesh: Mesh = None) -> Hit:
    """Full ray batch vs the sharded scene: per-shard sub-BVH traversal
    (the same dispatch as a replicated scene: the CUDA kernel on GPUs)
    under shard_map, then a min-t (closest) / OR (any-hit) merge."""
    from ..geometry.intersect import _bvh_hit
    from ..scene.types import BVH

    mesh = mesh or make_mesh(sb.n_shards)
    n_dev = sb.n_shards
    shard = sb.shard_size

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(RAY_AXIS), P(), P(), P()),
        out_specs=P(RAY_AXIS))
    def run(sb_local: ShardedBVH, o: V3, d: V3, t0) -> Hit:
        idx = jax.lax.axis_index(RAY_AXIS)
        o, d, t0 = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, (RAY_AXIS,), to="varying"),
            (o, d, t0))
        bvh = BVH(lo=sb_local.lo[0], hi=sb_local.hi[0],
                  right=sb_local.right[0], start=sb_local.start[0],
                  count=sb_local.count[0],
                  leaf_max=sb_local.leaf_max, depth=sb_local.depth)
        local = _bvh_hit(bvh, _local_tris(sb_local), o, d, t0, any_hit)
        tri_g = jnp.where(local.tri >= 0, local.tri + idx * shard, -1)
        return Hit(local.t, tri_g, local.u, local.v)

    n = o.x.shape[0]
    t0 = jnp.broadcast_to(t_init, (n,)).astype(jnp.float32)
    h = run(sb, o, d, t0)
    t = h.t.reshape(n_dev, n)
    tri = h.tri.reshape(n_dev, n)
    if any_hit:
        hit_any = (tri >= 0).any(axis=0)
        first = jnp.argmax(tri >= 0, axis=0)
        lane = jnp.arange(n)
        return Hit(jnp.where(hit_any, t[first, lane], t0),
                   jnp.where(hit_any, tri[first, lane], -1),
                   h.u.reshape(n_dev, n)[first, lane],
                   h.v.reshape(n_dev, n)[first, lane])
    # misses carry t_init; argmin picks a real hit whenever one exists
    t_key = jnp.where(tri >= 0, t, BIG_T)
    best = jnp.argmin(t_key, axis=0)
    lane = jnp.arange(n)
    return Hit(jnp.where(tri[best, lane] >= 0, t[best, lane], BIG_T),
               tri[best, lane],
               h.u.reshape(n_dev, n)[best, lane],
               h.v.reshape(n_dev, n)[best, lane])


# ---------------------------------------------------------------------------
# Legacy brute-force variant (small scenes / oracle for the BVH path)

def pad_triangles(tris: Triangles, multiple: int) -> Triangles:
    """Pad the triangle SoA to a device-count multiple with degenerate
    (never-hit) triangles."""
    t = tris.count
    pad = (-t) % multiple
    if pad == 0:
        return tris

    def pz(x, fill=0.0):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                       constant_values=fill)

    def pv(v: V3, fill=0.0) -> V3:
        return V3(pz(v.x, fill), pz(v.y, fill), pz(v.z, fill))

    return Triangles(
        p0=pv(tris.p0), e1=pv(tris.e1), e2=pv(tris.e2), gn=pv(tris.gn),
        n0=pv(tris.n0), n1=pv(tris.n1), n2=pv(tris.n2),
        uv0=pz(tris.uv0), uv1=pz(tris.uv1), uv2=pz(tris.uv2),
        area=pz(tris.area), mat_id=pz(tris.mat_id, 0),
        light_id=pz(tris.light_id, -1))


def closest_hit_sharded(tris: Triangles, o: V3, d: V3,
                        mesh: Mesh) -> Hit:
    """Closest hit with triangles sharded over mesh axis `rays`
    (brute-force per shard; the BVH path is traverse_sharded)."""
    n_dev = mesh.shape[RAY_AXIS]
    shard_size = tris.count // n_dev

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(RAY_AXIS), P(), P()),
        out_specs=P(RAY_AXIS))
    def run(local_tris: Triangles, o: V3, d: V3) -> Hit:
        idx = jax.lax.axis_index(RAY_AXIS)
        o, d = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, (RAY_AXIS,), to="varying"), (o, d))
        local = closest_hit_brute(local_tris, o, d)
        tri_g = jnp.where(local.tri >= 0,
                          local.tri + idx * shard_size, -1)
        return Hit(local.t, tri_g, local.u, local.v)

    n = o.x.shape[0]
    h = run(tris, o, d)
    t = h.t.reshape(n_dev, n)
    best = jnp.argmin(t, axis=0)
    lane = jnp.arange(n)
    return Hit(t[best, lane],
               h.tri.reshape(n_dev, n)[best, lane],
               h.u.reshape(n_dev, n)[best, lane],
               h.v.reshape(n_dev, n)[best, lane])


def shard_triangles(mesh: Mesh, tris: Triangles) -> Triangles:
    """Place the (padded) triangle SoA sharded on its leading axis."""
    s = NamedSharding(mesh, P(RAY_AXIS))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), tris)
