"""Scene representation: a pytree of flat device arrays.

The reference keeps a heap of pointer-linked objects (Scene owns Triangle
vector, BSDF* vector, Light* list, BVHNode* tree — RTBase/
Scene.h:72-106).  Here the whole scene is instead a pytree of
structure-of-arrays buffers that is passed as an argument into jitted
render functions: triangles as SoA component arrays, materials as an
enum-tagged parameter table, lights as an index table, the BVH as
flattened contiguous arrays.  Every leaf is a JAX array, so the scene is
shardable and donate-able; the differentiable parameter surface is
material albedo/emission/roughness, light radiance, envmap texels, AND
vertex positions (diff._split_scene).  Hit *ids* stay stop-gradiented
discrete structure, but the hit solution (t, barycentrics) is re-solved
differentiably from the id (integrators.common.shading_data with
geom_grads=True), so interior-term geometry gradients flow; only the
silhouette/visibility boundary term remains a documented descope
(diff.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.vec import V3

# Material type enum (matches the reference BSDF subclass set,
# RTBase/Materials.h:118-511).
MAT_DIFFUSE = 0
MAT_MIRROR = 1
MAT_CONDUCTOR = 2
MAT_GLASS = 3
MAT_DIELECTRIC = 4  # rough glass
MAT_OREN_NAYAR = 5
MAT_PLASTIC = 6
NUM_MAT_TYPES = 7

# Background type enum (reference Lights.h:84-201).
BG_NONE = 0      # black BackgroundColour(0,0,0)
BG_CONST = 1     # constant BackgroundColour
BG_ENVMAP = 2    # lat-long EnvironmentMap


class Triangles(NamedTuple):
    """SoA triangle buffer; every component is a (T,) array.

    Precomputes what reference Triangle::init caches (Geometry.h:72-88):
    edge vectors, geometric normal, area.
    """
    p0: V3          # vertex 0 position
    e1: V3          # p1 - p0
    e2: V3          # p2 - p0
    gn: V3          # unit geometric normal (e1 x e2 normalized)
    n0: V3          # shading normals at the three vertices
    n1: V3
    n2: V3
    uv0: jax.Array  # (T, 2)
    uv1: jax.Array
    uv2: jax.Array
    area: jax.Array      # (T,)
    mat_id: jax.Array    # (T,) int32 index into MaterialTable
    light_id: jax.Array  # (T,) int32 index into LightTable, -1 if not a light

    @property
    def count(self) -> int:
        return self.area.shape[0]


class MaterialTable(NamedTuple):
    """Enum-tagged SoA material table; every component is (M,) (or V3 of (M,)).

    Replaces the reference's virtual-dispatch BSDF* vector with data a
    branchless lax.switch/select can consume.
    """
    mtype: jax.Array       # (M,) int32, MAT_*
    albedo: V3             # constant reflectance colour
    albedo_tex: jax.Array  # (M,) int32 atlas index, -1 = constant
    emission: V3           # radiance for emissive materials
    is_emissive: jax.Array # (M,) bool
    eta: V3                # conductor complex IOR (real part)
    k: V3                  # conductor complex IOR (imaginary part)
    int_ior: jax.Array     # (M,)
    ext_ior: jax.Array     # (M,)
    alpha: jax.Array       # (M,) GGX roughness alpha (1.62142*sqrt(r), Materials.h:216)
    sigma: jax.Array       # (M,) Oren-Nayar sigma
    # Layered coating (reference LayeredBSDF, Materials.h:467-511)
    coat_thickness: jax.Array  # (M,) 0 = uncoated
    coat_sigma_a: V3
    coat_int_ior: jax.Array
    coat_ext_ior: jax.Array

    @property
    def count(self) -> int:
        return self.mtype.shape[0]


class TextureAtlas(NamedTuple):
    """Non-constant textures, padded to a common (H, W) grid.

    data is (N, Hmax, Wmax, 3); hw holds each texture's true (h, w) for
    wrap arithmetic.  Constant 1x1 textures are folded into
    MaterialTable.albedo at load time and never reach the atlas.
    """
    data: jax.Array   # (N, Hmax, Wmax, 3) f32
    alpha: jax.Array  # (N, Hmax, Wmax) f32 (1.0 where absent)
    hw: jax.Array     # (N, 2) int32
    # (N*Hmax*Wmax, 16) f32 rows [rgb00 rgb10 rgb01 rgb11 a00 a10 a01
    # a11]: the 2x2 bilinear footprint with wrap pre-applied, so one
    # sample = ONE row gather instead of 4 texel gathers.  None when the
    # loader skipped building it.
    quad: Optional[jax.Array] = None


class LightTable(NamedTuple):
    """Area lights: one row per emissive triangle (reference Scene.h:96-105
    builds an AreaLight per emissive Triangle*).

    The table carries its own copy of the emitter geometry (p0/e1/e2/gn)
    so light sampling never touches the full triangle SoA — one less
    gather per NEE sample, and the SoA can be dropped entirely in
    scene-sharded mode (parallel/scene_shard.py attribute sharding).
    """
    tri: jax.Array   # (L,) int32 triangle index (for hit->light mapping)
    le: V3           # emitted radiance
    area: jax.Array  # (L,)
    power: jax.Array # (L,) total integrated power Lum(Le)*area*pi
    p0: V3           # (L,) emitter vertex 0
    e1: V3           # (L,) emitter edges
    e2: V3
    gn: V3           # (L,) emitter geometric normal (canonical)


class EnvMap(NamedTuple):
    """Lat-long environment map with a luminance alias table.

    The reference's EnvironmentMap leaves importance sampling as a TODO
    (Lights.h:158-161).  Sampling uses the Walker/Vose alias method over
    flattened texels: O(1) per sample — one gather + one compare —
    where an inverse-CDF searchsorted costs ~log2(H*W) dependent gather
    rounds.
    """
    data: jax.Array       # (H, W, 3) radiance
    alias_row: jax.Array  # (H*W, 2) [accept prob, alias index as f32]:
                          # ONE row gather per sample
    texel_row: jax.Array  # (H*W, 4) [R, G, B, pdf2d]: the sampled
                          # texel's radiance + density in one gather
    pdf2d: jax.Array      # (H, W) probability density over (u,v) in [0,1]^2
    mean_power: jax.Array # scalar: sin-weighted mean luminance * 4pi


class Background(NamedTuple):
    colour: V3       # for BG_CONST
    envmap: Optional[EnvMap]
    # NOTE: `kind` is static pytree metadata, set via make_background below.


class _BackgroundStatic(NamedTuple):
    """Wrapper carrying the static BG_* kind out-of-band of tracing."""
    kind: int


def make_background(kind: int, colour: V3,
                    envmap: Optional[EnvMap]) -> "BackgroundT":
    return BackgroundT(kind=kind, colour=colour, envmap=envmap)


@jax.tree_util.register_pytree_node_class
class BackgroundT:
    """Background with a *static* kind (BG_NONE/BG_CONST/BG_ENVMAP) so that
    jit specializes the miss shader instead of tracing a switch."""

    def __init__(self, kind: int, colour: V3, envmap: Optional[EnvMap]):
        self.kind = int(kind)
        self.colour = colour
        self.envmap = envmap

    def tree_flatten(self):
        return (self.colour, self.envmap), self.kind

    @classmethod
    def tree_unflatten(cls, kind, children):
        colour, envmap = children
        return cls(kind, colour, envmap)


@jax.tree_util.register_pytree_node_class
class Camera:
    """Pinhole camera; matrices follow reference Scene.h:10-70 conventions:
    P is DX-style perspective, `cam_to_world` = lookAt(from,to,up)^-1.
    width/height are static metadata (shapes depend on them)."""

    def __init__(self, p, p_inv, cam_to_world, world_to_cam,
                 width: int, height: int, origin: V3, a_film):
        self.p = p                        # (4,4) projection
        self.p_inv = p_inv                # (4,4)
        self.cam_to_world = cam_to_world  # (4,4) view -> world
        self.world_to_cam = world_to_cam  # (4,4) world -> view
        self.width = int(width)
        self.height = int(height)
        self.origin = origin              # scalar V3 camera position
        self.a_film = a_film              # film area (light-tracing importance)

    def tree_flatten(self):
        children = (self.p, self.p_inv, self.cam_to_world, self.world_to_cam,
                    self.origin, self.a_film)
        return children, (self.width, self.height)

    @classmethod
    def tree_unflatten(cls, aux, children):
        p, p_inv, c2w, w2c, origin, a_film = children
        return cls(p, p_inv, c2w, w2c, aux[0], aux[1], origin, a_film)


class SceneBounds(NamedTuple):
    """Replaces the use<SceneBounds>() singleton (Core.h:562-567) —
    threaded explicitly through the scene pytree."""
    centre: V3      # scalar V3
    radius: jax.Array


@jax.tree_util.register_pytree_node_class
class BVH:
    """Flattened binary BVH in depth-first order.

    node i: bounds (lo,hi); if leaf, [start, start+count) indexes the
    (reordered) triangle arrays; else `right` is the index of the right
    child (left child is i+1, the next node in DFS order).

    `leaf_max` and `depth` are *static* pytree metadata: the largest
    leaf (the XLA traversal unrolls its leaf loop to it) and the tree
    depth, root = 1 (the CUDA kernel's fixed stack must hold it,
    ops/traverse.check).
    """

    def __init__(self, lo, hi, right, start, count,
                 leaf_max: int = 4, depth: int = 0):
        self.lo = lo         # (B, 3)
        self.hi = hi         # (B, 3)
        self.right = right   # (B,) int32: right-child index, -1 for leaf
        self.start = start   # (B,) int32: first triangle (leaf)
        self.count = count   # (B,) int32: triangle count (0 for inner)
        self.leaf_max = int(leaf_max)
        self.depth = int(depth)

    def tree_flatten(self):
        return ((self.lo, self.hi, self.right, self.start, self.count),
                (self.leaf_max, self.depth))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, leaf_max=aux[0], depth=aux[1])


def tree_depth(right: np.ndarray) -> int:
    """Max depth (root=1) of the DFS-flattened binary BVH."""
    right = np.asarray(right)
    b = right.shape[0]
    depth = np.ones(b, np.int32)
    for i in range(b):
        r = right[i]
        if r >= 0:
            depth[i + 1] = depth[i] + 1
            depth[r] = depth[i] + 1
    return int(depth.max()) if b else 0


class Scene(NamedTuple):
    triangles: Triangles
    materials: MaterialTable
    textures: TextureAtlas
    lights: LightTable
    background: Background
    camera: Camera
    bounds: SceneBounds
    bvh: Optional[BVH]
    # (3T,) f32 multiplicity of each triangle edge (edge k = 3j+w of
    # triangle j): how many triangles share that geometric edge.  The
    # boundary-term estimator (integrators/boundary.py) divides each
    # edge sample's contribution by it — a silhouette edge of a closed
    # mesh appears in TWO triangles and would otherwise be integrated
    # twice (measured ~2.3x overestimate on cornell's boxes).  None =
    # treat as 1 (correct for open single-sided sheets).
    edge_mult: Optional[jax.Array] = None

    @property
    def num_lights(self) -> int:
        return self.lights.tri.shape[0]


def device_put_scene(scene: Scene) -> Scene:
    """Move every leaf to the default device as f32/int32 jnp arrays."""
    return jax.tree_util.tree_map(jnp.asarray, scene)


def v3_from_np(a: np.ndarray) -> V3:
    a = np.asarray(a, np.float32)
    return V3(jnp.asarray(np.ascontiguousarray(a[..., 0])),
              jnp.asarray(np.ascontiguousarray(a[..., 1])),
              jnp.asarray(np.ascontiguousarray(a[..., 2])))
