"""scene.json + .gem -> Scene pytree (host-side, numpy).

Behavioral parity with the reference loader
(RTBase/SceneLoader.h:104-291): same bsdf-string mapping,
parameter names/defaults, vertex/normal transforms, zero-area triangle
culling, emissive-material -> area-light scan, envmap/black background,
camera construction (DX perspective n=0.001 f=10000, lookAt inverted,
flipX), and scene-bounds computation.  Output is flat SoA arrays instead
of pointer-linked Triangle/BSDF*/Light* heaps.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from ..core import matrix
from ..core.vec import V3
from ..io.hdr import read_hdr
from ..io.png import read_png_float
from ..lights.envmap import build_envmap
from .gem import load_gem
from .types import (BG_ENVMAP, BG_NONE, MAT_CONDUCTOR, MAT_DIELECTRIC,
                    MAT_DIFFUSE, MAT_GLASS, MAT_MIRROR, MAT_OREN_NAYAR,
                    MAT_PLASTIC, BackgroundT, Camera, LightTable,
                    MaterialTable, Scene, SceneBounds, TextureAtlas,
                    Triangles, v3_from_np)


def _get(props: Dict, key: str, default):
    """Typed property fetch mirroring GEMProperty::getValue: missing or
    null -> default; strings parsed to the default's type."""
    v = props.get(key)
    if v is None:
        return default
    if isinstance(default, float):
        return float(v)
    if isinstance(default, int) and not isinstance(default, bool):
        return int(float(v))
    return v


def _get_vec3(props: Dict, key: str, default=(0.0, 0.0, 0.0)):
    v = props.get(key)
    if v is None:
        return np.asarray(default, np.float32)
    parts = str(v).split()
    return np.asarray([float(p) for p in parts[:3]], np.float32)


class _TextureManager:
    """Path-keyed texture cache (reference SceneLoader.h:92-102).

    Constant-colour textures (including every 1x1 PNG the scenes ship)
    are folded into a colour; real textures are collected for the atlas.
    Missing files -> 1x1 white (reference Imaging.h:24-31 loadDefault).
    """

    def __init__(self):
        self.cache: Dict[str, tuple] = {}
        self.images: List[np.ndarray] = []   # (H, W, 3)
        self.alphas: List[Optional[np.ndarray]] = []

    def load(self, path: str):
        """-> (const_colour or None, atlas_index or -1)"""
        if path in self.cache:
            return self.cache[path]
        img = None
        alpha = None
        if os.path.isfile(path):
            try:
                if path.endswith(".hdr"):
                    img = read_hdr(path)
                else:
                    raw = read_png_float(path)
                    if raw.shape[-1] == 1:
                        raw = np.repeat(raw, 3, axis=-1)
                    if raw.shape[-1] == 4:
                        alpha = raw[..., 3].copy()
                    img = raw[..., :3].copy()
            except ValueError:
                img = None
        if img is None:
            result = (np.ones(3, np.float32), -1)  # default white
        elif (img.std(axis=(0, 1)).max() < 1e-6
              and (alpha is None or alpha.std() < 1e-6)):
            result = (img.reshape(-1, 3)[0].copy(), -1)
        else:
            self.images.append(img.astype(np.float32))
            self.alphas.append(alpha)
            result = (None, len(self.images) - 1)
        self.cache[path] = result
        return result

    def build_atlas(self) -> TextureAtlas:
        if not self.images:
            # Zero-length leading axis = static "no textures" signal;
            # texture.sample short-circuits on it so texture-free scenes
            # (e.g. cornell-box) pay nothing per bounce.
            return TextureAtlas(
                data=jnp.zeros((0, 1, 1, 3), jnp.float32),
                alpha=jnp.ones((0, 1, 1), jnp.float32),
                hw=jnp.ones((0, 2), jnp.int32))
        hmax = max(i.shape[0] for i in self.images)
        wmax = max(i.shape[1] for i in self.images)
        n = len(self.images)
        data = np.zeros((n, hmax, wmax, 3), np.float32)
        alpha = np.ones((n, hmax, wmax), np.float32)
        hw = np.zeros((n, 2), np.int32)
        for i, img in enumerate(self.images):
            h, w = img.shape[:2]
            data[i, :h, :w] = img
            if self.alphas[i] is not None:
                alpha[i, :h, :w] = self.alphas[i]
            hw[i] = (h, w)
        # 2x2 footprint rows (wrap pre-applied on each texture's TRUE
        # h/w): bilinear becomes one 16-float row gather (TextureAtlas
        # docstring; padded texels are never indexed, x0<w and y0<h)
        quad = np.zeros((n, hmax, wmax, 16), np.float32)
        for i in range(n):
            h, w = hw[i]
            c = data[i, :h, :w]
            a = alpha[i, :h, :w]
            cx = np.roll(c, -1, axis=1)
            cy = np.roll(c, -1, axis=0)
            cxy = np.roll(cx, -1, axis=0)
            ax = np.roll(a, -1, axis=1)
            ay = np.roll(a, -1, axis=0)
            axy = np.roll(ax, -1, axis=0)
            quad[i, :h, :w] = np.concatenate(
                [c, cx, cy, cxy, a[..., None], ax[..., None],
                 ay[..., None], axy[..., None]], axis=-1)
        return TextureAtlas(data=jnp.asarray(data), alpha=jnp.asarray(alpha),
                            hw=jnp.asarray(hw),
                            quad=jnp.asarray(
                                quad.reshape(n * hmax * wmax, 16)))


class _MaterialBuilder:
    """Accumulates per-instance material rows for the SoA table."""

    FIELDS = ("mtype", "albedo", "albedo_tex", "emission", "eta", "k",
              "int_ior", "ext_ior", "alpha", "sigma", "coat_thickness",
              "coat_sigma_a", "coat_int_ior", "coat_ext_ior")

    def __init__(self, scene_dir: str, tex: _TextureManager):
        self.scene_dir = scene_dir
        self.tex = tex
        self.rows: List[dict] = []

    def add(self, props: Dict) -> Optional[int]:
        bsdf = _get(props, "bsdf", "")
        refl_file = _get(props, "reflectance", "")
        const_col, tex_id = self.tex.load(
            os.path.join(self.scene_dir, refl_file))
        row = dict(
            mtype=MAT_DIFFUSE,
            albedo=const_col if const_col is not None
            else np.ones(3, np.float32),
            albedo_tex=tex_id,
            emission=np.zeros(3, np.float32),
            eta=np.ones(3, np.float32), k=np.zeros(3, np.float32),
            int_ior=1.33, ext_ior=1.0, alpha=1.62142, sigma=1.0,
            coat_thickness=0.0, coat_sigma_a=np.zeros(3, np.float32),
            coat_int_ior=1.33, coat_ext_ior=1.0)
        # alpha = 1.62142*sqrt(roughness): reference Materials.h:216,333,427
        if bsdf == "diffuse":
            row["mtype"] = MAT_DIFFUSE
        elif bsdf == "orennayar":
            row["mtype"] = MAT_OREN_NAYAR
            row["sigma"] = _get(props, "alpha", 1.0)
        elif bsdf == "mirror":
            row["mtype"] = MAT_MIRROR
        elif bsdf == "glass":
            row["mtype"] = MAT_GLASS
            row["int_ior"] = _get(props, "intIOR", 1.33)
            row["ext_ior"] = _get(props, "extIOR", 1.0)
        elif bsdf == "plastic":
            row["mtype"] = MAT_PLASTIC
            row["int_ior"] = _get(props, "intIOR", 1.33)
            row["ext_ior"] = _get(props, "extIOR", 1.0)
            row["alpha"] = 1.62142 * np.sqrt(_get(props, "roughness", 1.0))
        elif bsdf == "dielectric":
            rough = _get(props, "roughness", 1.0)
            row["int_ior"] = _get(props, "intIOR", 1.33)
            row["ext_ior"] = _get(props, "extIOR", 1.0)
            if rough < 0.001:  # reference SceneLoader.h:149-156
                row["mtype"] = MAT_GLASS
            else:
                row["mtype"] = MAT_DIELECTRIC
                row["alpha"] = 1.62142 * np.sqrt(rough)
        elif bsdf == "conductor":
            row["mtype"] = MAT_CONDUCTOR
            row["eta"] = _get_vec3(props, "eta", (1.0, 1.0, 1.0))
            row["k"] = _get_vec3(props, "k", (0.0, 0.0, 0.0))
            row["alpha"] = 1.62142 * np.sqrt(_get(props, "roughness", 1.0))
        else:
            # Unknown bsdf: reference logs and skips the instance
            # (SceneLoader.h:189-194).
            return None
        if _get(props, "emission", "") != "":
            row["emission"] = _get_vec3(props, "emission")
        if _get(props, "coatingThickness", 0.0) > 0:
            row["coat_thickness"] = _get(props, "coatingThickness", 0.0)
            row["coat_sigma_a"] = _get_vec3(props, "coatingSigmaA")
            row["coat_int_ior"] = _get(props, "coatingIntIOR", 1.33)
            row["coat_ext_ior"] = _get(props, "coatingExtIOR", 1.0)
        self.rows.append(row)
        return len(self.rows) - 1

    def build(self) -> MaterialTable:
        r = self.rows or [dict(
            mtype=MAT_DIFFUSE, albedo=np.ones(3, np.float32), albedo_tex=-1,
            emission=np.zeros(3, np.float32), eta=np.ones(3, np.float32),
            k=np.zeros(3, np.float32), int_ior=1.33, ext_ior=1.0,
            alpha=1.62142, sigma=1.0, coat_thickness=0.0,
            coat_sigma_a=np.zeros(3, np.float32), coat_int_ior=1.33,
            coat_ext_ior=1.0)]

        def col(k):
            return np.asarray([row[k] for row in r])

        emission = col("emission").astype(np.float32)
        return MaterialTable(
            mtype=jnp.asarray(col("mtype"), jnp.int32),
            albedo=v3_from_np(col("albedo")),
            albedo_tex=jnp.asarray(col("albedo_tex"), jnp.int32),
            emission=v3_from_np(emission),
            is_emissive=jnp.asarray(emission.max(axis=1) > 0.0),
            eta=v3_from_np(col("eta")),
            k=v3_from_np(col("k")),
            int_ior=jnp.asarray(col("int_ior"), jnp.float32),
            ext_ior=jnp.asarray(col("ext_ior"), jnp.float32),
            alpha=jnp.asarray(col("alpha"), jnp.float32),
            sigma=jnp.asarray(col("sigma"), jnp.float32),
            coat_thickness=jnp.asarray(col("coat_thickness"), jnp.float32),
            coat_sigma_a=v3_from_np(col("coat_sigma_a")),
            coat_int_ior=jnp.asarray(col("coat_int_ior"), jnp.float32),
            coat_ext_ior=jnp.asarray(col("coat_ext_ior"), jnp.float32))


def load_scene(scene_dir: str, build_bvh: bool = True,
               scene_shards: int = 0) -> Scene:
    """Load a reference-format scene directory into a Scene pytree.

    scene_shards > 0 builds the primitive-sharded acceleration form
    (parallel/scene_shard.py): the triangle order is globally
    SAH-sorted, chunked into that many shards, each with its own
    sub-BVH, and geometry.intersect traverses per shard under shard_map
    — the beyond-HBM scale-out path of SURVEY §2.11.
    """
    with open(os.path.join(scene_dir, "scene.json")) as f:
        desc = json.load(f)

    width = _get(desc, "width", 1920)
    height = _get(desc, "height", 1080)
    fov = _get(desc, "fov", 45.0)
    P = matrix.perspective(0.001, 10000.0, width / height, fov)
    if _get(desc, "flipX", 0) == 1:
        P[0, 0] = -P[0, 0]
    V = matrix.look_at(_get_vec3(desc, "from"), _get_vec3(desc, "to"),
                       _get_vec3(desc, "up", (0.0, 1.0, 0.0)))
    cam_to_world = matrix.invert(V)

    tex = _TextureManager()
    mat = _MaterialBuilder(scene_dir, tex)
    pos_list, n_list, uv_list, mid_list = [], [], [], []
    for inst in desc.get("instances", []):
        if not os.path.isfile(os.path.join(scene_dir, inst["filename"])):
            # Shipped scenes reference meshes absent from the repo
            # (SURVEY.md §2.8: coffee x3, materialball x1) — skip the
            # instance and keep loading, like the reference's unknown-
            # bsdf path (SceneLoader.h:189-194).
            continue
        mat_id = mat.add(inst)
        if mat_id is None:
            continue
        world = np.asarray(inst.get("world", np.eye(4).ravel()),
                           np.float32).reshape(4, 4)
        nrm_xform = matrix.invert(world).T
        verts_p, verts_n, verts_uv, index_chunks = [], [], [], []
        voffset = 0
        for mesh in load_gem(os.path.join(scene_dir, inst["filename"])):
            p = mesh.positions @ world[:3, :3].T + world[:3, 3]
            n = mesh.normals @ nrm_xform[:3, :3].T
            n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
            verts_p.append(p.astype(np.float32))
            verts_n.append(n.astype(np.float32))
            verts_uv.append(mesh.uvs)
            index_chunks.append(mesh.indices.astype(np.int64) + voffset)
            voffset += len(p)
        p = np.concatenate(verts_p)
        n = np.concatenate(verts_n)
        uv = np.concatenate(verts_uv)
        idx = np.concatenate(index_chunks).reshape(-1, 3)
        pos_list.append(p[idx])        # (T, 3, 3)
        n_list.append(n[idx])
        uv_list.append(uv[idx])        # (T, 3, 2)
        mid_list.append(np.full(len(idx), mat_id, np.int32))

    if pos_list:
        tp = np.concatenate(pos_list)
        tn = np.concatenate(n_list)
        tuv = np.concatenate(uv_list)
        tmid = np.concatenate(mid_list)
    else:
        tp = np.zeros((0, 3, 3), np.float32)
        tn = np.zeros((0, 3, 3), np.float32)
        tuv = np.zeros((0, 3, 2), np.float32)
        tmid = np.zeros((0,), np.int32)

    e1 = tp[:, 1] - tp[:, 0]
    e2 = tp[:, 2] - tp[:, 0]
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=1)
    keep = area > 0.0  # reference culls zero-area triangles
    tp, tn, tuv, tmid = tp[keep], tn[keep], tuv[keep], tmid[keep]
    e1, e2, cr, area = e1[keep], e2[keep], cr[keep], area[keep]
    gn = cr / np.maximum(np.linalg.norm(cr, axis=1, keepdims=True), 1e-20)
    # Canonicalize: geometric normal agrees with vertex normal 0
    # (reference Triangle::gNormal, Geometry.h:127-130) — light emission
    # sidedness and shading both key off this orientation.
    gn = np.where((gn * tn[:, 0]).sum(axis=1, keepdims=True) >= 0.0,
                  gn, -gn)

    materials = mat.build()
    # Emissive-material scan -> light table (reference Scene.h:96-105).
    em = np.asarray([row["emission"] for row in mat.rows]) \
        if mat.rows else np.zeros((1, 3))
    is_em = em.max(axis=1) > 0.0 if len(em) else np.zeros(0, bool)
    light_tri = np.nonzero(is_em[tmid])[0].astype(np.int32)
    light_le = em[tmid[light_tri]].astype(np.float32)
    light_area = area[light_tri].astype(np.float32)
    lum = (0.2126 * light_le[:, 0] + 0.7152 * light_le[:, 1]
           + 0.0722 * light_le[:, 2])
    light_id = np.full(len(tp), -1, np.int32)
    light_id[light_tri] = np.arange(len(light_tri), dtype=np.int32)

    triangles = Triangles(
        p0=v3_from_np(tp[:, 0]), e1=v3_from_np(e1), e2=v3_from_np(e2),
        gn=v3_from_np(gn),
        n0=v3_from_np(tn[:, 0]), n1=v3_from_np(tn[:, 1]),
        n2=v3_from_np(tn[:, 2]),
        uv0=jnp.asarray(tuv[:, 0]), uv1=jnp.asarray(tuv[:, 1]),
        uv2=jnp.asarray(tuv[:, 2]),
        area=jnp.asarray(area, jnp.float32),
        mat_id=jnp.asarray(tmid, jnp.int32),
        light_id=jnp.asarray(light_id))

    lights = LightTable(
        tri=jnp.asarray(light_tri), le=v3_from_np(light_le),
        area=jnp.asarray(light_area),
        power=jnp.asarray(lum * light_area, jnp.float32),
        p0=v3_from_np(tp[light_tri, 0]), e1=v3_from_np(e1[light_tri]),
        e2=v3_from_np(e2[light_tri]), gn=v3_from_np(gn[light_tri]))

    envmap_file = _get(desc, "envmap", "")
    if envmap_file:
        env_img = read_hdr(os.path.join(scene_dir, envmap_file)) \
            if os.path.isfile(os.path.join(scene_dir, envmap_file)) \
            else np.ones((2, 4, 3), np.float32)
        background = BackgroundT(BG_ENVMAP, V3.of(0.0, 0.0, 0.0),
                                 build_envmap(env_img))
    else:
        # Reference: black BackgroundColour, power 0, not in light list.
        background = BackgroundT(BG_NONE, V3.of(0.0, 0.0, 0.0), None)

    if len(tp):
        lo = tp.reshape(-1, 3).min(axis=0)
        hi = tp.reshape(-1, 3).max(axis=0)
    else:
        lo = hi = np.zeros(3, np.float32)
    centre = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - centre))
    bounds = SceneBounds(centre=V3.of(*centre),
                         radius=jnp.float32(radius))

    # Film area from projection (reference Scene.h:22-32).
    w_lens = 2.0 / P[1, 1]
    h_lens = w_lens * (P[0, 0] / P[1, 1])
    a_film = abs(w_lens * h_lens)
    origin = matrix.mul_point_np(cam_to_world, [0.0, 0.0, 0.0])
    camera = Camera(
        p=jnp.asarray(P), p_inv=jnp.asarray(matrix.invert(P)),
        cam_to_world=jnp.asarray(cam_to_world), world_to_cam=jnp.asarray(V),
        width=width, height=height,
        origin=V3.of(*origin), a_film=jnp.float32(a_film))

    bvh = None
    if build_bvh and len(tp) and scene_shards > 0:
        from ..parallel.scene_shard import (attach_attrs, build_sharded,
                                            stub_triangles)
        bvh, order = build_sharded(tp, scene_shards)
        triangles = _reorder_padded(triangles, order)
        inv = np.empty(len(tp), np.int64)
        inv[order[order >= 0]] = np.nonzero(order >= 0)[0]
        lights = lights._replace(tri=jnp.asarray(inv[np.asarray(light_tri)],
                                                 jnp.int32))
        # shard the attribute table with the geometry and drop the
        # replicated SoA: no per-triangle array is whole on any device
        bvh = attach_attrs(bvh, triangles, materials)
        triangles = stub_triangles(triangles)
    elif build_bvh and len(tp):
        # native C++ binned-SAH builder (Python builder if it cannot be
        # built); 64 bins over all axes, leaves of up to bvh.MAX_LEAF
        from ..geometry import bvh as bvh_mod
        from ..geometry.bvh_native import build as bvh_build
        bvh, order = bvh_build(tp, max_leaf=bvh_mod.MAX_LEAF, bins=64,
                               all_axes=True)
        triangles = _reorder(triangles, order)
        # light table indexes triangles: remap
        inv = np.empty(len(order), np.int64)
        inv[order] = np.arange(len(order))
        lights = lights._replace(tri=jnp.asarray(inv[np.asarray(light_tri)],
                                                 jnp.int32))

    return Scene(triangles=triangles, materials=materials,
                 textures=tex.build_atlas(), lights=lights,
                 background=background, camera=camera, bounds=bounds,
                 bvh=bvh, edge_mult=_edge_multiplicity(triangles))


def _edge_multiplicity(tris: Triangles) -> jnp.ndarray:
    """(3T,) f32: how many triangles share each geometric edge (exact
    endpoint match, orientation-free).  The boundary estimator divides
    by this so shared silhouette edges are not integrated once per
    incident triangle (Scene.edge_mult docstring)."""
    p0 = np.stack([np.asarray(tris.p0.x), np.asarray(tris.p0.y),
                   np.asarray(tris.p0.z)], -1)
    p1 = p0 + np.stack([np.asarray(tris.e1.x), np.asarray(tris.e1.y),
                        np.asarray(tris.e1.z)], -1)
    p2 = p0 + np.stack([np.asarray(tris.e2.x), np.asarray(tris.e2.y),
                        np.asarray(tris.e2.z)], -1)
    ends = np.stack([np.stack([p0, p1], 1), np.stack([p1, p2], 1),
                     np.stack([p2, p0], 1)], 1)      # (T, 3, 2, 3)
    t = ends.shape[0]
    flat = ends.reshape(t * 3, 2, 3)
    # canonical endpoint order (lexicographic), then exact-byte keys
    a, b = flat[:, 0], flat[:, 1]
    a_first = ((a[:, 0] < b[:, 0])
               | ((a[:, 0] == b[:, 0])
                  & ((a[:, 1] < b[:, 1])
                     | ((a[:, 1] == b[:, 1]) & (a[:, 2] <= b[:, 2])))))
    lo = np.where(a_first[:, None], a, b)
    hi = np.where(a_first[:, None], b, a)
    keys = np.concatenate([lo, hi], 1).astype(np.float32).view(np.uint8)
    keys = keys.reshape(t * 3, -1)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
    return jnp.asarray(counts[inverse].astype(np.float32))


def _reorder_padded(t: Triangles, order: np.ndarray) -> Triangles:
    """Reorder with -1 slots mapped to degenerate (never-hit) padding
    triangles: zero geometry, material 0, no light."""
    safe = np.where(order >= 0, order, 0)
    out = _reorder(t, safe)
    pad = jnp.asarray(order < 0)

    def zv(v):
        return V3(jnp.where(pad, 0.0, v.x), jnp.where(pad, 0.0, v.y),
                  jnp.where(pad, 0.0, v.z))

    return out._replace(
        p0=zv(out.p0), e1=zv(out.e1), e2=zv(out.e2),
        area=jnp.where(pad, 0.0, out.area),
        mat_id=jnp.where(pad, 0, out.mat_id),
        light_id=jnp.where(pad, -1, out.light_id))


def _reorder(t: Triangles, order: np.ndarray) -> Triangles:
    idx = jnp.asarray(order, jnp.int32)

    def g(x):
        return x[idx]

    new_light = t.light_id[idx]
    return Triangles(
        p0=t.p0.gather(idx), e1=t.e1.gather(idx), e2=t.e2.gather(idx),
        gn=t.gn.gather(idx), n0=t.n0.gather(idx), n1=t.n1.gather(idx),
        n2=t.n2.gather(idx), uv0=g(t.uv0), uv1=g(t.uv1), uv2=g(t.uv2),
        area=g(t.area), mat_id=g(t.mat_id), light_id=new_light)
