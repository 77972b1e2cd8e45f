"""Seeded scene writer: `.gem` meshes + `scene.json` in the loader's format.

Every scene the tests and `chip_smoke.py` render is generated here, so
`scene.loader.load_scene` (and the CLI's `-scene`) stays the one entry
point and no asset is downloaded.  Two scenes:

- `cornell`: the Cornell box at its published dimensions (the
  Bitterli/Mitsuba "cornell-box": a 2 x 2 x 2 room, red left wall, green
  right wall, two rotated boxes, one 0.47 x 0.38 area light of radiance
  (17, 12, 4), camera at (0, 1, 6.8), 19.5 degree field of view).  36
  triangles in 8 instances, all diffuse: the brute-force intersection
  path, and the scene `tests/oracle_pt.py` can render independently.
- `interior`: a closed room filled with many instances of a few
  tessellated meshes (sphere, torus, lathed vase, subdivided box) under
  three ceiling area lights, with diffuse, conductor, dielectric and
  plastic materials.  At the default `triangles=330_000` it matches the
  heavy-interior scale the reference renderer's users render (~331k
  triangles in ~850 instances); small `triangles` values give a CPU-test
  variant from the same code.

Run `python -m raytracingrenderer_tpu.scene.synth {cornell,interior} DIR`
to write a scene directory.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..io.png import write_png
from .gem import GEM_MAGIC

Mesh = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]  # p, n, uv, idx


# ---------------------------------------------------------------------------
# file writers

def write_gem(path: str, meshes: Sequence[Mesh]) -> None:
    """Write static meshes in the layout `scene.gem.load_gem` reads:
    44-byte vertices (position, normal, tangent, uv) and u32 indices."""
    out = [struct.pack("<III", GEM_MAGIC, 0, len(meshes))]
    for p, n, uv, idx in meshes:
        v = len(p)
        verts = np.zeros((v, 11), np.float32)
        verts[:, 0:3] = p
        verts[:, 3:6] = n
        verts[:, 9:11] = uv
        out.append(struct.pack("<I", 0))          # no properties
        out.append(struct.pack("<I", v) + verts.tobytes())
        idx = np.asarray(idx, np.uint32)
        out.append(struct.pack("<I", len(idx)) + idx.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(out))


def colour_png(scene_dir: str, rgb: Sequence[float]) -> str:
    """1x1 constant texture named like the reference's (`r_g_b_1.0.png`);
    8-bit channels truncate, as the reference's files do."""
    name = "_".join(f"{c:g}" for c in rgb) + "_1.0.png"
    px = np.asarray([int(c * 255.0) for c in rgb] + [255], np.uint8)
    write_png(os.path.join(scene_dir, name), px.reshape(1, 1, 4))
    return name


def _vec(v) -> str:
    return " ".join(f"{float(c):g}" for c in v)


def _world(scale=(1.0, 1.0, 1.0), yaw_deg: float = 0.0,
           rot: np.ndarray = None, translate=(0.0, 0.0, 0.0)) -> List[float]:
    """Row-major 4x4 world matrix: translate * rotate * scale."""
    c, s = math.cos(math.radians(yaw_deg)), math.sin(math.radians(yaw_deg))
    r = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    if rot is not None:
        r = r @ rot
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(scale, np.float64)[None, :]
    m[:3, 3] = translate
    return [float(x) for x in m.ravel()]


# rotations that take the rectangle's +z normal onto each axis
_FACE = {
    "+y": np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]]),
    "-y": np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]]),
    "+z": np.eye(3),
    "+x": np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]]),
    "-x": np.array([[0.0, 0, -1], [0, 1, 0], [1, 0, 0]]),
    "-z": np.array([[-1.0, 0, 0], [0, 1, 0], [0, 0, -1]]),
}


# ---------------------------------------------------------------------------
# meshes

def rectangle() -> Mesh:
    """Unit rectangle [-1, 1]^2 in the xy plane facing +z, two triangles,
    six unshared vertices."""
    q = np.array([[-1, -1], [1, -1], [1, 1], [-1, -1], [1, 1], [-1, 1]],
                 np.float32)
    p = np.concatenate([q, np.zeros((6, 1), np.float32)], 1)
    n = np.tile(np.float32([0, 0, 1]), (6, 1))
    return p, n, (q + 1.0) * 0.5, np.arange(6)


def box(div: int = 1) -> Mesh:
    """Cube [-1, 1]^3 with outward normals, each face a div x div grid."""
    ps, ns, uvs, idx = [], [], [], []
    g = np.linspace(-1.0, 1.0, div + 1, dtype=np.float32)
    gu, gv = np.meshgrid(g, g, indexing="ij")
    flat = np.stack([gu.ravel(), gv.ravel(),
                     np.ones(gu.size, np.float32)], 1)
    quad = _grid_indices(div + 1, div + 1)
    for rot in _FACE.values():
        base = sum(len(p) for p in ps)
        ps.append(flat @ rot.T.astype(np.float32))
        ns.append(np.tile(rot[:, 2].astype(np.float32), (len(flat), 1)))
        uvs.append((flat[:, :2] + 1.0) * 0.5)
        idx.append(quad + base)
    return (np.concatenate(ps), np.concatenate(ns), np.concatenate(uvs),
            np.concatenate(idx))


def _grid_indices(nu: int, nv: int) -> np.ndarray:
    """Two triangles per cell of an nu x nv vertex grid (row-major in u)."""
    i, j = np.meshgrid(np.arange(nu - 1), np.arange(nv - 1), indexing="ij")
    a = (i * nv + j).ravel()
    b, c, d = a + nv, a + nv + 1, a + 1
    return np.stack([a, b, c, a, c, d], 1).ravel()


def _revolve(radius: np.ndarray, height: np.ndarray, n_seg: int) -> Mesh:
    """Surface of revolution of the profile (radius, height) about +y."""
    phi = np.linspace(0.0, 2.0 * np.pi, n_seg + 1)
    r, _ = np.meshgrid(radius, phi, indexing="ij")
    y, ph = np.meshgrid(height, phi, indexing="ij")
    p = np.stack([r * np.cos(ph), y, r * np.sin(ph)], -1).reshape(-1, 3)
    # normals from the profile tangent, rotated about y
    dr = np.gradient(radius)
    dy = np.gradient(height)
    nr, ny = dy, -dr
    ln = np.maximum(np.hypot(nr, ny), 1e-12)
    nr, ny = nr / ln, ny / ln
    nrr, _ = np.meshgrid(nr, phi, indexing="ij")
    nyy, _ = np.meshgrid(ny, phi, indexing="ij")
    n = np.stack([nrr * np.cos(ph), nyy, nrr * np.sin(ph)], -1)
    n = n.reshape(-1, 3)
    uu, vv = np.meshgrid(np.linspace(0, 1, len(radius)),
                         np.linspace(0, 1, n_seg + 1), indexing="ij")
    uv = np.stack([vv.ravel(), uu.ravel()], 1)
    return (p.astype(np.float32), n.astype(np.float32),
            uv.astype(np.float32), _grid_indices(len(radius), n_seg + 1))


def sphere(n_lat: int = 12, n_lon: int = 18) -> Mesh:
    th = np.linspace(1e-3, np.pi - 1e-3, n_lat)
    return _revolve(np.sin(th), -np.cos(th), n_lon)


def torus(n_major: int = 20, n_minor: int = 11, minor: float = 0.35
          ) -> Mesh:
    a = np.linspace(0.0, 2.0 * np.pi, n_minor)
    return _revolve(1.0 - minor + minor * np.cos(a), minor * np.sin(a),
                    n_major)


def vase(n_seg: int = 20, n_prof: int = 11) -> Mesh:
    s = np.linspace(0.0, 1.0, n_prof)
    radius = 0.35 + 0.45 * np.sin(np.pi * (0.15 + 0.85 * s)) ** 2
    return _revolve(radius, 2.0 * s - 1.0, n_seg)


# ---------------------------------------------------------------------------
# scenes

def _write(scene_dir: str, desc: Dict) -> str:
    with open(os.path.join(scene_dir, "scene.json"), "w") as f:
        json.dump(desc, f, indent=1)
    return scene_dir


def cornell(scene_dir: str, width: int = 1024, height: int = 1024) -> str:
    """The Cornell box (36 triangles, 8 diffuse instances, 1 light)."""
    os.makedirs(scene_dir, exist_ok=True)
    write_gem(os.path.join(scene_dir, "Rectangle.gem"), [rectangle()])
    write_gem(os.path.join(scene_dir, "Cube.gem"), [box()])
    white = colour_png(scene_dir, (0.725, 0.71, 0.68))
    red = colour_png(scene_dir, (0.63, 0.065, 0.05))
    green = colour_png(scene_dir, (0.14, 0.45, 0.091))
    light = colour_png(scene_dir, (0.78, 0.78, 0.78))

    def rect(face, centre, half, refl, **extra):
        return dict(filename="Rectangle.gem", bsdf="diffuse",
                    reflectance=refl,
                    world=_world((half[0], half[1], 1.0), rot=_FACE[face],
                                 translate=centre), **extra)

    instances = [
        rect("+y", (0, 0, 0), (1, 1), white),            # floor
        rect("-y", (0, 2, 0), (1, 1), white),            # ceiling
        rect("+z", (0, 1, -1), (1, 1), white),           # back wall
        rect("-x", (1, 1, 0), (1, 1), green),            # right wall
        rect("+x", (-1, 1, 0), (1, 1), red),             # left wall
        dict(filename="Cube.gem", bsdf="diffuse", reflectance=white,
             world=_world((0.3, 0.3, 0.3), -17.0,
                          translate=(0.3286, 0.3, 0.3746))),   # short box
        dict(filename="Cube.gem", bsdf="diffuse", reflectance=white,
             world=_world((0.3, 0.6, 0.3), 17.0,
                          translate=(-0.3354, 0.6, -0.2914))),  # tall box
        rect("-y", (-0.005, 1.98, -0.03), (0.235, 0.19), light,
             emission=_vec((17.0, 12.0, 4.0))),          # area light
    ]
    return _write(scene_dir, {
        "width": width, "height": height, "fov": 19.5,
        "from": _vec((0, 1, 6.8)), "to": _vec((0, 1, 0)),
        "up": _vec((0, 1, 0)), "instances": instances})


_PALETTE = [(0.8, 0.78, 0.74), (0.62, 0.2, 0.12), (0.15, 0.38, 0.6),
            (0.3, 0.55, 0.25), (0.85, 0.7, 0.3), (0.45, 0.45, 0.5),
            (0.9, 0.9, 0.9), (0.25, 0.18, 0.12)]
# gold, copper, aluminium (eta, k at ~R/G/B)
_METALS = [((0.143, 0.374, 1.442), (3.983, 2.385, 1.603)),
           ((0.200, 0.924, 1.102), (3.912, 2.452, 2.142)),
           ((1.657, 0.880, 0.521), (9.224, 6.270, 4.837))]
_MESHES = {"sphere.gem": sphere, "torus.gem": torus, "vase.gem": vase,
           "box.gem": lambda: box(4)}


def interior(scene_dir: str, triangles: int = 330_000, seed: int = 0,
             width: int = 1920, height: int = 1080) -> str:
    """Closed 10 x 3 x 8 room of instanced tessellated meshes.

    The instance count follows `triangles` (about 400 triangles per
    instance, at least 8 instances); materials, placements and scales
    come from `seed`."""
    os.makedirs(scene_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    write_gem(os.path.join(scene_dir, "Rectangle.gem"), [rectangle()])
    mesh_tris = {}
    for name, make in _MESHES.items():
        m = make()
        write_gem(os.path.join(scene_dir, name), [m])
        mesh_tris[name] = len(m[3]) // 3
    names = list(_MESHES)
    wall = colour_png(scene_dir, (0.75, 0.73, 0.7))
    floor = colour_png(scene_dir, (0.45, 0.35, 0.25))
    colours = [colour_png(scene_dir, c) for c in _PALETTE]

    def rect(face, centre, half, refl, **extra):
        return dict(filename="Rectangle.gem", bsdf="diffuse",
                    reflectance=refl,
                    world=_world((half[0], half[1], 1.0), rot=_FACE[face],
                                 translate=centre), **extra)

    instances = [
        rect("+y", (0, 0, 0), (5, 4), floor),
        rect("-y", (0, 3, 0), (5, 4), wall),
        rect("+z", (0, 1.5, -4), (5, 1.5), wall),
        rect("-z", (0, 1.5, 4), (5, 1.5), wall),
        rect("+x", (-5, 1.5, 0), (4, 1.5), wall),
        rect("-x", (5, 1.5, 0), (4, 1.5), wall),
    ]
    for i, x in enumerate((-2.5, 0.0, 2.5)):                 # 3 lights
        le = (14.0, 13.0, 11.0) if i != 1 else (10.0, 11.0, 14.0)
        instances.append(rect("-y", (x, 2.99, -0.5), (0.5, 0.35),
                              colours[6], emission=_vec(le)))

    mean = float(np.mean(list(mesh_tris.values())))
    n_inst = max(8, int(round((triangles - 2 * len(instances)) / mean)))
    # three shelves of a jittered x-z lattice, clear of the camera
    nz = max(1, math.ceil(math.sqrt(n_inst / 3 * 5.6 / 8.8)))
    nx = max(1, math.ceil(n_inst / (3 * nz)))
    for k in rng.permutation(3 * nx * nz)[:n_inst]:
        iy, rest = divmod(int(k), nx * nz)
        ix, iz = divmod(rest, nz)
        pos = (-4.4 + 8.8 * (ix + rng.uniform(0.3, 0.7)) / nx,
               0.3 + 0.85 * iy + rng.uniform(0.0, 0.2),
               -3.6 + 5.6 * (iz + rng.uniform(0.3, 0.7)) / nz)
        s = float(rng.uniform(0.08, 0.2))
        inst = dict(filename=names[int(rng.integers(len(names)))],
                    world=_world((s, s, s), float(rng.uniform(0, 360)),
                                 translate=pos))
        kind = int(rng.integers(4))
        colour = colours[int(rng.integers(len(colours)))]
        if kind == 0:
            inst.update(bsdf="diffuse", reflectance=colour)
        elif kind == 1:
            eta, k = _METALS[int(rng.integers(len(_METALS)))]
            inst.update(bsdf="conductor", reflectance=colours[6],
                        eta=_vec(eta), k=_vec(k),
                        roughness=float(rng.uniform(0.05, 0.4)))
        elif kind == 2:
            inst.update(bsdf="dielectric", reflectance=colours[6],
                        intIOR=1.5, extIOR=1.0,
                        roughness=float(rng.choice([0.0, 0.1, 0.3])))
        else:
            inst.update(bsdf="plastic", reflectance=colour, intIOR=1.5,
                        extIOR=1.0, roughness=float(rng.uniform(0.1, 0.6)))
        instances.append(inst)
    return _write(scene_dir, {
        "width": width, "height": height, "fov": 60.0,
        "from": _vec((0.0, 1.6, 3.7)), "to": _vec((0.0, 1.0, -2.0)),
        "up": _vec((0, 1, 0)), "instances": instances})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scene", choices=("cornell", "interior"))
    p.add_argument("dir")
    p.add_argument("--triangles", type=int, default=330_000)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if a.scene == "cornell":
        cornell(a.dir)
    else:
        interior(a.dir, a.triangles, a.seed)
    print(a.dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
