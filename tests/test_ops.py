"""BVH traversal: the XLA traversal, the CUDA kernel's wrapper and the
dispatch between them.

The CUDA kernel itself has no interpret mode.  On the CPU its wrapper
(table packing, ray padding, depth checks) runs with `host_walk`, a
numpy transcription of `native/traverse.cu`'s loop over the same packed
tables, standing in for the launch; the `gpu`-marked tests run the real
kernel and skip where there is no card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import scene_path
from raytracingrenderer_tpu.core.vec import V3
from raytracingrenderer_tpu.geometry import intersect
from raytracingrenderer_tpu.ops import traverse
from raytracingrenderer_tpu.scene.loader import load_scene
from raytracingrenderer_tpu.scene.types import BVH


@pytest.fixture(scope="module")
def interior():
    return load_scene(scene_path("interior"))


def _rays(sc, n, seed):
    """Rays from inside the room's volume in all directions."""
    rng = np.random.default_rng(seed)
    c = np.asarray([sc.bounds.centre.x, sc.bounds.centre.y,
                    sc.bounds.centre.z], np.float32)
    r = float(sc.bounds.radius)
    o = c + rng.normal(size=(n, 3)).astype(np.float32) * r * 0.3
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (V3.from_stacked(jnp.asarray(o)),
            V3.from_stacked(jnp.asarray(d)), r)


# ---------------------------------------------------------------------------
# numpy references of the kernel's tables and walk

def pack_nodes_ref(bvh) -> np.ndarray:
    lo, hi = np.asarray(bvh.lo), np.asarray(bvh.hi)
    right, start = np.asarray(bvh.right), np.asarray(bvh.start)
    count = np.asarray(bvh.count)

    def code(c):
        return c if right[c] >= 0 else -(1 + (start[c] << 4 | count[c]))

    rows = np.zeros((len(right), 16), np.float32)
    ints = rows.view(np.int32)
    for i in range(len(right)):
        if right[i] >= 0:
            l, r = i + 1, right[i]
            rows[i, :12] = np.concatenate([lo[l], hi[l], lo[r], hi[r]])
            ints[i, 12:14] = code(l), code(r)
        else:
            rows[i, :12] = np.concatenate([lo[i], hi[i], [np.inf] * 3,
                                           [-np.inf] * 3])
            ints[i, 12:14] = code(i), -1
    return rows


def _walk(any_hit, nodes, tris, ox, oy, oz, dx, dy, dz, t_max):
    """native/traverse.cu's per-ray loop in numpy, float32 throughout."""
    f = np.float32
    ints = nodes.view(np.int32)
    n = ox.shape[0]
    out_t = t_max.astype(f).copy()
    out_tri = np.full(n, -1, np.int32)
    out_u = np.zeros(n, f)
    out_v = np.zeros(n, f)
    for i in range(n):
        o = np.array([ox[i], oy[i], oz[i]], f)
        d = np.array([dx[i], dy[i], dz[i]], f)
        inv = f(1) / np.where(np.abs(d) < f(1e-20), f(1e-20), d)
        t_best = out_t[i]
        if t_best <= 0:
            continue

        def slab(lo, hi):
            t0, t1 = (lo - o) * inv, (hi - o) * inv
            tmin = np.minimum(t0, t1).max()
            tmax = np.maximum(t0, t1).min()
            return tmin, tmax >= max(tmin, 0) and tmin < t_best

        stack, code, done = [], 0, False
        while not done:
            if code >= 0:
                row = nodes[code]
                tl, hl = slab(row[0:3], row[3:6])
                tr, hr = slab(row[6:9], row[9:12])
                cl, cr = ints[code, 12], ints[code, 13]
                if hl and hr:
                    if tr < tl:
                        cl, cr, tl, tr = cr, cl, tr, tl
                    stack.append((cr, tr))
                    code = cl
                    continue
                if hl or hr:
                    code = cl if hl else cr
                    continue
            else:
                leaf = -code - 1
                for k in range(leaf >> 4, (leaf >> 4) + (leaf & 15)):
                    p0, e1, e2 = tris[k, 0:3], tris[k, 4:7], tris[k, 8:11]
                    pv = np.cross(d, e2)
                    det = e1 @ pv
                    if abs(det) < 1e-12:
                        continue
                    tv = o - p0
                    u = (tv @ pv) / det
                    q = np.cross(tv, e1)
                    v = (d @ q) / det
                    t = (e2 @ q) / det
                    if u >= 0 and v >= 0 and u + v <= 1 and 0 < t < t_best:
                        t_best, out_tri[i] = t, k
                        out_u[i], out_v[i] = u, v
                        done = any_hit
                        if done:
                            break
                if done:
                    break
            while stack:
                c, t = stack.pop()
                if t < t_best:
                    code = c
                    break
            else:
                done = True
        out_t[i] = t_best
    return out_t, out_tri, out_u, out_v


def host_walk(any_hit, nodes, tris, *rays):
    """`traverse.traverse(call=...)` stand-in for the CUDA launch."""
    n = rays[0].shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    return jax.pure_callback(
        lambda *a: _walk(any_hit, *(np.asarray(x) for x in a)),
        (f32, jax.ShapeDtypeStruct((n,), jnp.int32), f32, f32),
        nodes, tris, *rays)


# ---------------------------------------------------------------------------

class TestXlaTraversal:
    """The XLA traversal: the CPU path and the kernel's plain reference."""

    def test_closest_matches_brute(self, interior):
        sc = interior
        o, d, _ = _rays(sc, 1024, 0)
        hb = intersect.closest_hit_brute(sc.triangles, o, d)
        hx = intersect.closest_hit_bvh(sc.bvh, sc.triangles, o, d)
        np.testing.assert_allclose(np.asarray(hx.t), np.asarray(hb.t),
                                   rtol=1e-4)
        # ids may differ only where two triangles tie on t
        assert (np.asarray(hb.tri) == np.asarray(hx.tri)).mean() > 0.999

    def test_any_hit_matches_brute(self, interior):
        sc = interior
        o, d, r = _rays(sc, 1024, 1)
        max_t = jnp.full(1024, r * 0.3)
        ob = intersect.any_hit_brute(sc.triangles, o, d, max_t)
        ox = intersect.any_hit_bvh(sc.bvh, sc.triangles, o, d, max_t)
        np.testing.assert_array_equal(np.asarray(ox), np.asarray(ob))


class TestKernelTables:
    def test_pack_nodes_matches_layout(self, interior):
        got = np.asarray(traverse.pack_nodes(interior.bvh))
        ref = pack_nodes_ref(interior.bvh)
        np.testing.assert_array_equal(got.view(np.int32)[:, 12:],
                                      ref.view(np.int32)[:, 12:])
        np.testing.assert_array_equal(got[:, :12], ref[:, :12])

    def test_pack_tris_rows(self, interior):
        t = interior.triangles
        got = np.asarray(traverse.pack_tris(t))
        assert got.shape == (t.count, 12)
        np.testing.assert_array_equal(got[:, 0:3], np.asarray(t.p0.stacked()))
        np.testing.assert_array_equal(got[:, 4:7], np.asarray(t.e1.stacked()))
        np.testing.assert_array_equal(got[:, 8:11], np.asarray(t.e2.stacked()))
        assert not got[:, 3::4].any()

    def test_leaf_root_row(self):
        """A one-leaf tree: row 0 holds the leaf and an empty sibling."""
        bvh = BVH(lo=jnp.zeros((1, 3)), hi=jnp.ones((1, 3)),
                  right=jnp.full(1, -1, jnp.int32),
                  start=jnp.zeros(1, jnp.int32),
                  count=jnp.full(1, 3, jnp.int32), leaf_max=3, depth=1)
        row = np.asarray(traverse.pack_nodes(bvh))[0]
        assert row.view(np.int32)[12] == traverse.leaf_code(0, 3)
        assert row.view(np.int32)[13] == traverse.leaf_code(0, 0) == -1
        assert np.isinf(row[6:12]).all()


class TestKernelWrapper:
    @pytest.mark.parametrize("any_hit", [False, True])
    def test_walk_matches_brute(self, interior, any_hit):
        sc = interior
        n = 777  # not a multiple of the block
        o, d, r = _rays(sc, n, 3)
        t0 = jnp.where(jnp.arange(n) % 5 == 0, -1.0,
                       r * 0.3 if any_hit else intersect.BIG_T)
        t, tri, _, _ = traverse.traverse(sc.bvh, sc.triangles, o, d, t0,
                                         any_hit, call=host_walk)
        assert t.shape == tri.shape == (n,)
        hb = intersect.closest_hit_brute(sc.triangles, o, d)
        live = np.asarray(t0) > 0
        ref = np.asarray(hb.valid & (hb.t < t0)) & live
        np.testing.assert_array_equal(np.asarray(tri) >= 0, ref)
        if not any_hit:
            np.testing.assert_allclose(np.asarray(t)[ref],
                                       np.asarray(hb.t)[ref], rtol=1e-4)
            same = np.asarray(tri)[ref] == np.asarray(hb.tri)[ref]
            assert same.mean() > 0.999

    def test_rays_padded_to_block(self, interior):
        seen = []

        def call(any_hit, nodes, tris, *rays):
            seen.append((rays[0].shape[0], np.asarray(rays[6])))
            n = rays[0].shape[0]
            return (rays[6], jnp.full(n, -1, jnp.int32),
                    jnp.zeros(n), jnp.zeros(n))

        o, d, _ = _rays(interior, 300, 4)
        out = traverse.traverse(interior.bvh, interior.triangles, o, d,
                                jnp.full(300, 5.0), call=call)
        (padded, t_max), = seen
        assert padded % traverse.BLOCK == 0 and padded >= 300
        assert (t_max[300:] < 0).all()           # padding lanes inactive
        assert all(a.shape == (300,) for a in out)

    def test_rejects_deep_trees(self):
        from raytracingrenderer_tpu.scene.types import tree_depth
        # a chain: node 2k is inner with leaf 2k+1 and next inner 2k+2
        depth = traverse.MAX_STACK + 1
        b = 2 * depth - 1
        right = np.full(b, -1, np.int32)
        right[0:b - 1:2] = np.arange(2, b + 1, 2)
        assert tree_depth(right) == depth
        bvh = BVH(lo=jnp.zeros((b, 3)), hi=jnp.ones((b, 3)),
                  right=jnp.asarray(right), start=jnp.zeros(b, jnp.int32),
                  count=jnp.ones(b, jnp.int32), leaf_max=1, depth=depth)
        o = V3.full((4,), 0.0, 0.0, 0.0)
        with pytest.raises(ValueError, match="depth"):
            traverse.traverse(bvh, None, o, o, jnp.ones(4), call=None)
        wide = BVH(bvh.lo, bvh.hi, bvh.right, bvh.start, bvh.count,
                   leaf_max=traverse.MAX_LEAF + 1, depth=3)
        with pytest.raises(ValueError, match="leaves"):
            traverse.check(wide)


class TestDispatch:
    """closest_hit/occluded pick brute force, the XLA traversal or the
    CUDA kernel from what they can observe: scene size and the platform
    the computation is lowered for."""

    def _lowered(self, sc, fn, platform, monkeypatch, cuda=True):
        monkeypatch.setattr(traverse, "cuda_present", lambda: cuda)
        monkeypatch.setattr(traverse, "register", lambda: "")
        o = V3.full((256,), 0.0, 1.0, 0.0)
        d = V3.full((256,), 0.0, 0.0, -1.0)
        f = jax.jit(lambda o, d: fn(sc, o, d))
        return f.trace(o, d).lower(lowering_platforms=(platform,)).as_text()

    @pytest.mark.parametrize("fn", ["closest", "any"])
    def test_bvh_scene_kernel_on_cuda_only(self, interior, fn,
                                           monkeypatch):
        call = ((lambda s, o, d: intersect.closest_hit(s, o, d).t)
                if fn == "closest" else
                (lambda s, o, d: intersect.occluded(s, o, d,
                                                    jnp.full(256, 3.0))))
        target = "rt_closest_hit" if fn == "closest" else "rt_any_hit"
        on_cuda = self._lowered(interior, call, "cuda", monkeypatch)
        on_cpu = self._lowered(interior, call, "cpu", monkeypatch)
        assert target in on_cuda and "stablehlo.while" not in on_cuda
        assert target not in on_cpu and "stablehlo.while" in on_cpu

    def test_small_scene_brute_force(self, monkeypatch):
        sc = load_scene(scene_path("cornell"))
        txt = self._lowered(sc, lambda s, o, d: intersect.closest_hit(
            s, o, d).t, "cuda", monkeypatch)
        assert "rt_closest_hit" not in txt and "custom_call" not in txt

    def test_no_cuda_backend_plain_xla(self, interior, monkeypatch):
        txt = self._lowered(interior, lambda s, o, d: intersect.closest_hit(
            s, o, d).t, "cpu", monkeypatch, cuda=False)
        assert "rt_closest_hit" not in txt and "stablehlo.while" in txt


@pytest.mark.gpu
class TestKernelOnCard:
    """The compiled CUDA kernel against brute force (run on the card)."""

    @pytest.mark.parametrize("any_hit", [False, True])
    def test_matches_brute(self, cuda, interior, any_hit):
        sc = interior
        n = 4097
        o, d, r = _rays(sc, n, 5)
        t0 = jnp.full(n, r * 0.3 if any_hit else intersect.BIG_T)
        traverse.register()
        t, tri, _, _ = jax.jit(lambda o, d, t0: traverse.traverse(
            sc.bvh, sc.triangles, o, d, t0, any_hit))(o, d, t0)
        hb = intersect.closest_hit_brute(sc.triangles, o, d)
        ref = np.asarray(hb.valid & (hb.t < t0))
        np.testing.assert_array_equal(np.asarray(tri) >= 0, ref)
        if not any_hit:
            np.testing.assert_allclose(np.asarray(t)[ref],
                                       np.asarray(hb.t)[ref], rtol=1e-4)
