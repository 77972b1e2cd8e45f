"""ctypes wrapper for the native C++ binned-SAH builder (native/).

The library is built from `native/bvh_builder.cpp` at first use
(utils/native.py).  If it cannot be built, the compiler's output is
logged and `build()` falls back to the pure-Python builder, which has
the same flat-array contract but is far slower on large scenes.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..scene.types import BVH
from ..utils import native
from ..utils.log import get_logger

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(native.build("build/libbvh.so"))
    except (RuntimeError, OSError) as e:
        get_logger("bvh").warning(
            "native BVH builder unavailable, using the Python builder: %s",
            e)
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.bvh_build_q.restype = ctypes.c_int
    lib.bvh_build_q.argtypes = [fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, fp, fp, ip, ip, ip, ip]
    lib.alias_build.restype = None
    lib.alias_build.argtypes = [ctypes.POINTER(ctypes.c_double),
                                ctypes.c_int, fp, ip]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build(tp: np.ndarray, max_leaf: int = 4, bins: int = 16,
          all_axes: bool = False) -> Tuple[BVH, np.ndarray]:
    """tp: (T, 3, 3) vertex positions -> (flat BVH, triangle order).

    bins/all_axes: SAH quality knobs, as in `bvh.build`.  On the
    reference's 331k-triangle bathroom, 64 bins over all three axes cut
    the global SAH cost by 32% against 16 bins on the widest axis
    (docs/BUILD_QUALITY_r5.md)."""
    lib = _load()
    if lib is None:
        from . import bvh as py_bvh
        return py_bvh.build(tp, max_leaf, bins=bins, all_axes=all_axes)
    t = len(tp)
    verts = np.ascontiguousarray(tp.reshape(t, 9), np.float32)
    cap = max(2 * t, 1)
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    right = np.empty(cap, np.int32)
    start = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    order = np.empty(max(t, 1), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n_nodes = lib.bvh_build_q(
        verts.ctypes.data_as(fp), t, max_leaf, bins, int(all_axes),
        lo.ctypes.data_as(fp), hi.ctypes.data_as(fp),
        right.ctypes.data_as(ip), start.ctypes.data_as(ip),
        count.ctypes.data_as(ip), order.ctypes.data_as(ip))
    if n_nodes <= 0:
        from . import bvh as py_bvh
        return py_bvh.build(tp, max_leaf, bins=bins, all_axes=all_axes)
    from ..scene.types import tree_depth
    return BVH(
        lo=jnp.asarray(lo[:n_nodes]), hi=jnp.asarray(hi[:n_nodes]),
        right=jnp.asarray(right[:n_nodes]),
        start=jnp.asarray(start[:n_nodes]),
        count=jnp.asarray(count[:n_nodes]),
        leaf_max=int(count[:n_nodes].max()) or 1,
        depth=tree_depth(right[:n_nodes]),
    ), order.astype(np.int64)
