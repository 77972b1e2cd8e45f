"""Render configuration (replaces the reference's compile-time constants,
RTBase/Renderer.h:18-24 and hand-parsed CLI flags,
Main.cpp:29-66)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Reference constants (Renderer.h:18-24, Geometry.h:60)
TILE_SIZE = 32
MAX_DEPTH = 4
MAX_SAMPLES = 10240
MIN_SAMPLES = 1
INIT_SAMPLES = 2
MAX_VPL = 50
EPSILON = 1e-4


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    spp: int = 8192                  # reference default (Main.cpp:26)
    max_depth: int = MAX_DEPTH       # NEE continues one extra bounce
    rr_cap: float = 0.9              # Russian roulette cap (Renderer.h:353)
    rr: bool = True                  # disable for gradient checks: RR's
                                     # discrete survival breaks FD oracles
    mis: bool = True                 # balance-heuristic MIS (reference has
                                     # computeDirectMIS but ships computeDirect)
    jitter: bool = False             # sub-pixel jitter (reference renders
                                     # pixel centres only, Renderer.h:806-808)
    integrator: str = "path"         # path | lighttrace | vpl | direct |
                                     # albedo | normals | adaptive
    batch_rays: int = 1 << 18        # rays per device dispatch
    exposure: float = 1.0
    seed: int = 0
    # Debug switches: zero out one MIS strategy (for estimator tests —
    # the two halves must sum to the NEE-mode estimate in expectation).
    debug_no_nee: bool = False
    debug_no_emission: bool = False
    # Static set of MAT_* types present in the scene; None = assume all.
    # render() fills it in from the material table so jit only compiles
    # the BSDF lobes the scene uses (see materials/bsdf.py:_has).
    mat_types: Optional[Tuple[int, ...]] = None
    # Power-weighted NEE light selection (lights.selection_pmf):
    # pick lights proportional to totalIntegratedPower instead of the
    # reference's uniform 1/N — a variance win on many-light scenes
    # with asymmetric emitters (coffee's 3 lights).  Unbiased either
    # way; MIS counterweights follow the same pmf.  Off by default for
    # reference stream parity.
    power_lights: bool = False
    # Geometry (vertex-position) gradients: re-solve the hit's (t, u, v)
    # differentiably from the detached triangle id and attach it
    # straight-through (primal unchanged), so hit positions, frames and
    # NEE geometry terms carry d/d(vertex) — the interior term of the
    # differentiable-rendering integral.  Silhouette/visibility boundary
    # terms are out of scope (see diff.py).  Off by default: forward
    # renders shouldn't pay the extra per-hit vertex gathers; diff.py
    # turns it on for its parameter surface.
    geom_grads: bool = False
    # Silhouette/visibility boundary gradients for the NEE term
    # (integrators/boundary.py): edge-sampling estimator injected as a
    # zero-primal term, so forward images are bit-unchanged while
    # jax.grad sees the edge integral the detached estimator misses
    # (the r4-measured 253% shadow-edge bias).  Costs
    # 2*boundary_samples extra shadow batches per bounce; off by
    # default.  Meaningful only together with geom_grads.
    boundary_grads: bool = False
    boundary_samples: int = 4
    # Wavefront mode (integrators/wavefront.py): host-level bounce loop
    # with live-ray compaction.  None = auto (on for BVH-scale scenes in
    # plain forward renders; the differentiable/sharded/adaptive paths
    # keep the in-device scan).  Estimator-identical to scan mode.
    wavefront: Optional[bool] = None
    # Rematerialized backward (SURVEY §5 "recompute/checkpointed
    # backward"): checkpoint the bounce body saving ONLY the traversal
    # results (hit ids/t/barycentrics + occlusion bits), so reverse-mode
    # recomputes shading per bounce instead of holding every
    # intermediate, and never re-traverses the BVH.  Identity for
    # forward-only renders.
    remat: bool = True
