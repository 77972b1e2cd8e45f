"""Elastic multi-process rendering: failure detection + checkpoint
recovery (SURVEY.md §5 "failure detection / elastic recovery" — the
reference has none; its asset-load failures exit or fall back,
GEMLoader.h:335-338, Imaging.h:24-31).

The film is the natural unit of recovery (it is already the resumable
accumulator, reference Imaging.h:253-261): each worker process renders
its own spp shard with an independent RNG stream, checkpointing the
film every sample.  The supervisor polls worker liveness; a worker that
dies — crash, OOM, preemption, kill — is respawned and resumes from its
last film checkpoint, re-rendering only the samples after it.  Because
every sample is keyed by (seed, spp index, pixel), the recovered run is
bit-identical to an uninterrupted one; the final reduce is a plain film
sum (buffer + spp) over workers, the cross-host psum's file-level twin.

Workers are plain CLI invocations (cli.py), so the recovery story
covers the real entry point, not a test fixture.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, List, Optional

import numpy as np

from ..imaging import film as film_mod
from ..utils.checkpoint import load_film
from ..utils.log import get_logger

_log = get_logger("elastic")


def _ckpt_spp(path: str) -> int:
    f = load_film(path)
    return int(f.spp) if f is not None else 0


def _spawn(scene: str, out_dir: str, worker: int, target_spp: int,
           seed: int, extra_args: List[str]) -> Optional[subprocess.Popen]:
    ck = os.path.join(out_dir, f"worker{worker}.npz")
    remaining = target_spp - _ckpt_spp(ck)
    if remaining <= 0:
        return None
    cmd = [sys.executable, "-m", "raytracingrenderer_tpu.cli",
           "-scene", scene,
           "-outputFilename", os.path.join(out_dir, f"w{worker}.hdr"),
           "-SPP", str(remaining),
           "-checkpoint", ck, "-checkpointEvery", "1",
           "-seed", str(seed + worker)] + list(extra_args)
    env = dict(os.environ)
    if _gpu_count():
        # one process per card: a JAX process reserves most of the
        # memory of every card it sees
        env["CUDA_VISIBLE_DEVICES"] = str(worker)
    # workers share the CLI's compile cache (utils/compile_cache.py), so
    # a respawned worker re-jits nothing
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=os.path.dirname(os.path.dirname(
                                os.path.dirname(os.path.abspath(__file__)))))


def _gpu_count() -> int:
    """Cards the workers can be spread over (0 on a CPU-only run).

    Asks nvidia-smi, not JAX: the supervisor must not open a card
    itself."""
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        return 0
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(line.startswith("GPU ") for line in out.splitlines())


def render_elastic(scene: str, out_dir: str, n_workers: int,
                   spp_per_worker: int, seed: int = 0,
                   extra_args: Optional[List[str]] = None,
                   on_poll: Optional[Callable] = None,
                   poll_s: float = 0.5,
                   max_restarts: int = 8) -> film_mod.Film:
    """Render `spp_per_worker` samples on each of `n_workers` processes,
    restarting any worker that dies from its film checkpoint; returns
    the reduced film (sum of buffers, sum of spp).

    `on_poll(procs)` runs every poll (the test's fault injector kills a
    live worker through it).  A worker is declared failed when its
    process exits nonzero OR disappears before its checkpoint reaches
    the target; each failure consumes one of `max_restarts`.
    """
    gpus = _gpu_count()
    if gpus and n_workers > gpus:
        raise ValueError(f"{n_workers} workers but {gpus} cards: each "
                         "worker needs a card of its own")
    os.makedirs(out_dir, exist_ok=True)
    extra_args = extra_args or []
    procs = {}
    restarts = 0
    for w in range(n_workers):
        procs[w] = _spawn(scene, out_dir, w, spp_per_worker, seed,
                          extra_args)

    while True:
        if on_poll is not None:
            on_poll(procs)
        busy = False
        for w in range(n_workers):
            p = procs.get(w)
            if p is None:
                continue
            rc = p.poll()
            if rc is None:
                busy = True
                continue
            done = _ckpt_spp(os.path.join(out_dir, f"worker{w}.npz"))
            if rc == 0 and done >= spp_per_worker:
                procs[w] = None
                continue
            # failure: crashed or exited short of the target
            restarts += 1
            _log.warning("worker %d died (rc=%s, %d/%d spp) — "
                         "respawning from checkpoint", w, rc, done,
                         spp_per_worker)
            if restarts > max_restarts:
                raise RuntimeError(
                    f"worker {w} exceeded {max_restarts} restarts")
            procs[w] = _spawn(scene, out_dir, w, spp_per_worker, seed,
                              extra_args)
            busy = busy or procs[w] is not None
        if not busy and all(p is None for p in procs.values()):
            break
        time.sleep(poll_s)

    films = [load_film(os.path.join(out_dir, f"worker{w}.npz"))
             for w in range(n_workers)]
    assert all(f is not None for f in films)
    buf = np.sum([np.asarray(f.buffer) for f in films], axis=0)
    spp = float(sum(float(f.spp) for f in films))
    return film_mod.Film(buffer=buf, spp=spp)
