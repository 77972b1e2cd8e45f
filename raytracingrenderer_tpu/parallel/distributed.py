"""Multi-host initialization + pod-scale mesh construction.

The reference is strictly single-process shared-memory (SURVEY.md §2.11);
this module is the framework's communication-backend layer: jax.distributed
process bootstrap, a (hosts x devices) mesh whose collectives stay on the
host's interconnect (NVLink between the cards of one host) and cross the
network only between hosts, and helpers for the two reductions the
renderer needs — film partial sums (light tracing / adaptive stats) and
parameter gradients (differentiable rendering).

Single-host runs (including the CPU test mesh) skip initialization and
use the local-device mesh, so all call sites are topology-agnostic.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from ..utils.log import get_logger

_log = get_logger("dist")
RAY_AXIS = "rays"
HOST_AXIS = "hosts"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize multi-process JAX (no-op for single-process runs).

    Under a cluster manager JAX recognises (SLURM, Open MPI, ...), bare
    jax.distributed.initialize() autodetects everything; elsewhere pass
    the coordinator address ("host:port"), process count and id.
    """
    if jax.process_count() > 1:
        return  # already initialized
    if coordinator is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except Exception as e:  # single-process / no cluster env
            _log.debug("single-process mode (%s)", e)
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def pod_mesh(devices=None) -> Mesh:
    """1-D ray mesh over every device of every host.

    Rays are embarrassingly parallel, so a flat axis maximizes the
    shard count; the (hosts, chips) 2-D form only matters when an op
    needs host-local collectives — use `host_chip_mesh` then.
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (RAY_AXIS,))


def host_chip_mesh(devices=None) -> Mesh:
    """(hosts, devices_per_host) mesh: axis 0 crosses the network
    between hosts, axis 1 stays within one host."""
    devs = list(devices if devices is not None else jax.devices())
    n_proc = max(jax.process_count(), 1)
    per_host = len(devs) // n_proc
    grid = np.asarray(devs).reshape(n_proc, per_host)
    return Mesh(grid, (HOST_AXIS, RAY_AXIS))
