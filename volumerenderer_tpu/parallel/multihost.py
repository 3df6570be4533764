"""Multi-host runtime — the communication-backend layer the reference never
had (single process; SURVEY.md §5 "Distributed communication backend").

Shape: ``jax.distributed.initialize`` per host joins the distributed
runtime; one global mesh spans all hosts; XLA collectives (psum/all_gather/
ppermute) go to NCCL between GPUs (NVLink within a host, the network across
hosts) — there is no MPI layer to manage.  This module wraps initialization, global mesh
construction, per-host brick I/O (each host reads only the bricks backing its
volume shards), and the scaling-efficiency harness for the >=80% @ N>=2 hosts
north star (BASELINE.json).

Single-host processes (including the CI CPU mesh) pass through unchanged, so
every code path here is exercised by the test suite; true multi-host runs just
add ``initialize()`` at startup.
"""
from __future__ import annotations

import time

import jax

import numpy as np
from jax.sharding import Mesh

from ..io.bricks import BrickGrid

__all__ = ["initialize", "global_mesh", "host_local_bricks", "load_bricks_for_host",
           "measure_scaling_efficiency"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the distributed runtime (no-op for single-process runs).

    Pass the coordinator address (``host:port``), the process count and
    this process's id; nothing detects them."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address, num_processes, process_id)


def global_mesh(axis_names=("dp", "rays"), shape=None) -> Mesh:
    """One mesh over every device of every host.  Default: all data parallel
    on the first axis."""
    devices = np.asarray(jax.devices())
    if shape is None:
        shape = (1, devices.size) if len(axis_names) == 2 else (devices.size,)
    return Mesh(devices.reshape(shape), axis_names=axis_names)


def host_local_bricks(grid: BrickGrid, z_shards: int) -> list[int]:
    """Brick numbers whose z-range intersects this process's volume shards
    (per-host I/O: each host reads only its slice of the brick files)."""
    I, J, Kb = grid.grid
    pid = jax.process_index()
    nproc = max(jax.process_count(), 1)
    # contiguous k-layers per process
    per = -(-Kb // nproc)
    k_lo, k_hi = pid * per, min(Kb, (pid + 1) * per)
    return [b for b in range(grid.num_bricks())
            if k_lo <= grid.brick_coords(b)[2] < k_hi]


def load_bricks_for_host(source, grid: BrickGrid, timestep: int):
    """Assemble only this host's k-layer slab (shape (Kslab*bz, J*by, I*bx))."""
    bricks = host_local_bricks(grid, jax.process_count())
    if not bricks:
        return None
    bx, by, bz = grid.brick_dims
    I, J, Kb = grid.grid
    ks = sorted({grid.brick_coords(b)[2] for b in bricks})
    out = np.zeros((len(ks) * bz, J * by, I * bx), dtype=np.uint8)
    k_base = ks[0]
    for b in bricks:
        i, j, k = grid.brick_coords(b)
        out[(k - k_base) * bz:(k - k_base + 1) * bz,
            j * by:(j + 1) * by, i * bx:(i + 1) * bx] = source(b, timestep)
    return out


def measure_scaling_efficiency(render_fn, mesh_sizes, *args, reps: int = 3):
    """Throughput-per-device ratio across mesh sizes.

    ``render_fn(n_devices, *args)`` must render once and force completion
    (return a host scalar).  Returns {n: (seconds, efficiency_vs_smallest)}.
    """
    results = {}
    base = None
    for n in mesh_sizes:
        render_fn(n, *args)  # warmup/compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            render_fn(n, *args)
            ts.append(time.perf_counter() - t0)
        dt = min(ts)
        per_dev = dt * n
        if base is None:
            base = per_dev
        results[n] = (dt, base / per_dev)
    return results
