"""Brick-sharded HBM rendering — the renderer's "TP" (SURVEY.md §2
"Volume/brick sharding"; BASELINE config 5 "brick-sharded across hosts").
The volume lives sharded over a 3-D device mesh ("bz", "by", "bx"):
each device holds one brick of the global (Z, Y, X) array in its HBM — the
device-mesh form of the reference's brick-grid decomposition
(``main.cpp:78-79,599-619``), where bricks tiled host RAM instead.

Rendering: every device marches the full ray set over ALL steps but samples
only where the trilinear footprint's anchor cell lies in its brick; a
one-voxel halo on each + face (exchanged via axis-wise ``ppermute`` rings,
corners composed automatically by exchanging already-extended slabs; true
volume edges clamp to the device's own last plane — GL clamp-to-edge) makes
each owned sample exactly the global trilinear value.  A ray crosses each
brick's anchor box in one contiguous step interval (convex box), so each
device's owned samples form one SEGMENT of the compositing recurrence; the
affine segment maps (C_seg, T_seg) — see ``parallel/context.py`` — compose
per ray in brick-entry order, recovered by sorting segments on each ray's
first owned step index.

Exactness: equals the single-device march *without* per-ray early
termination (as in the z-sharded path); deterministic and
shard-count-invariant.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.raycast import ALPHA_SCALE, apply_reference_transfer
from ..io.bricks import BrickGrid

__all__ = ["make_brick_mesh", "render_bricksharded",
           "composite_segments_ordered", "shard_volume",
           "host_local_bricks_3d"]

BIG_T = 1.0e9  # "never sampled" sentinel for t_first


def make_brick_mesh(shape=(2, 2, 2), devices=None) -> Mesh:
    """3-D mesh with axes ("bz", "by", "bx") over the first prod(shape)
    devices."""
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(shape))
    return Mesh(np.asarray(devices[:n]).reshape(shape),
                axis_names=("bz", "by", "bx"))


def shard_volume(mesh: Mesh, volume):
    """Place a (Z, Y, X) volume brick-sharded over the mesh's HBM."""
    return jax.device_put(
        volume, NamedSharding(mesh, P("bz", "by", "bx")))


def host_local_bricks_3d(grid: BrickGrid, mesh_shape,
                         shard_index) -> list[int]:
    """Brick file numbers intersecting one mesh shard's sub-volume — per-host
    brick I/O for the brick-sharded layout (each host reads only the files
    backing the shards it will donate to the global array).

    ``mesh_shape`` = (nbz, nby, nbx); ``shard_index`` = (iz, iy, ix)."""
    bx, by, bz = grid.brick_dims
    I, J, Kb = grid.grid
    X, Y, Z = I * bx, J * by, Kb * bz
    nbz, nby, nbx = mesh_shape
    iz, iy, ix = shard_index
    assert Z % nbz == 0 and Y % nby == 0 and X % nbx == 0
    z_lo, z_hi = iz * Z // nbz, (iz + 1) * Z // nbz
    y_lo, y_hi = iy * Y // nby, (iy + 1) * Y // nby
    x_lo, x_hi = ix * X // nbx, (ix + 1) * X // nbx
    out = []
    for b in range(grid.num_bricks()):
        i, j, k = grid.brick_coords(b)
        if (k * bz < z_hi and (k + 1) * bz > z_lo
                and j * by < y_hi and (j + 1) * by > y_lo
                and i * bx < x_hi and (i + 1) * bx > x_lo):
            out.append(b)
    return out


def _extend_axis(slab, axis_name: str, n: int, axis: int):
    """Append one halo plane along ``axis``: the next shard's first plane via
    a ppermute ring; the last shard clamps with its own last plane (global
    GL clamp-to-edge at the true volume face).  Exchanging slabs already
    extended along other axes carries edge/corner halos automatically.  An
    unsharded axis (``n == 1``) gets no copy: the globally clamped +1 index
    never passes its last plane."""
    if n == 1:
        return slab
    S = slab.shape[axis]
    first = jax.lax.slice_in_dim(slab, 0, 1, axis=axis)
    last = jax.lax.slice_in_dim(slab, S - 1, S, axis=axis)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i - 1) % n) for i in range(n)]
    halo = jax.lax.ppermute(first, axis_name, perm)
    halo = jnp.where(idx == n - 1, last, halo)
    return jnp.concatenate([slab, halo], axis=axis)


def _sample_local3(ext, pos, lo, owned_shape, dims):
    """Trilinear sample from a halo-extended brick; ``owned`` marks positions
    whose anchor cell (clamped global floor index) lies in this brick."""
    X, Y, Z = dims
    Sz, Sy, Sx = owned_shape
    lz, ly, lx = lo
    tx = pos[..., 0] * X - 0.5
    ty = pos[..., 1] * Y - 0.5
    tz = pos[..., 2] * Z - 0.5
    x0f, y0f, z0f = jnp.floor(tx), jnp.floor(ty), jnp.floor(tz)
    fx, fy, fz = tx - x0f, ty - y0f, tz - z0f

    x0 = jnp.clip(x0f.astype(jnp.int32), 0, X - 1)
    x1 = jnp.clip(x0f.astype(jnp.int32) + 1, 0, X - 1)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, Y - 1)
    y1 = jnp.clip(y0f.astype(jnp.int32) + 1, 0, Y - 1)
    z0 = jnp.clip(z0f.astype(jnp.int32), 0, Z - 1)
    z1 = jnp.clip(z0f.astype(jnp.int32) + 1, 0, Z - 1)

    owned = ((z0 >= lz) & (z0 < lz + Sz) & (y0 >= ly) & (y0 < ly + Sy)
             & (x0 >= lx) & (x0 < lx + Sx))
    z0l = jnp.clip(z0 - lz, 0, Sz)
    z1l = jnp.clip(z1 - lz, 0, Sz)
    y0l = jnp.clip(y0 - ly, 0, Sy)
    y1l = jnp.clip(y1 - ly, 0, Sy)
    x0l = jnp.clip(x0 - lx, 0, Sx)
    x1l = jnp.clip(x1 - lx, 0, Sx)

    def V(zi, yi, xi):
        return ext[zi, yi, xi]

    c00 = V(z0l, y0l, x0l) + (V(z0l, y0l, x1l) - V(z0l, y0l, x0l)) * fx
    c10 = V(z0l, y1l, x0l) + (V(z0l, y1l, x1l) - V(z0l, y1l, x0l)) * fx
    c01 = V(z1l, y0l, x0l) + (V(z1l, y0l, x1l) - V(z1l, y0l, x0l)) * fx
    c11 = V(z1l, y1l, x0l) + (V(z1l, y1l, x1l) - V(z1l, y1l, x0l)) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz, owned


def composite_segments_ordered(C_all, T_all, t_first):
    """Fold (N, ...) segment maps per ray in traversal order (ascending
    ``t_first``; never-sampled segments carry BIG_T and are identity maps, so
    their position is irrelevant)."""
    order = jnp.argsort(t_first, axis=0)
    Cs = jnp.take_along_axis(C_all, order, axis=0)
    Ts = jnp.take_along_axis(T_all, order, axis=0)

    def body(i, state):
        c, tau = state
        return c + tau * Cs[i], tau * Ts[i]

    c, tau = jax.lax.fori_loop(
        0, C_all.shape[0], body,
        (jnp.zeros_like(C_all[0]), jnp.ones_like(T_all[0])))
    return c, 1.0 - tau


def render_bricksharded(mesh: Mesh, volume, entry_uv, direction, hit,
                        max_samples: int = 300):
    """Render with the volume brick-sharded over ``mesh`` axes
    ("bz", "by", "bx").  ``volume`` may be a global array or one already
    placed by :func:`shard_volume`.  Returns (rgb, alpha) equal to the
    unsharded jnp renderer without early termination."""
    Z, Y, X = volume.shape
    nbz, nby, nbx = mesh.shape["bz"], mesh.shape["by"], mesh.shape["bx"]
    assert Z % nbz == 0 and Y % nby == 0 and X % nbx == 0
    dims = (X, Y, Z)
    Sz, Sy, Sx = Z // nbz, Y // nby, X // nbx

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P("bz", "by", "bx"), P(), P(), P()),
        out_specs=(P(("bz", "by", "bx")),) * 3,
        check_vma=False,
    )
    def _march(brick, entry_uv, direction, hit):
        ext = _extend_axis(brick, "bz", nbz, 0)
        ext = _extend_axis(ext, "by", nby, 1)
        ext = _extend_axis(ext, "bx", nbx, 2)
        lo = (jax.lax.axis_index("bz") * Sz, jax.lax.axis_index("by") * Sy,
              jax.lax.axis_index("bx") * Sx)
        step = direction * jnp.array([1.0 / X, 1.0 / Y, 1.0 / Z], jnp.float32)
        shape = entry_uv.shape[:-1]

        def body(t, state):
            C, T, tf = state
            pos = entry_uv + (t + 1.0) * step
            inside = jnp.all((pos > 0.0) & (pos < 1.0), axis=-1)
            s, owned = _sample_local3(ext, pos, lo, (Sz, Sy, Sx), dims)
            m = hit & inside & owned
            C = jnp.where(m, C + T * s * s, C)
            T = jnp.where(m, T * (1.0 - ALPHA_SCALE * s), T)
            tf = jnp.where(m, jnp.minimum(tf, t), tf)
            return C, T, tf

        init = (jnp.zeros(shape, jnp.float32), jnp.ones(shape, jnp.float32),
                jnp.full(shape, BIG_T, jnp.float32))
        C, T, tf = jax.lax.fori_loop(
            0, max_samples, lambda t, st: body(jnp.float32(t), st), init)
        return C[None], T[None], tf[None]

    C_all, T_all, tf_all = _march(volume, entry_uv, direction, hit)
    color, alpha = composite_segments_ordered(C_all, T_all, tf_all)
    return apply_reference_transfer(color, alpha), alpha
