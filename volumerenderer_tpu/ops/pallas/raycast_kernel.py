"""Compositing march as a Pallas kernel compiled through Triton (GPU).

Same semantics as ``ops.raycast.composite_march`` (``raycaster.frag:18-86``),
shaped the way the reference's fragment shader runs on a GPU: one program
per (TILE_H, TILE_W) image tile, each ray's state held in registers, and a
``while_loop`` of at most ``max_samples`` steps that ends as soon as every
ray of *its tile* has left the cube or saturated.  XLA's jnp march, by
contrast, writes the whole frame's ray state to device memory at every step
and stops only when every ray of the frame is done.

* The 8 trilinear taps are gathers from the float32 volume ref with
  integer-array indexing; rays that are no longer alive issue no loads
  (masked).  The lowering computes 64-bit offsets once the volume exceeds
  2^32 bytes, so volumes of 2^31 voxels and more index correctly.  (uint8
  storage, a quarter of the bytes, measured no faster on an H100; see
  PERF.md.)
* Tiles that overhang the image edge clamp their pixel indices to the edge:
  the extra lanes march a copy of an edge ray and store the same value to
  the same pixel, so every image shape and camera runs the kernel.

``interpret=True`` runs the kernel through the Pallas interpreter on any
backend; tests use it, product paths never do.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..raycast import (ALPHA_SCALE, EARLY_OUT_ALPHA, MAX_SAMPLES,
                       apply_reference_transfer)

__all__ = ["composite_march_triton", "render_compositing_triton",
           "TILE_H", "TILE_W", "NUM_WARPS"]

# Launch shape: tiles from 8×8 (2 warps) to 32×16 (8 warps) measured within
# noise of each other on an H100 (PERF.md).
TILE_H = 16
TILE_W = 16
NUM_WARPS = 4


def _wrap_index(i, n: int, wrap: str):
    if wrap == "clamp":
        return jnp.minimum(jnp.maximum(i, 0), n - 1)
    # repeat: coordinates were wrapped into [0, 1), so i is in [-1, n]
    i = jnp.where(i < 0, i + n, i)
    return jnp.where(i >= n, i - n, i)


def _march_kernel(entry_ref, dir_ref, hit_ref, vol_ref, color_ref, alpha_ref,
                  *, max_samples: int, wrap: str):
    H, W = hit_ref.shape
    Z, Y, X = vol_ref.shape
    th, tw = TILE_H, TILE_W
    row = pl.program_id(0) * th + jax.lax.broadcasted_iota(jnp.int32,
                                                           (th, tw), 0)
    col = pl.program_id(1) * tw + jax.lax.broadcasted_iota(jnp.int32,
                                                           (th, tw), 1)
    row = jnp.minimum(row, H - 1)
    col = jnp.minimum(col, W - 1)

    # dir_step = direction * (1/X, 1/Y, 1/Z) in float32, as the jnp march
    inv = [np.float32(1.0 / X), np.float32(1.0 / Y), np.float32(1.0 / Z)]
    pos0 = tuple(entry_ref[row, col, a] for a in range(3))
    step = tuple(dir_ref[row, col, a] * inv[a] for a in range(3))
    alive0 = hit_ref[row, col]
    dims = (np.float32(X), np.float32(Y), np.float32(Z))

    def tap(z, y, x, live):
        return plgpu.load(vol_ref.at[z, y, x], mask=live, other=0.0)

    def sample(pos, live):
        idx0, idx1, frac = [], [], []
        for a in range(3):
            p = pos[a]
            if wrap == "repeat":
                p = p - jnp.floor(p)
            t = p * dims[a] - 0.5
            i0f = jnp.floor(t)
            frac.append(t - i0f)
            i0 = i0f.astype(jnp.int32)
            n = (X, Y, Z)[a]
            idx0.append(_wrap_index(i0, n, wrap))
            idx1.append(_wrap_index(i0 + 1, n, wrap))
        (x0, y0, z0), (x1, y1, z1) = idx0, idx1
        fx, fy, fz = frac
        c000 = tap(z0, y0, x0, live)
        c100 = tap(z0, y0, x1, live)
        c010 = tap(z0, y1, x0, live)
        c110 = tap(z0, y1, x1, live)
        c001 = tap(z1, y0, x0, live)
        c101 = tap(z1, y0, x1, live)
        c011 = tap(z1, y1, x0, live)
        c111 = tap(z1, y1, x1, live)
        c00 = c000 + (c100 - c000) * fx
        c10 = c010 + (c110 - c010) * fx
        c01 = c001 + (c101 - c001) * fx
        c11 = c011 + (c111 - c011) * fx
        c0 = c00 + (c10 - c00) * fy
        c1 = c01 + (c11 - c01) * fy
        return c0 + (c1 - c0) * fz

    def cond(state):
        i, _, _, _, _, _, alive = state
        return (i < max_samples) & (jnp.max(alive.astype(jnp.int32)) > 0)

    def body(state):
        i, px, py, pz, color, alpha, alive = state
        px, py, pz = px + step[0], py + step[1], pz + step[2]
        inside = ((px > 0.0) & (px < 1.0) & (py > 0.0) & (py < 1.0)
                  & (pz > 0.0) & (pz < 1.0))
        alive = alive & inside
        s = sample((px, py, pz), alive)
        prev_alpha = s - s * alpha
        color = jnp.where(alive, color + prev_alpha * s, color)
        alpha = jnp.where(alive, alpha + prev_alpha * ALPHA_SCALE, alpha)
        alive = alive & (alpha <= EARLY_OUT_ALPHA)
        return i + 1, px, py, pz, color, alpha, alive

    zeros = jnp.zeros((th, tw), jnp.float32)
    _, _, _, _, color, alpha, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), *pos0, zeros, zeros, alive0))
    color_ref[row, col] = color
    alpha_ref[row, col] = alpha


@partial(jax.jit, static_argnames=("max_samples", "wrap", "interpret"))
def composite_march_triton(volume, entry_uv, direction, hit,
                           max_samples: int = MAX_SAMPLES,
                           wrap: str = "clamp", interpret: bool = False):
    """(color, alpha) like ``ops.raycast.composite_march``.  ``volume`` is
    (Z, Y, X) in [0, 1] (marched as float32); ray arrays have any leading
    shape, marched as a 2-D image of their last axis."""
    if wrap not in ("clamp", "repeat"):
        raise ValueError(f"unknown wrap mode: {wrap}")
    volume = volume.astype(jnp.float32)
    shape = hit.shape
    W = shape[-1] if shape else 1
    H = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    entry = entry_uv.reshape(H, W, 3).astype(jnp.float32)
    dirs = direction.reshape(H, W, 3).astype(jnp.float32)
    hit2 = hit.reshape(H, W).astype(bool)
    out = jax.ShapeDtypeStruct((H, W), jnp.float32)
    color, alpha = pl.pallas_call(
        partial(_march_kernel, max_samples=max_samples, wrap=wrap),
        out_shape=(out, out),
        grid=(pl.cdiv(H, TILE_H), pl.cdiv(W, TILE_W)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="composite_march_triton",
    )(entry, dirs, hit2, volume)
    return color.reshape(shape), alpha.reshape(shape)


@partial(jax.jit, static_argnames=("max_samples", "wrap"))
def render_compositing_triton(volume, entry_uv, direction, hit,
                              max_samples: int = MAX_SAMPLES,
                              wrap: str = "clamp"):
    """``ops.raycast.render_compositing`` through the Triton march: returns
    (rgb (..., 3), alpha (...))."""
    color, alpha = composite_march_triton(volume, entry_uv, direction, hit,
                                          max_samples, wrap)
    return apply_reference_transfer(color, alpha), alpha
