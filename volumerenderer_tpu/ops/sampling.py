"""Trilinear volume sampling with OpenGL texture semantics.

Replicates GLSL ``texture(volume, uvw).r`` on a ``GL_RED / GL_UNSIGNED_BYTE`` 3D
texture with ``GL_LINEAR`` filtering (``VolumeReader.h:123-127``): normalized
coordinates in [0,1], texel centers at ``(i + 0.5) / N``, and byte values
normalized by 255.

Wrap mode: the reference *requests* ``GL_CLAMP`` (``VolumeReader.h:120-122``) but
in a 3.3 core profile that enum is invalid, so the driver leaves the default
``GL_REPEAT`` in place.  We default to the intended ``"clamp"`` (clamp-to-edge)
and offer ``"repeat"`` for strict parity with the actual GL behavior; samples are
only taken strictly inside (0,1) (``raycaster.frag:53``) so the two differ only
within half a texel of the faces.

The volume array is indexed ``[z, y, x]`` (C-order match of the reference's
``x + X*y + X*Y*z`` flat layout, ``VolumeKdTree_recover.cpp:4-6``).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["sample_trilinear", "as_normalized_volume",
           "pack_neighborhoods", "sample_trilinear_packed",
           "ShadePool", "build_shade_pool", "sample_trilinear_pooled",
           "sample_pooled"]


def as_normalized_volume(volume) -> jnp.ndarray:
    """uint8 volume (Z, Y, X) -> float32 normalized to [0, 1]."""
    v = jnp.asarray(volume)
    if v.dtype == jnp.uint8:
        v = v.astype(jnp.float32) * (1.0 / 255.0)
    return v.astype(jnp.float32)


def _wrap_index(i, n, mode: str):
    if mode == "clamp":
        return jnp.clip(i, 0, n - 1)
    elif mode == "repeat":
        return jnp.remainder(i, n)
    raise ValueError(f"unknown wrap mode: {mode}")


def sample_trilinear(volume: jnp.ndarray, uvw: jnp.ndarray, wrap: str = "clamp") -> jnp.ndarray:
    """Trilinearly sample ``volume`` (Z, Y, X) float32 at ``uvw`` (..., 3) in [0,1].

    ``uvw[..., 0]`` is x (fastest axis), matching GLSL's ``vec3`` ordering.
    Returns (...,) float32 samples.
    """
    Z, Y, X = volume.shape
    dims = jnp.array([X, Y, Z], dtype=jnp.float32)

    # GL_REPEAT wraps the *coordinate* before the texel math; GL_CLAMP_TO_EDGE
    # clamps the fetched indices.  For repeat, wrap uvw into [0,1) first.
    if wrap == "repeat":
        uvw = uvw - jnp.floor(uvw)

    t = uvw * dims - 0.5  # texel-space coordinate of the sample
    i0f = jnp.floor(t)
    frac = t - i0f
    i0 = i0f.astype(jnp.int32)
    i1 = i0 + 1

    x0 = _wrap_index(i0[..., 0], X, wrap)
    x1 = _wrap_index(i1[..., 0], X, wrap)
    y0 = _wrap_index(i0[..., 1], Y, wrap)
    y1 = _wrap_index(i1[..., 1], Y, wrap)
    z0 = _wrap_index(i0[..., 2], Z, wrap)
    z1 = _wrap_index(i1[..., 2], Z, wrap)

    fx = frac[..., 0]
    fy = frac[..., 1]
    fz = frac[..., 2]

    c000 = volume[z0, y0, x0]
    c100 = volume[z0, y0, x1]
    c010 = volume[z0, y1, x0]
    c110 = volume[z0, y1, x1]
    c001 = volume[z1, y0, x0]
    c101 = volume[z1, y0, x1]
    c011 = volume[z1, y1, x0]
    c111 = volume[z1, y1, x1]

    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def pack_neighborhoods(volume: jnp.ndarray) -> jnp.ndarray:
    """(Z, Y, X) float32 in [0, 1] -> (Z, Y, X, 2) uint32 holding all eight
    8-bit-quantized trilinear taps of the cell anchored at (z, y, x), with
    clamp-to-edge neighbors baked in.  Word 0 packs the z0 plane
    (c000 | c100<<8 | c010<<16 | c110<<24), word 1 the z1 plane.

    One (1, 1, 1, 2) gather then fetches a whole 2x2x2 neighborhood
    instead of eight scalar ones."""
    s = jnp.round(jnp.clip(volume, 0.0, 1.0) * 255.0).astype(jnp.uint32)

    def sh(a, dz, dy, dx):
        if dz:
            a = jnp.concatenate([a[1:], a[-1:]], axis=0)
        if dy:
            a = jnp.concatenate([a[:, 1:], a[:, -1:]], axis=1)
        if dx:
            a = jnp.concatenate([a[:, :, 1:], a[:, :, -1:]], axis=2)
        return a

    w0 = (s | (sh(s, 0, 0, 1) << 8) | (sh(s, 0, 1, 0) << 16)
          | (sh(s, 0, 1, 1) << 24))
    w1 = (sh(s, 1, 0, 0) | (sh(s, 1, 0, 1) << 8) | (sh(s, 1, 1, 0) << 16)
          | (sh(s, 1, 1, 1) << 24))
    return jnp.stack([w0, w1], axis=-1)


def sample_trilinear_packed(packed: jnp.ndarray, uvw: jnp.ndarray) -> jnp.ndarray:
    """``sample_trilinear`` (clamp wrap) against a ``pack_neighborhoods``
    volume: one gather per sample instead of eight.  Values are 8-bit
    quantized (exact for byte-derived volumes; the GL texture unit is 8-bit
    anyway).  Clamp-to-edge is reproduced by the clamped-floor index plus the
    clamped fractional (at a low edge the fractional becomes 0 and the packed
    cell self-pairs at high edges)."""
    Z, Y, X, _ = packed.shape
    dims = jnp.array([X, Y, Z], dtype=jnp.float32)
    t = uvw * dims - 0.5
    i0f = jnp.floor(t)
    i0c = jnp.clip(i0f, 0.0, dims - 1.0)
    f = jnp.clip(t, 0.0, dims - 1.0) - i0c
    idx = i0c.astype(jnp.int32)
    w = packed[idx[..., 2], idx[..., 1], idx[..., 0]]  # (..., 2)
    w0 = w[..., 0]
    w1 = w[..., 1]
    c000 = (w0 & 0xFF).astype(jnp.float32)
    c100 = ((w0 >> 8) & 0xFF).astype(jnp.float32)
    c010 = ((w0 >> 16) & 0xFF).astype(jnp.float32)
    c110 = ((w0 >> 24) & 0xFF).astype(jnp.float32)
    c001 = (w1 & 0xFF).astype(jnp.float32)
    c101 = ((w1 >> 8) & 0xFF).astype(jnp.float32)
    c011 = ((w1 >> 16) & 0xFF).astype(jnp.float32)
    c111 = ((w1 >> 24) & 0xFF).astype(jnp.float32)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return (c0 + (c1 - c0) * fz) * (1.0 / 255.0)


@partial(jax.tree_util.register_dataclass, data_fields=["pool", "slab_map"],
         meta_fields=["depth"])
@dataclasses.dataclass(frozen=True)
class ShadePool:
    """Sparse z-slab residency of the packed-neighborhood volume
    (:func:`build_shade_pool`).  ``pool`` is (n_slots, 8, Y, X, 2) uint32 —
    slot 0 all-zero, slot i >= 1 the ``pack_neighborhoods`` rows of one
    occupied 8-row z-slab — and ``slab_map`` (ceil(Z/8),) int32 maps
    z-block -> slot.  ``shape`` is the (Z, Y, X) of the volume it stands
    for, so the marches take it wherever they take a dense volume (with
    ``sample=sample_pooled``)."""

    pool: jax.Array
    slab_map: jax.Array
    depth: int

    @property
    def shape(self):
        return (self.depth, self.pool.shape[2], self.pool.shape[3])


def build_shade_pool(volume: jnp.ndarray, mip8=None) -> ShadePool:
    """Sparse z-slab residency for the packed-neighborhood volume.
    Neighborhood words bake the +1 taps in, so per-voxel slab indirection
    needs no overlap rows; a Z that is not a multiple of 8 pads the last
    slab with rows no sample reads (indices clamp to Z - 1).

    Zero-slot reads are exact, not approximate: an unoccupied slab has block
    max 0, so every tap a sample would fetch there is truly 0.  ``mip8``
    (e.g. ``codecs.device.tree_occupancy_mip8``) drives residency from
    compressed-tree metadata; ``None`` computes it from the volume."""
    import numpy as np

    Z, Y, X = volume.shape
    nb = -(-Z // 8)
    packed = pack_neighborhoods(volume)
    packed = jnp.pad(packed, ((0, 8 * nb - Z), (0, 0), (0, 0), (0, 0)))
    if mip8 is None:
        s = jnp.round(jnp.clip(volume, 0.0, 1.0) * 255.0)
        s = jnp.pad(s, ((0, 8 * nb - Z), (0, 0), (0, 0)))
        zocc = np.asarray(s.reshape(nb, 8, Y, X).max(axis=(1, 2, 3))) > 0.0
    else:
        zocc = (np.asarray(mip8) > 0.0).any(axis=(1, 2))[:nb]
    # the z1 plane of a cell in the slab's last row lives in the next slab's
    # first row, but pack_neighborhoods bakes it into this slab's words — so
    # occupancy must include slabs whose only content is a neighbor's z1 tap
    occ = zocc.copy()
    occ[:-1] |= zocc[1:]
    slots = np.zeros(nb, np.int32)
    slots[occ] = 1 + np.arange(int(occ.sum()), dtype=np.int32)
    rows = (8 * np.nonzero(occ)[0].astype(np.int32)[:, None]
            + np.arange(8, dtype=np.int32)[None])
    pool = jnp.concatenate(
        [jnp.zeros((1, 8, Y, X, 2), jnp.uint32),
         packed[rows.reshape(-1)].reshape(-1, 8, Y, X, 2)], axis=0)
    return ShadePool(pool, jnp.asarray(slots), Z)


def sample_pooled(state: ShadePool, uvw: jnp.ndarray,
                  wrap: str = "clamp") -> jnp.ndarray:
    """The marches' sampler over a :class:`ShadePool` (clamp wrap only)."""
    if wrap != "clamp":
        raise ValueError(f"the pooled sampler clamps; got wrap={wrap!r}")
    Z, Y, X = state.shape
    return sample_trilinear_pooled(state.pool, state.slab_map, (X, Y, Z), uvw)


def sample_trilinear_pooled(pool: jnp.ndarray, slab_map: jnp.ndarray,
                            dims, uvw: jnp.ndarray) -> jnp.ndarray:
    """``sample_trilinear_packed`` against a ``build_shade_pool`` sparse
    pool: one gather per sample, indirected through the z-slab map.  ``dims``
    is (X, Y, Z)."""
    X, Y, Z = dims
    fdims = jnp.array([X, Y, Z], dtype=jnp.float32)
    t = uvw * fdims - 0.5
    i0f = jnp.floor(t)
    i0c = jnp.clip(i0f, 0.0, fdims - 1.0)
    f = jnp.clip(t, 0.0, fdims - 1.0) - i0c
    idx = i0c.astype(jnp.int32)
    iz = idx[..., 2]
    w = pool[slab_map[iz >> 3], iz & 7, idx[..., 1], idx[..., 0]]  # (..., 2)
    w0 = w[..., 0]
    w1 = w[..., 1]
    c000 = (w0 & 0xFF).astype(jnp.float32)
    c100 = ((w0 >> 8) & 0xFF).astype(jnp.float32)
    c010 = ((w0 >> 16) & 0xFF).astype(jnp.float32)
    c110 = ((w0 >> 24) & 0xFF).astype(jnp.float32)
    c001 = (w1 & 0xFF).astype(jnp.float32)
    c101 = ((w1 >> 8) & 0xFF).astype(jnp.float32)
    c011 = ((w1 >> 16) & 0xFF).astype(jnp.float32)
    c111 = ((w1 >> 24) & 0xFF).astype(jnp.float32)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return (c0 + (c1 - c0) * fz) * (1.0 / 255.0)
