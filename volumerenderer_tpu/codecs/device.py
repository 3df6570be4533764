"""Device-resident compressed tree + jit level-cut decode.

The device-side replacement for the reference's (stubbed) in-shader compressed
traversal (``isosurface_compressed.frag:18-44``, SSBO upload paths commented at
``main.cpp:203-237``): the 2-bit code stream lives on device in packed uint8
words, and a level cut decodes with vectorized shift/mask unpacking plus a
level-by-level clamped-Δ accumulation — O(2·leaves) fused elementwise work, no
sequential stack machine (SURVEY.md §7 "Decode").

The decoded dense volume feeds the ray-march kernels directly (the compressed-
render path: decode + render both on device, HBM-to-HBM).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.bitarray import pack2_np, unpack2
from .kdtree import KdTree, NO_NODE, _leaf_axes_perm

__all__ = ["DeviceKdTree", "to_device", "level_cut_device",
           "tree_occupancy_mip8", "block_max8"]


class DeviceKdTree(NamedTuple):
    """Compressed tree as device arrays (pytree).  Static structure (depths,
    dims, schedule) travels alongside as aux data in ``to_device``'s closure —
    the decode jit is specialized per tree shape."""

    packed_levels: tuple  # level d -> uint8[ceil(2^d/4)] packed codes
    packed_chains: jnp.ndarray  # uint8 (num_leaves, ceil(chain_len/4))
    distance_map: jnp.ndarray   # int32 (max_depth+1,)


def to_device(tree: KdTree) -> tuple[DeviceKdTree, dict]:
    """Upload a host tree; returns (device pytree, static spec for the decoder)."""
    packed_levels = tuple(
        jnp.asarray(pack2_np(codes)) for codes in tree.level_codes
    )
    chains = tree.chain_codes
    if chains is None:
        chains = np.full((tree.num_leaves, 8), NO_NODE, dtype=np.uint8)
    # NO_NODE (255) packs to code 3 — decode treats 3 as terminal, so padding
    # with 3 is safe and lets chains pack 4 codes/byte like everything else.
    chains_p = np.where(chains == NO_NODE, 3, chains).astype(np.uint8)
    pad = (-chains_p.shape[1]) % 4
    if pad:
        chains_p = np.pad(chains_p, ((0, 0), (0, pad)), constant_values=3)
    packed_chains = jnp.asarray(_pack_rows(chains_p))
    dtree = DeviceKdTree(
        packed_levels=packed_levels,
        packed_chains=packed_chains,
        distance_map=jnp.asarray(tree.distance_map.astype(np.int32)),
    )
    spec = dict(
        dims=tree.dims, orig_depth=tree.orig_depth, max_depth=tree.max_depth,
        schedule=tuple(tree.schedule), chain_len=chains_p.shape[1],
    )
    return dtree, spec


def _pack_rows(rows: np.ndarray) -> np.ndarray:
    """Vectorized row-wise 2-bit pack."""
    n, m = rows.shape
    quads = (rows & 3).reshape(n, m // 4, 4)
    return (quads[..., 0] | (quads[..., 1] << 2) | (quads[..., 2] << 4)
            | (quads[..., 3] << 6)).astype(np.uint8)


def _decode_leaf_scalars(dtree: DeviceKdTree, spec_key, cut_depth: int):
    """Level-synchronous decode to flat per-leaf scalars (int32, breadth-
    first leaf order, length 2^orig_depth) — shared by the volume decode and
    the tree-metadata occupancy grid."""
    dims, orig_depth, max_depth, schedule, chain_len = spec_key
    dm = dtree.distance_map

    def step(scalars, frozen, codes, d):
        s = jnp.where(codes == 1, jnp.minimum(255, scalars + dm[d]),
                      jnp.where(codes == 2, jnp.maximum(0, scalars - dm[d]), scalars))
        new_scalars = jnp.where(frozen, scalars, s)
        new_frozen = frozen | (codes == 3)
        return new_scalars, new_frozen

    root_codes = unpack2(dtree.packed_levels[0])[:1].astype(jnp.int32)
    scalars = jnp.full((1,), dm[0], dtype=jnp.int32)
    frozen = root_codes == 3

    for d in range(1, orig_depth + 1):
        scalars = jnp.repeat(scalars, 2)
        frozen = jnp.repeat(frozen, 2)
        if d > cut_depth:
            continue
        codes = unpack2(dtree.packed_levels[d])[: 1 << d].astype(jnp.int32)
        scalars, frozen = step(scalars, frozen, codes, d)

    if cut_depth > orig_depth:
        chain_codes = unpack2(dtree.packed_chains).astype(jnp.int32)
        for i in range(min(chain_len, cut_depth - orig_depth)):
            d = orig_depth + 1 + i
            scalars, frozen = step(scalars, frozen, chain_codes[:, i], d)
    return scalars


@partial(jax.jit, static_argnames=("spec_key", "cut_depth"))
def _level_cut_impl(dtree: DeviceKdTree, spec_key, cut_depth: int):
    dims, orig_depth, max_depth, schedule, chain_len = spec_key
    scalars = _decode_leaf_scalars(dtree, spec_key, cut_depth)

    # leaves -> volume: inverse of the breadth-first leaf permutation
    X, Y, Z = dims
    perm, (nz, ny, nx) = _leaf_axes_perm(X, Y, Z, list(schedule))
    inv = np.argsort(perm)
    vol = scalars.astype(jnp.uint8).reshape((2,) * (nz + ny + nx)).transpose(inv)
    return vol.reshape(Z, Y, X)


# deep trees: the flat decode's per-level buffers (and the per-leaf chain
# unpack) scale with 2^orig_depth and blew the compiler's HLO-temp budget at
# the tolerance-1 256³ tree (>51 GB).  The
# chunked decode below bounds every buffer by 2^(orig_depth - K): leaves are
# decoded per depth-K subtree (a CONTIGUOUS slice of every deeper level's
# code stream, and a contiguous box of the output volume since the first K
# splits fix the top bits of each coordinate), sequentially via lax.map.
CHUNKED_DECODE_MIN_DEPTH = 21   # use the flat decode below this
CHUNK_LEAF_BITS = 16            # per-chunk leaf-array size target (2^bits)


@partial(jax.jit, static_argnames=("spec_key", "cut_depth", "K"))
def _level_cut_chunked_impl(dtree: DeviceKdTree, spec_key, cut_depth: int,
                            K: int):
    dims, orig_depth, max_depth, schedule, chain_len = spec_key
    X, Y, Z = dims
    sched = list(schedule)
    dm = dtree.distance_map

    def step(scalars, frozen, codes, d):
        s = jnp.where(codes == 1, jnp.minimum(255, scalars + dm[d]),
                      jnp.where(codes == 2,
                                jnp.maximum(0, scalars - dm[d]), scalars))
        return jnp.where(frozen, scalars, s), frozen | (codes == 3)

    # phase 1: levels 0..K on full (tiny, <= 2^K) arrays
    root_codes = unpack2(dtree.packed_levels[0])[:1].astype(jnp.int32)
    scalars = jnp.full((1,), dm[0], dtype=jnp.int32)
    frozen = root_codes == 3
    for d in range(1, K + 1):
        scalars = jnp.repeat(scalars, 2)
        frozen = jnp.repeat(frozen, 2)
        if d > cut_depth:
            continue
        codes = unpack2(dtree.packed_levels[d])[: 1 << d].astype(jnp.int32)
        scalars, frozen = step(scalars, frozen, codes, d)

    # chunk geometry: the first K schedule entries fix the TOP bits of each
    # coordinate, so chunk c decodes a contiguous (bZ, bY, bX) box
    pfx, tfx = sched[:K], sched[K:]
    gX, gY, gZ = 1 << pfx.count(0), 1 << pfx.count(1), 1 << pfx.count(2)
    bX, bY, bZ = X // gX, Y // gY, Z // gZ
    C = 1 << K
    L = 1 << (orig_depth - K)
    perm_T, _ = _leaf_axes_perm(bX, bY, bZ, tfx)
    inv_T = tuple(int(i) for i in np.argsort(perm_T))

    def codes_at(d, c):
        """Chunk c's codes at level d: the CONTIGUOUS run of 2^(d-K) codes
        starting at c * 2^(d-K), sliced from the packed byte stream."""
        n = 1 << (d - K)
        packed = dtree.packed_levels[d]
        if n >= 4:
            b = jax.lax.dynamic_slice(packed, (c * (n // 4),), (n // 4,))
            return unpack2(b)[:n].astype(jnp.int32)
        # n in {2}: the run sits inside one byte at a sub-byte offset
        b = jax.lax.dynamic_slice(packed, (c * n // 4,), (1,))
        q = unpack2(b).astype(jnp.int32)
        return jax.lax.dynamic_slice(q, ((c * n) % 4,), (n,))

    def decode_chunk(c):
        s = jax.lax.dynamic_slice(scalars, (c,), (1,))
        fz = jax.lax.dynamic_slice(frozen, (c,), (1,))
        for d in range(K + 1, orig_depth + 1):
            s = jnp.repeat(s, 2)
            fz = jnp.repeat(fz, 2)
            if d > cut_depth:
                continue
            s, fz = step(s, fz, codes_at(d, c), d)
        if cut_depth > orig_depth and chain_len:
            rows = jax.lax.dynamic_slice(
                dtree.packed_chains, (c * L, 0),
                (L, dtree.packed_chains.shape[1]))
            chain_codes = unpack2(rows).astype(jnp.int32)
            for i in range(min(chain_len, cut_depth - orig_depth)):
                s, fz = step(s, fz, chain_codes[:, i], orig_depth + 1 + i)
        box = s.astype(jnp.uint8).reshape(
            (2,) * (orig_depth - K)).transpose(inv_T)
        return box.reshape(bZ, bY, bX)

    boxes = jax.lax.map(decode_chunk, jnp.arange(C, dtype=jnp.int32))
    # chunk index -> (gz, gy, gx) grid position (breadth-first over pfx)
    perm_P, _ = _leaf_axes_perm(gX, gY, gZ, pfx)
    inv_P = [int(i) for i in np.argsort(perm_P)]
    grid = boxes.reshape((2,) * K + (bZ, bY, bX)).transpose(
        inv_P + [K, K + 1, K + 2])
    grid = grid.reshape(gZ, gY, gX, bZ, bY, bX)
    return grid.transpose(0, 3, 1, 4, 2, 5).reshape(Z, Y, X)


@partial(jax.jit, static_argnames=("spec_key", "cut_depth"))
def _tree_mip8_impl(dtree: DeviceKdTree, spec_key, cut_depth: int):
    dims, orig_depth, max_depth, schedule, chain_len = spec_key
    X, Y, Z = dims
    sched = list(schedule)
    scalars = _decode_leaf_scalars(dtree, spec_key, cut_depth)

    # max over each axis's LAST min(3, log2(dim)) splits = the per-8³-block
    # max (the decoded cut is piecewise constant on cut-depth node boxes, so
    # this is an EXACT block max of the decoded volume — build-time min/max
    # bounds the *original* data and would be unsound for the lossy decode).
    # Those splits are non-contiguous bit positions of the leaf index (an
    # axis may exhaust early in the schedule), so reduce on the (2,)*D view.
    need = {0: min(3, int(np.log2(X))), 1: min(3, int(np.log2(Y))),
            2: min(3, int(np.log2(Z)))}
    chosen: list[int] = []
    for a in (0, 1, 2):
        occ = [i for i, sd in enumerate(sched) if sd == a]
        chosen.extend(occ[len(occ) - need[a]:])
    D = len(sched)
    m = scalars.reshape((2,) * D).max(axis=tuple(sorted(chosen)))
    m = m.reshape(-1)  # breadth-first over the reduced schedule

    reduced = [sd for i, sd in enumerate(sched) if i not in set(chosen)]
    gX, gY, gZ = X >> need[0], Y >> need[1], Z >> need[2]  # 8-block grid
    perm, (nz, ny, nx) = _leaf_axes_perm(gX, gY, gZ, reduced)
    inv = np.argsort(perm)
    g = m.reshape((2,) * (nz + ny + nx)).transpose(inv).reshape(gZ, gY, gX)
    return g.astype(jnp.float32)


def tree_occupancy_mip8(dtree: DeviceKdTree, spec: dict,
                        cut_depth: int | None = None) -> jnp.ndarray:
    """Per-8³-block maxima of the decoded level cut.  Shallow trees compute
    it from the tree's own scalars with no dense (Z, Y, X) pass
    (``_tree_mip8_impl``); deep trees (the chunked-decode regime) reduce the
    chunked device decode instead — the flat impl's ``(2,)*D`` reshapes pick
    up ~128x tiling padding on deep trees (2 GB HLO temps per level at
    D=24, same mechanism as the round-4 level-cut compile OOM), while the
    block max of the decoded cut is the SAME array by definition (the cut is
    piecewise constant on node boxes) at a transient 16 MB.  Drives the
    slab residency of the compressed-domain pool
    (``ops.sampling.build_shade_pool``) from codec data."""
    if cut_depth is None:
        cut_depth = spec["max_depth"]
    spec_key = (tuple(spec["dims"]), spec["orig_depth"], spec["max_depth"],
                tuple(spec["schedule"]), spec["chain_len"])
    if spec["orig_depth"] >= CHUNKED_DECODE_MIN_DEPTH:
        vol = level_cut_device(dtree, spec, int(cut_depth))
        return _mip8_of_cut(vol)
    return _tree_mip8_impl(dtree, spec_key, int(cut_depth))


def block_max8(volume):
    """(Z, Y, X) f32 in [0, 1] -> (ceil(Z/8), ceil(Y/8), ceil(X/8)) f32
    per-8³-block maximum in 0..255 units.  :func:`tree_occupancy_mip8`
    produces the same grid from the compressed tree's own scalars with no
    dense-volume pass."""
    s = jnp.round(jnp.clip(volume, 0.0, 1.0) * 255.0)
    Z, Y, X = s.shape
    pz, py, px = (-Z) % 8, (-Y) % 8, (-X) % 8
    s = jnp.pad(s, ((0, pz), (0, py), (0, px)))
    return s.reshape((Z + pz) // 8, 8, (Y + py) // 8, 8,
                     (X + px) // 8, 8).max(axis=(1, 3, 5))


@jax.jit
def _mip8_of_cut(vol_u8):
    return block_max8(vol_u8.astype(jnp.float32) * (1.0 / 255.0))


def level_cut_device(dtree: DeviceKdTree, spec: dict,
                     cut_depth: int | None = None,
                     chunk_bits: int | None = None) -> jnp.ndarray:
    """Decode a level cut on device; returns a (Z, Y, X) uint8 jnp array.

    Deep trees (orig_depth >= CHUNKED_DECODE_MIN_DEPTH) decode per depth-K
    subtree chunk so every intermediate buffer stays bounded — the fix for
    the tolerance-1 256³ compile OOM (reference decode handles any tree,
    ``VolumeKdTree_recover.cpp:726-835``).  ``chunk_bits`` forces a
    per-chunk leaf-array size of 2^chunk_bits (tests)."""
    if cut_depth is None:
        cut_depth = spec["max_depth"]
    spec_key = (tuple(spec["dims"]), spec["orig_depth"], spec["max_depth"],
                tuple(spec["schedule"]), spec["chain_len"])
    D = spec["orig_depth"]
    bits = chunk_bits if chunk_bits is not None else (
        CHUNK_LEAF_BITS if D >= CHUNKED_DECODE_MIN_DEPTH else None)
    if bits is not None and D - 1 > bits:
        K = D - bits
        return _level_cut_chunked_impl(dtree, spec_key, int(cut_depth), K)
    return _level_cut_impl(dtree, spec_key, int(cut_depth))
