"""Mid-range dual-tree codec — JAX rebuild of the reference
``MidRangeTree`` (``MidRangeTree.cpp``; compiled and selectable in the
reference, ``main.cpp:158,252``).

Differences from the single-channel kd-tree codec (``kdtree.py``):

* every node carries TWO values: midpoint ``(max+min)/2`` and half-range
  ``(max−min)/2`` (``MidRangeTree.cpp:233-236``) — leaves have range 0;
* two independent distance maps / 2-bit code trees fit by the same seeding +
  gradient-descent machinery (``compressGradientDescent[_range]``,
  ``:245-544``).  The range pass guards the central-difference evaluation with
  ``epoch + 1 < maxEpochs`` (``:340,492`` — the pre-recovery semantics); that
  guard only skips a derivative the loop never uses afterwards, so the Δ
  trajectory and codes are identical to the unguarded variant — which also
  means this module's mid channel is bit-identical to ``kdtree.build`` (the
  property the tests pin);
* prune and branch-growth decisions use ONLY the midpoint channel
  (``pruneTreeRecursive``: ``tree[rootIdx]==0`` and mid recon error,
  ``:857-868``; ``convertToPreorder`` growth on ``recon`` vs ``temp``,
  ``:946-957``) but set/emit codes in BOTH trees in lockstep
  (``:905,921,929,940``);
* ``levelCut`` decodes the midpoint tree only (``:984-1093`` never touches
  ``tree_range``) — the range tree exists for the (stubbed) in-shader decode;
  we also provide the symmetric range decode;
* serialization: one header, two distance maps, two packed trees
  (``:753-833``); ``convertToByteArray`` interleaves both trees 2 nodes/byte
  zero-padded to a power of two (``:1095-1128``) for texture upload.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..utils.bitarray import pack2_np, unpack2_np
from . import kdtree as K

__all__ = ["MidRangeTree", "build", "level_cut", "level_cut_range", "save",
           "open_tree", "convert_to_byte_array"]


@dataclasses.dataclass
class MidRangeTree:
    mid: K.KdTree                      # midpoint channel (structure owner)
    range_distance_map: np.ndarray
    range_level_codes: list[np.ndarray]
    range_chain_codes: np.ndarray | None
    leaf_recon_range: np.ndarray | None = None
    leaf_truth_range: np.ndarray | None = None

    @property
    def num_active_nodes(self) -> int:
        return self.mid.num_active_nodes


def build(volume: np.ndarray, tolerance: int = 6, max_epochs: int = 5) -> MidRangeTree:
    volume = np.asarray(volume, dtype=np.uint8)
    Z, Y, X = volume.shape
    schedule = K.split_schedule(X, Y, Z)
    D = len(schedule)
    max_depth = D + K.MAX_ADD_LEVELS

    # PASS 1 — min/max pyramid -> (midpoint, half-range) per node
    leaves = K.volume_to_leaves(volume, schedule)
    temp_mid: list[np.ndarray] = [None] * (D + 1)
    temp_rng: list[np.ndarray] = [None] * (D + 1)
    temp_mid[D] = leaves
    temp_rng[D] = np.zeros_like(leaves)
    lmin = lmax = leaves
    for d in range(D - 1, -1, -1):
        lmin = np.minimum(lmin[0::2], lmin[1::2])
        lmax = np.maximum(lmax[0::2], lmax[1::2])
        temp_mid[d] = ((lmin.astype(np.uint16) + lmax) // 2).astype(np.uint8)
        temp_rng[d] = ((lmax.astype(np.int16) - lmin) // 2).astype(np.uint8)

    # PASS 2 — two independent Δ fits over the same structure
    dm_mid = np.zeros(max_depth + 1, dtype=np.uint8)
    dm_rng = np.zeros(max_depth + 1, dtype=np.uint8)
    codes_mid: list[np.ndarray] = []
    codes_rng: list[np.ndarray] = []
    recon_m = recon_r = None
    for d in range(D + 1):
        parent_m = np.zeros(1, dtype=np.int32) if d == 0 else np.repeat(recon_m, 2)
        parent_r = np.zeros(1, dtype=np.int32) if d == 0 else np.repeat(recon_r, 2)
        seed_m = K.seed_level(temp_mid[d], parent_m)
        dist_m, cm, recon_m = K.gd_fit_level(temp_mid[d], parent_m, max_epochs, seed_m)
        seed_r = K.seed_level(temp_rng[d], parent_r)
        dist_r, cr, recon_r = K.gd_fit_level(temp_rng[d], parent_r, max_epochs, seed_r)
        dm_mid[d] = dist_m
        dm_rng[d] = dist_r
        codes_mid.append(cm)
        codes_rng.append(cr)

    for i, dist in enumerate(K.ADD_LEVEL_DISTANCES):
        dm_mid[D + 1 + i] = dist
        dm_rng[D + 1 + i] = dist

    mid = K.KdTree(
        dims=(X, Y, Z), orig_depth=D, max_depth=max_depth,
        distance_map=dm_mid, level_codes=codes_mid, chain_codes=None,
        schedule=schedule, tolerance=tolerance, max_epochs=max_epochs,
        leaf_recon=recon_m.copy(), leaf_truth=temp_mid[D],
    )

    # PASS 3 — prune decided by the mid channel; both trees set to 3 in lockstep
    err_ok = np.abs(mid.leaf_recon - mid.leaf_truth.astype(np.int32)) < tolerance
    pruned = (codes_mid[D] == 0) & err_ok
    codes_mid[D] = np.where(pruned, 3, codes_mid[D]).astype(np.uint8)
    codes_rng[D] = np.where(pruned, 3, codes_rng[D]).astype(np.uint8)
    for d in range(D - 1, -1, -1):
        child_ok = pruned[0::2] & pruned[1::2]
        pruned = (codes_mid[d] == 0) & child_ok
        codes_mid[d] = np.where(pruned, 3, codes_mid[d]).astype(np.uint8)
        codes_rng[d] = np.where(pruned, 3, codes_rng[d]).astype(np.uint8)

    # PASS 4 — growth driven by mid error; both channels evaluated per step
    n = mid.num_leaves
    max_chain = K.MAX_ADD_LEVELS
    chains_m = np.full((n, max_chain), K.NO_NODE, dtype=np.uint8)
    chains_r = np.full((n, max_chain), K.NO_NODE, dtype=np.uint8)
    rm = mid.leaf_recon.astype(np.int32)
    rr = recon_r.astype(np.int32)
    tm = mid.leaf_truth.astype(np.int32)
    tr = temp_rng[D].astype(np.int32)
    leaf_code = codes_mid[D]
    err = np.abs(rm - tm)
    active = (leaf_code != 3) & (err > tolerance)
    needs_terminal = (leaf_code != 3) & ~active
    chains_m[needs_terminal, 0] = 3
    chains_r[needs_terminal, 0] = 3
    zero_start = np.full(n, -1, dtype=np.int32)

    pos = 0
    while pos < max_chain and active.any():
        depth = D + 1 + pos
        cm, new_rm, _ = K.encode_level(tm[active], rm[active], int(dm_mid[depth]))
        cr, new_rr, _ = K.encode_level(tr[active], rr[active], int(dm_rng[depth]))
        rm[active] = new_rm
        rr[active] = new_rr
        chains_m[active, pos] = cm
        chains_r[active, pos] = cr
        act_idx = np.nonzero(active)[0]
        zs = zero_start[act_idx]
        zero_start[act_idx] = np.where(cm == 0, np.where(zs == -1, pos, zs), -1)
        still = np.abs(rm - tm)[act_idx] > tolerance
        finished = act_idx[~still]
        if pos + 1 < max_chain:
            chains_m[finished, pos + 1] = 3
            chains_r[finished, pos + 1] = 3
        active[:] = False
        active[act_idx[still]] = True
        pos += 1

    for i in np.nonzero(zero_start >= 0)[0]:
        j = zero_start[i]
        while j < max_chain and chains_m[i, j] == 0:
            chains_m[i, j] = 3
            chains_r[i, j] = 3
            j += 1

    mid.chain_codes = chains_m
    mid.leaf_recon = rm
    mid.num_active_nodes = K._count_active(mid)

    return MidRangeTree(
        mid=mid, range_distance_map=dm_rng, range_level_codes=codes_rng,
        range_chain_codes=chains_r, leaf_recon_range=rr, leaf_truth_range=tr,
    )


def _range_view(tree: MidRangeTree) -> K.KdTree:
    """A KdTree view of the range channel sharing the mid structure."""
    return dataclasses.replace(
        tree.mid, distance_map=tree.range_distance_map,
        level_codes=tree.range_level_codes, chain_codes=tree.range_chain_codes)


def level_cut(tree: MidRangeTree, cut_depth: int | None = None) -> np.ndarray:
    """Reference ``levelCut``: decodes the MIDPOINT channel only."""
    return K.level_cut(tree.mid, cut_depth)


def level_cut_range(tree: MidRangeTree, cut_depth: int | None = None) -> np.ndarray:
    """Symmetric decode of the range channel (beyond reference capability —
    its shader-side consumer was never finished)."""
    return K.level_cut(_range_view(tree), cut_depth)


def to_preorder_pair(tree: MidRangeTree) -> tuple[np.ndarray, np.ndarray]:
    """Both preorder streams; positions are identical by construction."""
    pre_mid = K.to_preorder(tree.mid)
    pre_rng = K.to_preorder(_range_view(tree))
    return pre_mid, pre_rng


def save(tree: MidRangeTree, path: str) -> None:
    """Dual-tree reference format (``MidRangeTree.cpp:753-786``)."""
    X, Y, Z = tree.mid.dims
    pre_m, pre_r = to_preorder_pair(tree)
    with open(path, "wb") as f:
        f.write(struct.pack("<3q", 0, 0, 0))
        f.write(struct.pack("<3q", X, Y, Z))
        f.write(struct.pack("<ii", tree.mid.max_depth, tree.mid.orig_depth))
        f.write(struct.pack("<4q", X, Y, Z, len(pre_m)))
        f.write(tree.mid.distance_map.tobytes())
        f.write(tree.range_distance_map.tobytes())
        f.write(pack2_np(pre_m).tobytes())
        f.write(pack2_np(pre_r).tobytes())


def open_tree(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    off = 48
    max_depth, orig_depth = struct.unpack_from("<ii", data, off); off += 8
    X, Y, Z, num_active = struct.unpack_from("<4q", data, off); off += 32
    dm_m = np.frombuffer(data, np.uint8, max_depth + 1, off); off += max_depth + 1
    dm_r = np.frombuffer(data, np.uint8, max_depth + 1, off); off += max_depth + 1
    nbytes = (num_active + 3) // 4
    pre_m = unpack2_np(np.frombuffer(data, np.uint8, nbytes, off), num_active)
    off += nbytes
    pre_r = unpack2_np(np.frombuffer(data, np.uint8, nbytes, off), num_active)
    return dict(dims=(X, Y, Z), max_depth=max_depth, orig_depth=orig_depth,
                num_active_nodes=num_active, distance_map=np.array(dm_m),
                range_distance_map=np.array(dm_r), preorder=pre_m,
                range_preorder=pre_r)


def convert_to_byte_array(tree: MidRangeTree) -> np.ndarray:
    """Interleaved packed layout for texture upload
    (``convertToByteArray``, ``MidRangeTree.cpp:1095-1128``): byte =
    ``mid[i]<<6 | range[i]<<4 | mid[i+1]<<2 | range[i+1]``, zero-padded to the
    next power of two bytes."""
    pre_m, pre_r = to_preorder_pair(tree)
    n = len(pre_m)
    nbytes = (n + 1) // 2
    v = 1 << max(0, int(np.ceil(np.log2(max(nbytes, 1)))))
    m = np.zeros(2 * v, dtype=np.uint8)
    r = np.zeros(2 * v, dtype=np.uint8)
    m[:n] = pre_m
    r[:n] = pre_r
    out = ((m[0::2] << 6) | (r[0::2] << 4) | (m[1::2] << 2) | r[1::2]).astype(np.uint8)
    return out


def to_device_pair(tree: MidRangeTree):
    """Device-resident packed decode for both channels (reuses the kd-tree
    device pipeline; the channels share one structure)."""
    from .device import to_device

    mid_dev, spec = to_device(tree.mid)
    rng_dev, _ = to_device(_range_view(tree))
    return mid_dev, rng_dev, spec
