"""Morton-hashed kd-tree codec — rebuild of the reference ``HashedKdtree``
(``HashedKdtree.cpp``; excluded from the reference build but real capability
surface, SURVEY.md §2).

Structure (citations into HashedKdtree.{h,cpp}):

* nodes are addressed by Morton code: root ``1``, children ``(m<<1)|{0,1}``
  (``:12-18``); the hash is ``mcode & hashMask`` with ``hashMask = 2^D − 1``
  (``:8-10,35-36``) — deliberately undersized (every depth-D leaf aliases an
  interior node), exercising the collision machinery;
* two parallel 2-bit tables: ``treeData`` (delta codes; 3 = collision sentinel
  in the main table) and ``treeStructure`` (0 leaf / 1 left / 2 right / 3 both,
  ``HashedKdtree.h:36-37``); colliding nodes evict the prior occupant into
  side arrays indexed through an ``mcode -> idx`` map (``:126-166``);
* pass 1 builds depth-first (left first — visit order decides who owns a hash
  slot), accumulating per-depth distance sums with the chosen branch's
  *residual* error (``:381,395`` — unlike VolumeKdtree's parent distance) and
  the running-mean candidate ``(sums[d]+pd)/(counts[d]+1)`` (``:350-351``);
  ``distanceMap[d] = (byte)(sums/counts)`` truncates (``:60``);
* pass 2 re-encodes with the map; a leaf with any error above the original
  depth splits into both children; error above tolerance grows ONE child —
  the reference picks it by ``std::shuffle`` seeded from ``random_device``
  (``:473``), which is irreproducible by design; we use a deterministic
  per-node hash choice instead (documented deviation) — extending the tree by
  up to ``maxAddLevels = 4`` levels with Δ = 64, 32, 16, 8 (``:487-494``);
* decode is a structure-gated tree walk (``levelCutRecursive``, ``:254-336``).

This implementation keeps the value/min/max computation as a vectorized
pyramid (midrange per box equals the recursive box scan at ``:103-124``) while
the order-dependent hash-table passes run as explicit-stack DFS on the host.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..utils.bitarray import pack2_np, unpack2_np
from .kdtree import split_schedule, volume_to_leaves, leaves_to_volume

__all__ = ["HashedKdTree", "build", "level_cut", "save", "open_tree"]

MAX_ADD_LEVELS = 4       # HashedKdtree.h:81
ADD_LEVEL_START = 64     # HashedKdtree.h:80
DEFAULT_TOLERANCE = 4    # HashedKdtree.h:79 (constructor)


@dataclasses.dataclass
class HashedKdTree:
    dims: tuple[int, int, int]
    orig_depth: int
    tree_depth: int                 # may exceed orig_depth after growth
    hash_mask: int
    distance_map: np.ndarray        # uint8 (tree_depth + 1,)
    tree_data: np.ndarray           # uint8 codes (2^orig_depth,), 3 = collision
    tree_structure: np.ndarray      # uint8 (2^orig_depth,)
    coll_keys: np.ndarray           # int64 mcodes (sorted for lookup)
    coll_vals: np.ndarray           # int32 indices into collision arrays
    coll_data: np.ndarray           # uint8 codes
    coll_structure: np.ndarray      # uint8
    tolerance: int = DEFAULT_TOLERANCE

    @property
    def num_collisions(self) -> int:
        return len(self.coll_keys)

    def lookup(self, mcode: int) -> tuple[int, int]:
        """(data code, structure) for one node, resolving collisions."""
        key = mcode & self.hash_mask
        code = int(self.tree_data[key])
        if code == 3:
            i = np.searchsorted(self.coll_keys, mcode)
            cidx = int(self.coll_vals[i])
            return int(self.coll_data[cidx]), int(self.coll_structure[cidx])
        return code, int(self.tree_structure[key])


def _deterministic_child(mcode: int) -> int:
    """Deterministic replacement for the reference's shuffled child pick
    (``HashedKdtree.cpp:473``): returns 1 (left) or 2 (right)."""
    h = (mcode * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    return 1 + ((h >> 61) & 1)


class _Builder:
    def __init__(self, volume: np.ndarray, tolerance: int):
        volume = np.asarray(volume, dtype=np.uint8)
        Z, Y, X = volume.shape
        self.dims = (X, Y, Z)
        self.schedule = split_schedule(X, Y, Z)
        self.D = len(self.schedule)
        self.tree_depth = self.D
        self.tolerance = tolerance

        # midrange / uniformity pyramid (== the per-box scans of :103-124)
        leaves = volume_to_leaves(volume, self.schedule)
        self.mid = [None] * (self.D + 1)
        self.uniform = [None] * (self.D + 1)
        lmin = lmax = leaves
        self.mid[self.D] = leaves
        self.uniform[self.D] = np.ones_like(leaves, dtype=bool)
        for d in range(self.D - 1, -1, -1):
            lmin = np.minimum(lmin[0::2], lmin[1::2])
            lmax = np.maximum(lmax[0::2], lmax[1::2])
            self.mid[d] = ((lmin.astype(np.uint16) + lmax) // 2).astype(np.uint8)
            self.uniform[d] = lmin == lmax

        n = 1 << self.D
        self.hash_mask = n - 1
        self.temp = np.zeros(n, dtype=np.uint8)
        self.visited = np.zeros(n, dtype=np.int64)
        self.tree_data = np.zeros(n, dtype=np.uint8)
        self.tree_structure = np.zeros(n, dtype=np.uint8)
        # The reference sizes these to numNodes (:43-45) but the full tree has
        # 2n-1 nodes hashed into n slots, so collision entries can exceed n —
        # a latent overflow in the (build-excluded) reference.  Size safely.
        # bound: ~2n built nodes + up to MAX_ADD_LEVELS grown nodes per leaf,
        # each inserting <= 2 collision entries
        ncoll = 2 * (2 * n + MAX_ADD_LEVELS * n) + 8
        self.temp_coll = np.zeros(ncoll, dtype=np.uint8)
        self.coll_data = np.zeros(ncoll, dtype=np.uint8)
        self.coll_structure = np.zeros(ncoll, dtype=np.uint8)
        self.collisions: dict[int, int] = {}
        self.last_coll_idx = 0
        self.sums = np.zeros(self.D + 1 + MAX_ADD_LEVELS, dtype=np.float64)
        self.counts = np.zeros(self.D + 1 + MAX_ADD_LEVELS, dtype=np.float64)
        self.distance_map = np.zeros(self.D + 1, dtype=np.uint8)

    # -- collision machinery (HashedKdtree.cpp:126-166,413-443) ------------- #

    def _resolve(self, mcode: int) -> tuple[bool, int]:
        """Visit a node; returns (is_collision, key-or-collision-idx)."""
        key = mcode & self.hash_mask
        is_coll = self.tree_data[key] == 3
        if not is_coll:
            if self.visited[key] == 0:
                self.visited[key] = mcode
            elif self.visited[key] != mcode:
                prev = int(self.visited[key])
                if prev not in self.collisions:
                    pidx = self.last_coll_idx
                    self.last_coll_idx += 1
                    self.collisions[prev] = pidx
                    self.temp_coll[pidx] = self.temp[key]
                    self.coll_structure[pidx] = self.tree_structure[key]
                    self.coll_data[pidx] = self.tree_data[key]
                if mcode not in self.collisions:
                    self.collisions[mcode] = self.last_coll_idx
                    self.last_coll_idx += 1
                self.tree_data[key] = 3
                is_coll = True
        if is_coll:
            if mcode not in self.collisions:
                self.collisions[mcode] = self.last_coll_idx
                self.last_coll_idx += 1
            return True, self.collisions[mcode]
        return False, int(key)

    # -- encodeNode (HashedKdtree.cpp:338-404) ------------------------------ #

    def _encode(self, depth, parent, truth, use_map, coll_idx=-1):
        pe = float(parent)
        t = float(truth)
        pd = abs(pe - t)
        md = float(self.distance_map[depth]) if use_map else \
            (self.sums[depth] + pd) / (self.counts[depth] + 1.0)
        none_err = pd
        add_est = min(255.0, pe + md)
        add_err = abs(add_est - t)
        sub_est = max(0.0, pe - md)
        sub_err = abs(sub_est - t)
        min_err = min(sub_err, min(none_err, add_err))
        if min_err == none_err:
            code, est = 0, pe
        elif min_err == add_err:
            code, est = 1, add_est
            if not use_map:
                self.sums[depth] += add_err   # residual, not parent distance!
                self.counts[depth] += 1
        else:
            code, est = 2, sub_est
            if not use_map:
                self.sums[depth] += sub_err
                self.counts[depth] += 1
        if use_map and coll_idx > -1:
            self.coll_data[coll_idx] = code
        return code, int(est)

    def _encode_store(self, mcode, depth, parent, truth, use_map, is_coll, key):
        code, est = self._encode(depth, parent, truth, use_map,
                                 coll_idx=key if is_coll else -1)
        if use_map and not is_coll:
            self.tree_data[key] = code
        return est

    # -- pass 1 (buildRecursive, :96-214) ----------------------------------- #

    def pass1(self):
        # explicit DFS, left first (visit order decides slot ownership)
        stack = [(1, 0, 0, 0)]  # mcode, depth, level_local_idx, parent_est
        while stack:
            mcode, depth, li, parent_est = stack.pop()
            midrange = int(self.mid[depth][li])
            is_leaf = bool(self.uniform[depth][li])
            is_coll, key = self._resolve(mcode)
            if is_coll:
                self.temp_coll[key] = midrange
            else:
                self.temp[key] = midrange
            est = self._encode_store(mcode, depth, parent_est, midrange,
                                     False, is_coll, key)
            if depth < self.D:
                if not is_leaf:
                    if is_coll:
                        self.coll_structure[key] = 3
                    else:
                        self.tree_structure[key] = 3
                # push right then left so left is processed first
                stack.append((2 * mcode + 1, depth + 1, 2 * li + 1, est))
                stack.append((2 * mcode + 0, depth + 1, 2 * li + 0, est))

    # -- pass 2 (compressTreeRecursive, :406-507) --------------------------- #

    def pass2(self):
        # NOTE: ``visited`` is intentionally NOT reset — the reference reuses
        # the pass-1 array (:413-435), so pass-2 growth nodes whose hash slot
        # belongs to a pass-1 owner trigger the eviction machinery.
        add_dist = ADD_LEVEL_START
        add_left = MAX_ADD_LEVELS

        # recursion with explicit stack; left subtree fully processed before
        # right (matters: growth can extend tree_depth mid-pass)
        def rec(mcode, depth, parent_est, true_override):
            nonlocal add_dist, add_left
            is_coll, key = self._resolve(mcode)
            if is_coll:
                children = int(self.coll_structure[key])
                truth = true_override if true_override != -1 else int(self.temp_coll[key])
            else:
                children = int(self.tree_structure[key])
                truth = true_override if true_override != -1 else int(self.temp[key])
            est = self._encode_store(mcode, depth, parent_est, truth, True,
                                     is_coll, key)
            if children == 0:
                leaf_err = abs(est - truth)
                if leaf_err > 0 and depth < self.D:
                    children = 3
                    if is_coll:
                        self.coll_structure[key] = 3
                    else:
                        self.tree_structure[key] = 3
                elif leaf_err > self.tolerance and (depth < self.tree_depth or add_left > 0):
                    children = _deterministic_child(mcode)
                    if is_coll:
                        self.coll_structure[key] = children
                    else:
                        self.tree_structure[key] = children
                    true_override = truth
                    if depth == self.tree_depth and add_left > 0:
                        self.tree_depth += 1
                        self.distance_map = np.append(
                            self.distance_map, np.uint8(add_dist))
                        add_dist //= 2
                        add_left -= 1
                else:
                    return
            if children in (3, 1):
                rec(2 * mcode, depth + 1, est, true_override)
            if children in (3, 2):
                rec(2 * mcode + 1, depth + 1, est, true_override)

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, self.tree_depth + MAX_ADD_LEVELS + 100))
        try:
            rec(1, 0, 0, -1)
        finally:
            sys.setrecursionlimit(old)

    def finish(self) -> HashedKdTree:
        keys = np.array(sorted(self.collisions.keys()), dtype=np.int64)
        vals = np.array([self.collisions[k] for k in keys], dtype=np.int32)
        return HashedKdTree(
            dims=self.dims, orig_depth=self.D, tree_depth=self.tree_depth,
            hash_mask=self.hash_mask, distance_map=self.distance_map,
            tree_data=self.tree_data, tree_structure=self.tree_structure,
            coll_keys=keys, coll_vals=vals,
            coll_data=self.coll_data[:self.last_coll_idx].copy(),
            coll_structure=self.coll_structure[:self.last_coll_idx].copy(),
            tolerance=self.tolerance,
        )


def build(volume: np.ndarray, tolerance: int = DEFAULT_TOLERANCE,
          use_native: bool = True) -> HashedKdTree:
    if use_native:
        try:
            return _build_native(volume, tolerance)
        except OSError:
            pass  # no toolchain: pure-Python fallback below
    b = _Builder(volume, tolerance)
    b.pass1()
    # distanceMap[d] = (byte)(sums/counts) — truncation (:59-61)
    with np.errstate(invalid="ignore", divide="ignore"):
        dm = np.where(b.counts[:b.D + 1] > 0,
                      b.sums[:b.D + 1] / np.maximum(b.counts[:b.D + 1], 1), 0)
    b.distance_map = dm.astype(np.uint8)
    b.pass2()
    return b.finish()


def _build_native(volume: np.ndarray, tolerance: int) -> HashedKdTree:
    """Native builder (``native/hashed_native.cpp``): bit-identical to the
    Python passes (same DFS order, double arithmetic, eviction bookkeeping;
    asserted equal in tests), ~100x faster — the build passes are inherently
    sequential (hash-slot ownership is visit-order-dependent), so host-native
    is the idiomatic split: C++ builds, the device decodes
    (``level_cut_device_hashed``)."""
    from ..native import hashed_native

    volume = np.asarray(volume, dtype=np.uint8)
    Z, Y, X = volume.shape
    schedule = split_schedule(X, Y, Z)
    D = len(schedule)
    leaves = volume_to_leaves(volume, schedule)
    # flat midrange/uniformity pyramid, level d at offset 2^d - 1
    mid_flat = np.empty((1 << (D + 1)) - 1, dtype=np.uint8)
    uni_flat = np.empty_like(mid_flat)
    lmin = lmax = leaves
    mid_flat[(1 << D) - 1:] = leaves
    uni_flat[(1 << D) - 1:] = 1
    for d in range(D - 1, -1, -1):
        lmin = np.minimum(lmin[0::2], lmin[1::2])
        lmax = np.maximum(lmax[0::2], lmax[1::2])
        off = (1 << d) - 1
        mid_flat[off:off + (1 << d)] = \
            ((lmin.astype(np.uint16) + lmax) // 2).astype(np.uint8)
        uni_flat[off:off + (1 << d)] = lmin == lmax
    (tree_data, tree_structure, key_by_idx, coll_data, coll_structure,
     n_coll, dm, tree_depth) = hashed_native.build(mid_flat, uni_flat, D,
                                                   tolerance)
    order = np.argsort(key_by_idx[:n_coll], kind="stable")
    return HashedKdTree(
        dims=(X, Y, Z), orig_depth=D, tree_depth=tree_depth,
        hash_mask=(1 << D) - 1, distance_map=dm[:tree_depth + 1].copy(),
        tree_data=tree_data, tree_structure=tree_structure,
        coll_keys=key_by_idx[:n_coll][order].copy(),
        coll_vals=order.astype(np.int32),
        coll_data=coll_data[:n_coll].copy(),
        coll_structure=coll_structure[:n_coll].copy(),
        tolerance=tolerance,
    )


def level_cut(tree: HashedKdTree, cut_depth: int | None = None) -> np.ndarray:
    """Structure-gated decode (``levelCutRecursive``, ``:254-336``), iterative
    level-sweep over active Morton codes with leaf-range fills."""
    X, Y, Z = tree.dims
    D = tree.orig_depth
    if cut_depth is None:
        cut_depth = tree.tree_depth
    leaves = np.zeros(1 << D, dtype=np.uint8)
    dm = tree.distance_map.astype(np.int32)

    active = [(1, 0)]  # (mcode, scalar-parent)
    for depth in range(0, tree.tree_depth + 1):
        next_active = []
        for mcode, parent in active:
            code, children = tree.lookup(mcode)
            if code == 1:
                scalar = min(255, parent + int(dm[depth]))
            elif code == 2:
                scalar = max(0, parent - int(dm[depth]))
            else:
                scalar = parent
            if depth == cut_depth or children == 0:
                # fill: node at depth d covers leaf range [path<<(D-d), ...)
                path = mcode - (1 << depth) if depth <= D else \
                    (mcode >> (depth - D)) - (1 << D)
                if depth <= D:
                    lo = path << (D - depth)
                    hi = (path + 1) << (D - depth)
                else:
                    lo = path
                    hi = path + 1
                leaves[lo:hi] = scalar
                continue
            if children in (3, 1):
                next_active.append((2 * mcode, scalar))
            if children in (3, 2):
                next_active.append((2 * mcode + 1, scalar))
        active = next_active
        if not active:
            break
    return leaves_to_volume(leaves, tree.dims, split_schedule(X, Y, Z))


def save(tree: HashedKdTree, path: str) -> None:
    """Reference format (``HashedKdtree.cpp:509-554``)."""
    X, Y, Z = tree.dims
    nc = tree.num_collisions
    with open(path, "wb") as f:
        f.write(struct.pack("<3q", 0, 0, 0))
        f.write(struct.pack("<3q", X, Y, Z))
        f.write(struct.pack("<i", tree.tree_depth))
        f.write(struct.pack("<3q", X, Y, Z))
        f.write(struct.pack("<q", tree.hash_mask))
        f.write(struct.pack("<q", nc))
        f.write(tree.distance_map.tobytes())
        f.write(pack2_np(tree.tree_data).tobytes())
        f.write(pack2_np(tree.tree_structure).tobytes())
        f.write(pack2_np(tree.coll_data[:nc]).tobytes())
        f.write(pack2_np(tree.coll_structure[:nc]).tobytes())
        f.write(tree.coll_keys.astype("<i8").tobytes())
        f.write(tree.coll_vals.astype("<i4").tobytes())


def open_tree(path: str) -> HashedKdTree:
    with open(path, "rb") as f:
        data = f.read()
    off = 48
    (tree_depth,) = struct.unpack_from("<i", data, off); off += 4
    X, Y, Z = struct.unpack_from("<3q", data, off); off += 24
    (hash_mask,) = struct.unpack_from("<q", data, off); off += 8
    (nc,) = struct.unpack_from("<q", data, off); off += 8
    dm = np.frombuffer(data, np.uint8, tree_depth + 1, off).copy()
    off += tree_depth + 1
    n = hash_mask + 1
    nb = (n + 3) // 4
    td = unpack2_np(np.frombuffer(data, np.uint8, nb, off), n); off += nb
    ts = unpack2_np(np.frombuffer(data, np.uint8, nb, off), n); off += nb
    cb = (nc + 3) // 4
    cd = unpack2_np(np.frombuffer(data, np.uint8, cb, off), nc); off += cb
    cs = unpack2_np(np.frombuffer(data, np.uint8, cb, off), nc); off += cb
    keys = np.frombuffer(data, "<i8", nc, off).copy(); off += 8 * nc
    vals = np.frombuffer(data, "<i4", nc, off).copy()
    D = int(np.log2(n))
    order = np.argsort(keys)
    return HashedKdTree(dims=(X, Y, Z), orig_depth=D, tree_depth=tree_depth,
                        hash_mask=hash_mask, distance_map=dm, tree_data=td,
                        tree_structure=ts, coll_keys=keys[order],
                        coll_vals=vals[order], coll_data=cd, coll_structure=cs)


# --------------------------------------------------------------------------- #
# device decode (jnp): gather-based hash lookup per level
# --------------------------------------------------------------------------- #

def to_device_hashed(tree: HashedKdTree):
    """Upload the hash tables as device arrays for :func:`level_cut_device_hashed`."""
    import jax.numpy as jnp

    return dict(
        tree_data=jnp.asarray(tree.tree_data.astype(np.int32)),
        tree_structure=jnp.asarray(tree.tree_structure.astype(np.int32)),
        # NOTE: collision KEYS are uploaded inside level_cut_device_hashed at
        # the query dtype (uint32 prefix or int64-under-x64) — a plain
        # jnp.asarray(int64) here would silently downcast without x64
        coll_vals=jnp.asarray(tree.coll_vals.astype(np.int32)),
        coll_data=jnp.asarray(tree.coll_data.astype(np.int32)),
        coll_structure=jnp.asarray(tree.coll_structure.astype(np.int32)),
        distance_map=jnp.asarray(tree.distance_map.astype(np.int32)),
    )


def level_cut_device_hashed(tree: HashedKdTree, dev: dict,
                            cut_depth: int | None = None):
    """Device decode: dense per-level sweeps over all 2^d Morton codes with
    gather-based table lookup and sorted-search collision resolution
    (SURVEY.md §2 checklist item 5); grown levels walk each leaf's unary chain.
    Returns a (Z, Y, X) uint8 jnp array equal to :func:`level_cut`."""
    import jax.numpy as jnp

    X, Y, Z = tree.dims
    D = tree.orig_depth
    if cut_depth is None:
        cut_depth = tree.tree_depth
    # Morton codes at depth d live in [2^d, 2^(d+1)).  The deepest code the
    # decode touches is at depth min(cut_depth, tree_depth), so codes fit
    # uint32 whenever that depth is <= 31 — independent of orig_depth (a
    # shallow cut of an arbitrarily deep tree decodes without x64; the old
    # D <= 30 blanket guard over-raised).
    # Deeper cuts would need > 2^31-element per-level arrays anyway; they
    # require jax x64 for exact int64 codes.
    import jax
    deepest = min(int(cut_depth), tree.tree_depth)
    if deepest > 31 and not jax.config.jax_enable_x64:
        raise ValueError(
            f"device hashed decode of a depth-{deepest} cut needs x64 "
            f"(Morton codes exceed uint32) — enable jax x64 or use "
            f"level_cut() on host")
    mdtype = jnp.int64 if deepest > 31 else jnp.uint32
    dm = dev["distance_map"]
    mask = tree.hash_mask
    # collision keys: sorted ascending; queries are < 2^(deepest+1), so only
    # the prefix of keys below that bound can ever match — carried at the
    # query dtype (exact: prefix values fit it by construction)
    k_np = tree.coll_keys
    if mdtype == jnp.uint32:
        k_np = k_np[: int(np.searchsorted(k_np, 1 << 32))]
    keys_dev = jnp.asarray(k_np.astype(np.int64 if deepest > 31
                                       else np.uint32))

    # ONE jit for the whole level sweep: the eager per-op form paid one
    # dispatch for each of ~400 ops.  The
    # final leaves->volume transpose stays EAGER: under jit, (2,)*D-shaped
    # intermediates pick up ~128x tiling padding on deep trees (see
    # codecs/device.py tree_occupancy_mip8).
    def _sweep(dev_arrs, keys_arr):
        return _hashed_sweep_body(dev_arrs, keys_arr)

    def _hashed_sweep_body(dev_arrs, keys_arr):
        dm = dev_arrs["distance_map"]

        def lookup(mcodes):
            key = (mcodes & jnp.asarray(mask, mdtype)).astype(jnp.int32)
            code = dev_arrs["tree_data"][key]
            children = dev_arrs["tree_structure"][key]
            is_coll = code == 3
            # sorted-search into the collision key list (keys are unique)
            pos = jnp.searchsorted(keys_arr, mcodes)
            pos = jnp.clip(pos, 0, max(len(k_np) - 1, 0))
            if len(k_np):
                cidx = dev_arrs["coll_vals"][pos]
                code = jnp.where(is_coll, dev_arrs["coll_data"][cidx], code)
                children = jnp.where(is_coll, dev_arrs["coll_structure"][cidx],
                                     children)
            return code, children

        def apply_code(parent_scalar, code, depth):
            return jnp.where(
                code == 1, jnp.minimum(255, parent_scalar + dm[depth]),
                jnp.where(code == 2,
                          jnp.maximum(0, parent_scalar - dm[depth]),
                          parent_scalar))

        return _hashed_sweep_levels(lookup, apply_code)

    def _hashed_sweep_levels(lookup, apply_code):
        scalars = jnp.zeros(1, jnp.int32)
        active = jnp.ones(1, bool)
        frozen_scalar = jnp.zeros(1, jnp.int32)  # value filled at termination
        filled = jnp.zeros(1, bool)
        leaf_scalars = None
        for d in range(0, min(cut_depth, D) + 1):
            mcodes = jnp.arange(1 << d, dtype=mdtype) + jnp.asarray(1 << d, mdtype)
            code, children = lookup(mcodes)
            s = apply_code(scalars, code, d)
            terminal = active & ((children == 0) | (d == cut_depth))
            frozen_scalar = jnp.where(terminal, s, frozen_scalar)
            filled = filled | terminal
            if d < min(cut_depth, D):
                go_left = active & ~terminal & ((children == 3) | (children == 1))
                go_right = active & ~terminal & ((children == 3) | (children == 2))
                nxt_active = jnp.stack([go_left, go_right], 1).reshape(-1)
                scalars = jnp.repeat(s, 2)
                active = nxt_active
                frozen_scalar = jnp.repeat(frozen_scalar, 2)
                filled = jnp.repeat(filled, 2)
            else:
                leaf_scalars = jnp.where(filled, frozen_scalar, s)
                leaf_active = active & ~terminal
        # expand to full leaf resolution if the sweep stopped above D
        reached = min(cut_depth, D)
        if reached < D:
            rep = 1 << (D - reached)
            leaf_scalars = jnp.repeat(jnp.where(filled, frozen_scalar, scalars), rep)
            leaf_active = jnp.zeros(1 << D, bool)
            leaf_codes_m = None
        else:
            # grown unary chains below D: each still-active leaf follows its
            # structure-chosen child bit up to cut_depth
            mcodes = jnp.arange(1 << D, dtype=mdtype) + jnp.asarray(1 << D, mdtype)
            code, children = lookup(mcodes)
            cur_m = mcodes
            cur_children = children
            s = leaf_scalars
            act = leaf_active
            for d in range(D + 1, min(cut_depth, tree.tree_depth) + 1):
                bit = jnp.where(cur_children == 2, 1, 0).astype(mdtype)
                cur_m = (cur_m << 1) | bit
                code, children = lookup(cur_m)
                s = jnp.where(act, apply_code(s, code, d), s)
                terminal = act & ((children == 0) | (d == cut_depth))
                act = act & ~terminal
                cur_children = children
            leaf_scalars = s
        return leaf_scalars.astype(jnp.uint8)

    # cache the jitted sweep per (table identity, cut): the trace+remote-
    # compile of the unrolled level graph dominates (112 s at 128³ even on
    # a repeat call with a fresh closure); repeat decodes reuse it
    cache = dev.setdefault("_sweep_jit_cache", {})
    ckey = (cut_depth, tree.tree_depth, str(mdtype), len(k_np))
    fn = cache.get(ckey)
    if fn is None:
        fn = jax.jit(_sweep)
        cache[ckey] = fn
    arrs = {k: v for k, v in dev.items() if k != "_sweep_jit_cache"}
    leaves = fn(arrs, keys_dev)

    # leaves -> volume ON DEVICE (the reference decode writes boxes host-side,
    # HashedKdtree.cpp:254-336; here the inverse breadth-first permutation is
    # a reshape/transpose on the device array — no host round-trip, matching
    # the kd-tree decoder's `_level_cut_impl`)
    from .kdtree import _leaf_axes_perm

    perm, (nz, ny, nx) = _leaf_axes_perm(X, Y, Z, split_schedule(X, Y, Z))
    inv = np.argsort(perm)
    return leaves.reshape((2,) * (nz + ny + nx)).transpose(inv).reshape(Z, Y, X)
