"""Progressive kd-tree codec — JAX rebuild of the reference's
``VolumeKdtree`` (the *recover* variant actually compiled into the reference:
``VolumeKdTree_recover.cpp``, see SURVEY.md §2).

What the reference does (all citations into /root/reference/volume_renderer/):

* PASS 1 BUILD — recursive midrange pyramid over a full binary kd-tree whose
  split dimension cycles x/y/z skipping extent-1 dims
  (``VolumeKdTree_recover.cpp:143-201``);
* PASS 2 COMPRESS — per depth, a "distance map" value Δ is seeded by a running
  mean over nodes in level order (``encodeNodeEstimate``, ``:415-455``) and
  refined by gradient descent on the mean squared per-node error
  (``compressGradientDescent``, ``:206-384``); each node gets a 2-bit code
  {0: keep parent, 1: +Δ, 2: −Δ} via ``encodeNode`` (``:457-502``) with the
  tie order none ≻ add ≻ sub and estimates clamped to [0, 255];
* PASS 3 PRUNE — post-order: a subtree whose nodes all have code 0 and whose
  leaves reconstruct within tolerance collapses to code 3 (``:596-629``);
* PASS 4 CONVERT — breadth-first → unbalanced preorder array, growing unary
  branches (fixed Δ ladder 64..1, ``:21-23,93-96``) under leaves whose error
  exceeds the tolerance, retro-pruning trailing zero runs (``:631-724``);
* ``levelCut`` — sequential preorder stack decode (``:726-835``).

Here the recursion inverts into level-synchronous array programs: the implicit
heap becomes per-level arrays, the pyramid a pairwise min/max reduction, the
per-node encode a vectorized 3-way select, prune a boolean pyramid, branch
growth an unrolled per-leaf scan, and the preorder emit a subtree-size +
offset computation — every pass data-parallel except the Δ-seeding running
mean, which is inherently sequential (scalar carry) and runs on the host
(C++ native module when built, Python fallback otherwise).

Deliberate, documented deviations from the literal C++ (see also the test
oracle in codecs/reference_impl.py, which matches *these* semantics):

1. ``currentError`` is reset to zero for every evaluation.  The C++ accumulates
   into an uninitialized/carried-over double (``:307-315``) — undefined
   behavior whose contribution is divided by the node count and practically
   negligible; we implement the intended mean.
2. After gradient descent converges, the level is re-encoded once with the
   final Δ, so the stored codes always correspond to ``distanceMap[depth]``.
   The C++ can exit the loop right after a reverted epoch leaving codes from
   the rejected Δ in the tree (``:323-331``); on the happy path the two are
   identical.

The vectorized path requires power-of-two dimensions (every level then shares
one split dimension and extent — true for the 256x256x128 RM bricks).  For
non-power-of-two volumes, compress per brick (the device-side decomposition,
mirroring the reference's brick grid at ``main.cpp:78-79``).
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..utils.bitarray import pack2_np, unpack2_np

__all__ = ["KdTree", "build", "level_cut", "save", "open_tree", "open_tree_full",
           "preorder_to_levels", "split_schedule",
           "ADD_LEVEL_DISTANCES", "MAX_ADD_LEVELS"]

MAX_ADD_LEVELS = 7                                # VolumeKdTree_recover.cpp:22
ADD_LEVEL_DISTANCES = (64, 32, 16, 8, 4, 2, 1)    # VolumeKdTree_recover.cpp:23
GAMMA = 1.25                                      # step size multiplier (:209)
H = 1.0                                           # central difference interval (:210)
MAX_ABS_STEP = 4.0                                # (:211)


# --------------------------------------------------------------------------- #
# Split schedule & leaf permutation
# --------------------------------------------------------------------------- #

def split_schedule(X: int, Y: int, Z: int) -> list[int]:
    """Per-depth split dimension (0=x, 1=y, 2=z), replicating the cycle-and-
    skip rule of ``buildRecursive`` (``VolumeKdTree_recover.cpp:151-159``).

    Valid when all dims are powers of two (every node at a depth then has the
    same extent, so the schedule is uniform)."""
    for n, d in ((X, "X"), (Y, "Y"), (Z, "Z")):
        if n & (n - 1) or n <= 0:
            raise ValueError(
                f"vectorized kd-tree requires power-of-two dims, got {d}={n}; "
                "compress per power-of-two brick instead")
    ext = [X, Y, Z]
    depth_total = int(np.log2(X)) + int(np.log2(Y)) + int(np.log2(Z))
    schedule = []
    for depth in range(depth_total):
        sd = depth % 3
        i = 0
        num_cells = ext[0] * ext[1] * ext[2]
        while num_cells > 1 and ext[sd] == 1:
            i += 1
            sd = (depth + i) % 3
        schedule.append(sd)
        ext[sd] //= 2
    return schedule


def _leaf_axes_perm(X: int, Y: int, Z: int, schedule: list[int]):
    """Axis permutation taking the (Z, Y, X) volume reshaped into per-bit axes
    to breadth-first leaf order.  Leaf n's bits are assigned MSB-first to the
    split dims in schedule order."""
    nx, ny, nz = int(np.log2(X)), int(np.log2(Y)), int(np.log2(Z))
    # volume.reshape((2,)*nz + (2,)*ny + (2,)*nx): axes 0..nz-1 are z bits
    # (MSB first), then y bits, then x bits.
    offsets = {2: 0, 1: nz, 0: nz + ny}
    counters = {0: 0, 1: 0, 2: 0}
    perm = []
    for sd in schedule:
        perm.append(offsets[sd] + counters[sd])
        counters[sd] += 1
    return perm, (nz, ny, nx)


def volume_to_leaves(volume: np.ndarray, schedule: list[int]) -> np.ndarray:
    """(Z, Y, X) volume -> flat array in breadth-first leaf order (pure
    reshape/transpose — zero gathers)."""
    Z, Y, X = volume.shape
    perm, (nz, ny, nx) = _leaf_axes_perm(X, Y, Z, schedule)
    v = volume.reshape((2,) * (nz + ny + nx))
    return np.ascontiguousarray(v.transpose(perm)).reshape(-1)


def leaves_to_volume(leaves: np.ndarray, dims: tuple[int, int, int],
                     schedule: list[int]) -> np.ndarray:
    """Inverse of :func:`volume_to_leaves`; dims = (X, Y, Z)."""
    X, Y, Z = dims
    perm, (nz, ny, nx) = _leaf_axes_perm(X, Y, Z, schedule)
    inv = np.argsort(perm)
    v = leaves.reshape((2,) * (nz + ny + nx)).transpose(inv)
    return np.ascontiguousarray(v).reshape(Z, Y, X)


# --------------------------------------------------------------------------- #
# encodeNode / seeding
# --------------------------------------------------------------------------- #

def encode_level(truth: np.ndarray, parent: np.ndarray, distance: int):
    """Vectorized ``encodeNode`` (``VolumeKdTree_recover.cpp:457-502``) over one
    level.  All quantities are exact integers; tie order none ≻ add ≻ sub.

    Returns (codes uint8, recon int32, min_err int64)."""
    t = truth.astype(np.int64)
    p = parent.astype(np.int64)
    none_est = p
    none_err = np.abs(p - t)
    add_est = np.minimum(255, p + distance)
    add_err = np.abs(add_est - t)
    sub_est = np.maximum(0, p - distance)
    sub_err = np.abs(sub_est - t)
    min_err = np.minimum(sub_err, np.minimum(none_err, add_err))
    codes = np.where(none_err == min_err, 0,
                     np.where(add_err == min_err, 1, 2)).astype(np.uint8)
    recon = np.where(codes == 0, none_est,
                     np.where(codes == 1, add_est, sub_est)).astype(np.int32)
    return codes, recon, min_err


def seed_level(truth: np.ndarray, parent: np.ndarray) -> float:
    """Level-order running-mean Δ seeding (``encodeNodeEstimate`` sweep,
    ``VolumeKdTree_recover.cpp:254-267,415-455``).  Sequential by construction
    (the candidate Δ is the running mean (sum+pd)/(count+1)); uses the C++
    native module when available, else a Python loop.

    Returns the seeded distance: round(sum/count) or 0."""
    try:
        from ..native import kdtree_native
        s, c = kdtree_native.seed_level(
            truth.astype(np.float64), parent.astype(np.float64))
    except (ImportError, OSError):
        s, c = _seed_level_py(truth, parent)
    if c > 0:
        return float(np.floor(s / c + 0.5))  # C++ round(): half away from zero
    return 0.0


def _seed_level_py(truth: np.ndarray, parent: np.ndarray):
    s = 0.0
    c = 0.0
    t = truth.astype(np.float64)
    p = parent.astype(np.float64)
    for i in range(t.shape[0]):
        pe = p[i]
        pd = abs(pe - t[i])
        md = (s + pd) / (c + 1.0)
        none_err = pd
        add_err = abs(min(255.0, pe + md) - t[i])
        sub_err = abs(max(0.0, pe - md) - t[i])
        min_err = min(sub_err, min(none_err, add_err))
        if min_err == none_err:
            continue
        # add or sub chosen -> update running stats (tie add ≻ sub irrelevant
        # here: both branches update identically)
        s += pd
        c += 1.0
    return s, c


def _mean_sq_err(truth: np.ndarray, parent: np.ndarray, distance: int) -> float:
    _, _, min_err = encode_level(truth, parent, distance)
    # exact: integer errors <= 255, squared sums < 2^53 for any realistic level
    return float(np.sum(min_err * min_err, dtype=np.int64)) / truth.shape[0]


def gd_fit_level(truth: np.ndarray, parent: np.ndarray, max_epochs: int,
                 seed_distance: float):
    """Gradient descent on Δ for one level (``VolumeKdTree_recover.cpp:271-369``).

    Scalar loop control replicated exactly (revert on error increase with step
    halving, break on re-quantized repeat, central difference at Δ±1, step =
    clamp(−γ·DF, ±4)); the per-node evaluations are vectorized.

    Returns (distance byte, codes, recon) with codes/recon from a final encode
    at the chosen Δ (deviation 2 in the module docstring)."""
    epoch = 0
    current_distance = seed_distance
    previous_distance = 0.0
    previous_step = 255.0
    previous_error = 65025.0
    current_error = current_df = current_step = 0.0

    while epoch < max_epochs and abs(previous_step) >= 0.5:
        if epoch != 0:
            previous_distance = current_distance
            previous_error = current_error
            previous_df = current_df
            previous_step = current_step
            current_distance = float(np.floor(
                min(255.0, max(0.0, previous_distance + previous_step)) + 0.5))
            if current_distance == previous_distance:
                break

        current_error = _mean_sq_err(truth, parent, int(current_distance))

        if current_error < 1.0:
            break

        if epoch != 0 and current_error > previous_error:
            current_error = previous_error
            current_distance = previous_distance
            current_df = previous_df
            current_step = previous_step / 2.0
            epoch += 1
            continue

        lo = int(max(0.0, current_distance - H))
        hi = int(min(255.0, current_distance + H))
        err_lo = _mean_sq_err(truth, parent, lo)
        err_hi = _mean_sq_err(truth, parent, hi)
        current_df = (err_hi - err_lo) / (2.0 * H)
        current_step = max(-MAX_ABS_STEP, min(MAX_ABS_STEP, -GAMMA * current_df))
        epoch += 1

    distance = int(current_distance)
    codes, recon, _ = encode_level(truth, parent, distance)
    return distance, codes, recon


# --------------------------------------------------------------------------- #
# The tree container
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class KdTree:
    """Compressed tree in level-structured (vectorisable) layout.

    ``level_codes[d]`` holds the 2-bit codes of all 2^d nodes at depth d
    (breadth-first), after pruning.  ``chain_codes`` holds the grown unary
    branches under each leaf: shape (num_leaves, MAX_ADD_LEVELS+1) uint8 where
    255 marks "no node" (chains are emitted into the preorder stream on save).
    """

    dims: tuple[int, int, int]               # (X, Y, Z)
    orig_depth: int
    max_depth: int
    distance_map: np.ndarray                 # uint8 (max_depth + 1,)
    level_codes: list[np.ndarray]
    chain_codes: np.ndarray | None
    schedule: list[int]
    tolerance: int = 6                       # defaults: VolumeKdtree_recover.h:110-112
    max_epochs: int = 5
    num_active_nodes: int = 0
    # build-time stats (leaf recon/truth), kept for metrics & tests
    leaf_recon: np.ndarray | None = None
    leaf_truth: np.ndarray | None = None

    @property
    def num_leaves(self) -> int:
        return 1 << self.orig_depth


NO_NODE = 255  # chain padding marker


# --------------------------------------------------------------------------- #
# build
# --------------------------------------------------------------------------- #

def build(volume: np.ndarray, tolerance: int = 6, max_epochs: int = 5,
          verbose: bool = False) -> KdTree:
    """Compress a (Z, Y, X) uint8 volume.  Mirrors ``build()``
    (``VolumeKdTree_recover.cpp:17-140``): pyramid, per-level Δ fit + encode,
    prune, branch growth."""
    volume = np.asarray(volume, dtype=np.uint8)
    Z, Y, X = volume.shape
    schedule = split_schedule(X, Y, Z)
    D = len(schedule)
    max_depth = D + MAX_ADD_LEVELS

    # PASS 1 — midrange pyramid (leaf min = max = cell value; interior
    # midrange = (min+max)/2 truncated, VolumeKdTree_recover.cpp:191-198)
    leaves = volume_to_leaves(volume, schedule)
    temp_levels: list[np.ndarray] = [None] * (D + 1)
    temp_levels[D] = leaves
    lmin = lmax = leaves
    for d in range(D - 1, -1, -1):
        lmin = np.minimum(lmin[0::2], lmin[1::2])
        lmax = np.maximum(lmax[0::2], lmax[1::2])
        temp_levels[d] = ((lmin.astype(np.uint16) + lmax) // 2).astype(np.uint8)

    # PASS 2 — per-level Δ fit + 2-bit encode
    distance_map = np.zeros(max_depth + 1, dtype=np.uint8)
    level_codes: list[np.ndarray] = []
    parent_recon = np.zeros(1, dtype=np.int32)  # root's parent estimate is 0
    recon = None
    for d in range(D + 1):
        truth = temp_levels[d]
        parent = parent_recon if d == 0 else np.repeat(recon, 2)
        seed = seed_level(truth, parent)
        dist, codes, recon = gd_fit_level(truth, parent, max_epochs, seed)
        distance_map[d] = dist
        level_codes.append(codes)
        if verbose:
            print(f"depth {d}: Δ={dist} nodes={truth.shape[0]}")

    leaf_recon = recon.copy()
    leaf_truth = temp_levels[D]

    # additional fixed Δ levels (VolumeKdTree_recover.cpp:93-96)
    for i, dist in enumerate(ADD_LEVEL_DISTANCES):
        distance_map[D + 1 + i] = dist

    tree = KdTree(
        dims=(X, Y, Z), orig_depth=D, max_depth=max_depth,
        distance_map=distance_map, level_codes=level_codes, chain_codes=None,
        schedule=schedule, tolerance=tolerance, max_epochs=max_epochs,
        leaf_recon=leaf_recon, leaf_truth=leaf_truth,
    )

    _prune(tree)
    _grow_chains(tree)
    tree.num_active_nodes = _count_active(tree)
    return tree


def _prune(tree: KdTree) -> None:
    """PASS 3 — bottom-up boolean pyramid (``pruneTreeRecursive``,
    ``VolumeKdTree_recover.cpp:596-629``): a node is pruned iff its code is 0,
    both children were pruned, and (leaves only) |recon − truth| < tolerance."""
    D = tree.orig_depth
    err_ok = np.abs(tree.leaf_recon - tree.leaf_truth.astype(np.int32)) < tree.tolerance
    pruned = (tree.level_codes[D] == 0) & err_ok
    tree.level_codes[D] = np.where(pruned, 3, tree.level_codes[D]).astype(np.uint8)
    for d in range(D - 1, -1, -1):
        child_ok = pruned[0::2] & pruned[1::2]
        pruned = (tree.level_codes[d] == 0) & child_ok
        tree.level_codes[d] = np.where(pruned, 3, tree.level_codes[d]).astype(np.uint8)


def _grow_chains(tree: KdTree) -> None:
    """PASS 4 branch growth — per-leaf unary chains (``convertToPreorder``'s
    eval path, ``VolumeKdTree_recover.cpp:655-697``), vectorized over leaves:

    * a pruned leaf (code 3) gets no chain;
    * a leaf within tolerance gets a single terminal code-3 node;
    * a high-error leaf gets eval nodes (encodeNode with the fixed Δ ladder,
      updating recon in place) until |recon − truth| <= tolerance (then one
      terminal 3) or max_depth is reached;
    * trailing runs of code 0 at the end of a chain are retro-pruned to 3
      (``:662-670,684-689``).
    """
    D = tree.orig_depth
    n = tree.num_leaves
    max_chain = tree.max_depth - D  # nodes at depths D+1 .. max_depth
    chains = np.full((n, max_chain), NO_NODE, dtype=np.uint8)

    recon = tree.leaf_recon.astype(np.int32)
    truth = tree.leaf_truth.astype(np.int32)
    leaf_code = tree.level_codes[D]
    err = np.abs(recon - truth)
    active = (leaf_code != 3) & (err > tree.tolerance)   # rays still growing
    needs_terminal = (leaf_code != 3) & ~active          # 1-node chain: just 3

    chains[needs_terminal, 0] = 3
    # zero-run tracking: index within chain where the trailing zero run starts
    zero_start = np.full(n, -1, dtype=np.int32)

    pos = 0
    while pos < max_chain and active.any():
        depth = D + 1 + pos
        dist = int(tree.distance_map[depth])
        codes, new_recon, min_err = encode_level(
            truth[active], recon[active], dist)
        recon[active] = new_recon
        chains[active, pos] = codes
        # zero-run tracking (only eval nodes participate)
        act_idx = np.nonzero(active)[0]
        is_zero = codes == 0
        zs = zero_start[act_idx]
        zs = np.where(is_zero, np.where(zs == -1, pos, zs), -1)
        zero_start[act_idx] = zs

        err_now = np.abs(recon - truth)
        still = err_now[act_idx] > tree.tolerance
        finished = act_idx[~still]
        # finished chains get a terminal 3 at the next position (if any room)
        if pos + 1 < max_chain:
            chains[finished, pos + 1] = 3
        active[:] = False
        active[act_idx[still]] = True
        pos += 1

    # chains cut off by max_depth: active leaves ran to the end (no terminal 3)
    # retro-prune trailing zero runs: entries from zero_start..end -> 3
    has_run = zero_start >= 0
    if has_run.any():
        idx = np.nonzero(has_run)[0]
        for i in idx:
            zs = zero_start[i]
            # only applies when the chain terminated (code 3 or max depth) with
            # a trailing zero run; entries after the run are 3/NO_NODE anyway
            j = zs
            while j < max_chain and chains[i, j] == 0:
                chains[i, j] = 3
                j += 1

    tree.chain_codes = chains
    tree.leaf_recon = recon


def _chain_lengths(tree: KdTree) -> np.ndarray:
    """Number of emitted preorder nodes in each leaf's chain."""
    return np.sum(tree.chain_codes != NO_NODE, axis=1).astype(np.int64)


def _count_active(tree: KdTree) -> int:
    """Total preorder nodes = numActiveNodes (``VolumeKdTree_recover.cpp:714``)."""
    return int(_subtree_sizes(tree)[0][0])


def _subtree_sizes(tree: KdTree) -> list[np.ndarray]:
    """sizes[d][i] = number of preorder entries emitted for the subtree rooted
    at node i of depth d (code-3 nodes emit just themselves; leaves add their
    chain)."""
    D = tree.orig_depth
    sizes = [None] * (D + 1)
    sizes[D] = 1 + np.where(tree.level_codes[D] == 3, 0, _chain_lengths(tree))
    for d in range(D - 1, -1, -1):
        child_sum = sizes[d + 1][0::2] + sizes[d + 1][1::2]
        sizes[d] = np.where(tree.level_codes[d] == 3, 1, 1 + child_sum)
    return sizes


# --------------------------------------------------------------------------- #
# preorder serialization
# --------------------------------------------------------------------------- #

def to_preorder(tree: KdTree) -> np.ndarray:
    """Emit the unbalanced preorder code array (uint8 codes, unpacked), exactly
    as ``convertToPreorder`` orders it: node, left subtree, right subtree;
    pruned (code 3) subtrees collapse to one node; leaf chains follow their
    leaf.  A parallel tree-flatten: subtree sizes bottom-up, preorder offsets
    top-down (pos(left) = pos(node)+1, pos(right) = pos(left)+size(left))."""
    D = tree.orig_depth
    sizes = _subtree_sizes(tree)
    total = int(sizes[0][0])
    out = np.empty(total, dtype=np.uint8)

    gidx = np.zeros(1, dtype=np.int64)  # breadth-first indices of emitted nodes
    pos = np.zeros(1, dtype=np.int64)   # their preorder positions
    for d in range(D + 1):
        codes = tree.level_codes[d][gidx]
        out[pos] = codes
        if d < D:
            keep = codes != 3
            pg, pp = gidx[keep], pos[keep]
            left_g, right_g = 2 * pg, 2 * pg + 1
            left_pos = pp + 1
            right_pos = left_pos + sizes[d + 1][left_g]
            gidx = np.empty(2 * pg.shape[0], dtype=np.int64)
            gidx[0::2], gidx[1::2] = left_g, right_g
            pos = np.empty_like(gidx)
            pos[0::2], pos[1::2] = left_pos, right_pos
        else:
            chains = tree.chain_codes[gidx]
            lens = np.sum(chains != NO_NODE, axis=1)
            for step in range(chains.shape[1]):
                sel = lens > step
                if not sel.any():
                    break
                out[pos[sel] + 1 + step] = chains[sel, step]
    return out


def save(tree: KdTree, path: str) -> None:
    """Reference binary format (``VolumeKdTree_recover.cpp:521-552``):
    rootMin(3×i64) rootMax(3×i64) maxTreeDepth(i32) origTreeDepth(i32)
    X Y Z numActiveNodes (4×i64) distanceMap(maxDepth+1 bytes) packed codes."""
    X, Y, Z = tree.dims
    pre = to_preorder(tree)
    packed = pack2_np(pre)
    with open(path, "wb") as f:
        f.write(struct.pack("<3q", 0, 0, 0))
        f.write(struct.pack("<3q", X, Y, Z))
        f.write(struct.pack("<ii", tree.max_depth, tree.orig_depth))
        f.write(struct.pack("<4q", X, Y, Z, len(pre)))
        f.write(tree.distance_map.tobytes())
        f.write(packed.tobytes())


def open_tree(path: str) -> dict:
    """Read the reference format; returns raw fields (preorder codes unpacked).
    (Reconstructing the level-structured layout requires a preorder walk —
    see ``preorder_to_levels``.)"""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    root_min = struct.unpack_from("<3q", data, off); off += 24
    root_max = struct.unpack_from("<3q", data, off); off += 24
    max_depth, orig_depth = struct.unpack_from("<ii", data, off); off += 8
    X, Y, Z, num_active = struct.unpack_from("<4q", data, off); off += 32
    dm = np.frombuffer(data, dtype=np.uint8, count=max_depth + 1, offset=off)
    off += max_depth + 1
    packed = np.frombuffer(data, dtype=np.uint8, offset=off)
    codes = unpack2_np(packed, num_active)
    return dict(root_min=root_min, root_max=root_max, max_depth=max_depth,
                orig_depth=orig_depth, dims=(X, Y, Z),
                num_active_nodes=num_active, distance_map=np.array(dm),
                preorder=codes)


# --------------------------------------------------------------------------- #
# level cut (vectorized decode)
# --------------------------------------------------------------------------- #

def level_cut(tree: KdTree, cut_depth: int | None = None) -> np.ndarray:
    """Decode a level cut back to a dense (Z, Y, X) uint8 volume.

    Replaces the sequential preorder stack machine (``levelCut``,
    ``VolumeKdTree_recover.cpp:726-835``) with a level-by-level clamped-Δ
    accumulation: scalar(root) = distanceMap[0] unconditionally (``:743`` —
    a reference quirk kept for parity), child scalar = clamp(parent ± Δ[d])
    by code, frozen below code-3 nodes and below the cut depth; leaf scalars
    scatter back through the inverse leaf permutation (pure reshape)."""
    D = tree.orig_depth
    if cut_depth is None:
        cut_depth = tree.max_depth
    dm = tree.distance_map.astype(np.int32)

    scalars = np.array([dm[0]], dtype=np.int32)
    frozen = np.array([tree.level_codes[0][0] == 3])
    for d in range(1, D + 1):
        parent_s = np.repeat(scalars, 2)
        parent_f = np.repeat(frozen, 2)
        codes = tree.level_codes[d]
        if d > cut_depth:
            scalars = parent_s
            frozen = parent_f
            continue
        s = np.where(codes == 1, np.minimum(255, parent_s + dm[d]),
                     np.where(codes == 2, np.maximum(0, parent_s - dm[d]), parent_s))
        scalars = np.where(parent_f, parent_s, s)
        frozen = parent_f | (codes == 3)

    if cut_depth > D and tree.chain_codes is not None:
        chains = tree.chain_codes
        for step in range(min(chains.shape[1], cut_depth - D)):
            d = D + 1 + step
            codes = chains[:, step]
            live = ~frozen & (codes != NO_NODE)
            s = np.where(codes == 1, np.minimum(255, scalars + dm[d]),
                         np.where(codes == 2, np.maximum(0, scalars - dm[d]), scalars))
            scalars = np.where(live, s, scalars)
            frozen = frozen | (codes == 3) | (codes == NO_NODE)

    return leaves_to_volume(scalars.astype(np.uint8), tree.dims, tree.schedule)


# --------------------------------------------------------------------------- #
# error queries (VolumeKdTree_recover.cpp:386-413)
# --------------------------------------------------------------------------- #

def measure_max_error(decoded: np.ndarray, original: np.ndarray) -> int:
    """Max |decoded - original| (``measureMaxError``, ``:386-392``)."""
    return int(np.abs(decoded.astype(np.int32) - original.astype(np.int32)).max())


def measure_mean_error(decoded: np.ndarray, original: np.ndarray) -> float:
    """Mean L1 error (``measureMeanError``, ``:394-401``)."""
    return float(np.abs(decoded.astype(np.float64) - original.astype(np.float64)).mean())


def query_error(decoded: np.ndarray, original: np.ndarray) -> np.ndarray:
    """|error| as a renderable uint8 volume (``queryError``, ``:404-411``) —
    the reference's error-field visualization path (``main.cpp:285-292``)."""
    return np.abs(decoded.astype(np.int32) - original.astype(np.int32)).astype(np.uint8)


def preorder_to_levels(preorder: np.ndarray, orig_depth: int, max_depth: int):
    """Inverse of :func:`to_preorder`: rebuild (level_codes, chain_codes)
    from an unpacked preorder code stream by walking the SAME stack automaton
    the decoders use (``reference_impl.decode_preorder``; native at
    ``kdtree_native.cpp:decode_preorder_native``), recording each node's
    code at its (depth, breadth-first index).  Unvisited slots (descendants
    of pruned nodes) stay code 3 / NO_NODE — never read by any consumer."""
    chain_len = max_depth - orig_depth
    try:
        from ..native import kdtree_native

        levels_flat, chains = kdtree_native.preorder_to_levels(
            pack2_np(preorder), len(preorder), orig_depth, max_depth,
            chain_len)
    except OSError:
        levels_flat = np.full((1 << (orig_depth + 1)) - 1, 3, np.uint8)
        chains = np.full((1 << orig_depth, chain_len), NO_NODE, np.uint8)
        stack = [(0, 0, 0)]  # (preorder idx, depth, breadth-first idx)
        n = len(preorder)
        while stack:
            idx, depth, bf = stack[-1]
            code = int(preorder[idx])
            if depth <= orig_depth:
                levels_flat[(1 << depth) - 1 + bf] = code
            elif depth - orig_depth - 1 < chain_len:
                chains[bf, depth - orig_depth - 1] = code
            if code == 3 or depth == max_depth:
                stack.pop()
                nxt = idx + 1
                if nxt < n and stack:
                    pd, pdep, pbf = stack.pop()
                    stack.append((nxt, pdep + 1, 2 * pbf + 1))
            else:
                if depth >= orig_depth:
                    stack.pop()
                cbf = 2 * bf if depth < orig_depth else bf
                stack.append((idx + 1, depth + 1, cbf))
    level_codes = [levels_flat[(1 << d) - 1:(1 << (d + 1)) - 1]
                   for d in range(orig_depth + 1)]
    return level_codes, chains


def open_tree_full(path: str, verify: bool = True) -> KdTree:
    """Open a checkpoint as a full level-structured :class:`KdTree` (so the
    compressed-renderer path — device decode, tree-metadata occupancy, slab
    pools, cut-depth control — survives resume).

    ``verify`` re-serializes the reconstructed tree and checks byte equality
    with the stream, proving the inverse walk was faithful."""
    raw = open_tree(path)
    X, Y, Z = raw["dims"]
    orig_depth, max_depth = raw["orig_depth"], raw["max_depth"]
    level_codes, chains = preorder_to_levels(raw["preorder"], orig_depth,
                                             max_depth)
    tree = KdTree(
        dims=(X, Y, Z), orig_depth=orig_depth, max_depth=max_depth,
        distance_map=raw["distance_map"].copy(), level_codes=level_codes,
        chain_codes=chains, schedule=split_schedule(X, Y, Z),
        num_active_nodes=raw["num_active_nodes"])
    if verify:
        again = to_preorder(tree)
        if not np.array_equal(again, raw["preorder"]):
            raise ValueError(f"preorder round-trip mismatch for {path}")
    return tree
