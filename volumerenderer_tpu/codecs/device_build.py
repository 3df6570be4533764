"""Device-side kd-tree compression.

The host codec (``kdtree.py``) mirrors the reference's CPU build.  This module
runs the data-parallel passes on device as fused XLA programs — the device
compression path for large volumes:

* PASS 1 pyramid: pairwise min/max reductions over the transpose-derived leaf
  order (pure reshapes — zero gathers);
* PASS 2 per-level evaluation: vectorized ``encodeNode`` in exact int32
  arithmetic; level error sums are chunked int32 partials (each chunk sum
  < 2^31) combined exactly as Python ints on the host — the GD loop's scalar
  control flow (few epochs per level) stays on host;
* PASS 3 prune and PASS 4 branch growth: boolean pyramids / 7-step unrolled
  scans on device.

Δ-seeding is inherently sequential (running mean over level order).  Two modes:
``seed_mode='exact'`` transfers the level to the host scan (bit-identical to
the host build); ``'parallel'`` uses a device-side fixed-point approximation
(start from the mean parent distance, re-decide add/sub membership, iterate) —
the GD refinement usually converges to the same Δ, and the output quality is
equivalent (tested); documented deviation when it differs.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .kdtree import (ADD_LEVEL_DISTANCES, GAMMA, H, KdTree, MAX_ABS_STEP,
                     MAX_ADD_LEVELS, NO_NODE, _count_active, seed_level,
                     split_schedule, _leaf_axes_perm)

__all__ = ["build_device"]

_CHUNK = 1 << 14  # int32 chunk sums: 2^14 * 255^2 < 2^31


@partial(jax.jit, static_argnames=("distance",))
def _encode_level_dev(truth, parent, distance: int):
    t = truth.astype(jnp.int32)
    p = parent.astype(jnp.int32)
    none_err = jnp.abs(p - t)
    add_est = jnp.minimum(255, p + distance)
    add_err = jnp.abs(add_est - t)
    sub_est = jnp.maximum(0, p - distance)
    sub_err = jnp.abs(sub_est - t)
    min_err = jnp.minimum(sub_err, jnp.minimum(none_err, add_err))
    codes = jnp.where(none_err == min_err, 0,
                      jnp.where(add_err == min_err, 1, 2)).astype(jnp.uint8)
    recon = jnp.where(codes == 0, p, jnp.where(codes == 1, add_est, sub_est))
    return codes, recon, min_err


@partial(jax.jit, static_argnames=("distance",))
def _err_sq_chunks(truth, parent, distance: int):
    """Exact squared-error sum as int32 chunk partials."""
    _, _, min_err = _encode_level_dev(truth, parent, distance)
    n = min_err.shape[0]
    pad = (-n) % _CHUNK
    e = jnp.pad(min_err, (0, pad))
    return jnp.sum((e * e).reshape(-1, _CHUNK), axis=1, dtype=jnp.int32)


def _mean_sq_err_dev(truth, parent, distance: int) -> float:
    chunks = np.asarray(_err_sq_chunks(truth, parent, int(distance)))
    return sum(int(c) for c in chunks) / truth.shape[0]  # exact Python ints


@jax.jit
def _seed_parallel(truth, parent, iters: int = 4):
    """Fixed-point approximation of the running-mean seeding: md is a single
    scalar; membership (add/sub chosen) is re-decided against it each round."""
    t = truth.astype(jnp.float32)
    p = parent.astype(jnp.float32)
    pd = jnp.abs(p - t)
    md = jnp.maximum(jnp.mean(pd), 1e-6)

    def body(_, md):
        none_err = pd
        add_err = jnp.abs(jnp.minimum(255.0, p + md) - t)
        sub_err = jnp.abs(jnp.maximum(0.0, p - md) - t)
        min_err = jnp.minimum(sub_err, jnp.minimum(none_err, add_err))
        chosen = min_err != none_err  # add/sub wins (ties -> none, as reference)
        s = jnp.sum(jnp.where(chosen, pd, 0.0))
        c = jnp.sum(chosen)
        return jnp.where(c > 0, s / c, 0.0)

    return jax.lax.fori_loop(0, iters, body, md)


def _gd_fit_level_dev(truth, parent, max_epochs: int, seed: float):
    """Host scalar control flow (identical to kdtree.gd_fit_level), device
    evaluations."""
    epoch = 0
    cur = seed
    prev_dist, prev_step, prev_err = 0.0, 255.0, 65025.0
    cur_err = cur_df = cur_step = 0.0
    while epoch < max_epochs and abs(prev_step) >= 0.5:
        if epoch != 0:
            prev_dist, prev_err, prev_df, prev_step = cur, cur_err, cur_df, cur_step
            cur = float(np.floor(min(255.0, max(0.0, prev_dist + prev_step)) + 0.5))
            if cur == prev_dist:
                break
        cur_err = _mean_sq_err_dev(truth, parent, int(cur))
        if cur_err < 1.0:
            break
        if epoch != 0 and cur_err > prev_err:
            cur_err, cur, cur_df = prev_err, prev_dist, prev_df
            cur_step = prev_step / 2.0
            epoch += 1
            continue
        e_lo = _mean_sq_err_dev(truth, parent, int(max(0.0, cur - H)))
        e_hi = _mean_sq_err_dev(truth, parent, int(min(255.0, cur + H)))
        cur_df = (e_hi - e_lo) / (2.0 * H)
        cur_step = max(-MAX_ABS_STEP, min(MAX_ABS_STEP, -GAMMA * cur_df))
        epoch += 1
    codes, recon, _ = _encode_level_dev(truth, parent, int(cur))
    return int(cur), codes, recon


def build_device(volume, tolerance: int = 6, max_epochs: int = 5,
                 seed_mode: str = "exact") -> KdTree:
    """Compress a (Z, Y, X) uint8 volume with the heavy passes on device.

    Returns a host ``KdTree`` (codes transferred back) interoperable with
    every other API (level_cut, save, CompressedRenderer, ...)."""
    volume = jnp.asarray(volume, dtype=jnp.uint8)
    Z, Y, X = volume.shape
    schedule = split_schedule(X, Y, Z)
    D = len(schedule)
    max_depth = D + MAX_ADD_LEVELS

    # PASS 1 — pyramid on device
    perm, (nz, ny, nx) = _leaf_axes_perm(X, Y, Z, schedule)
    leaves = volume.reshape((2,) * (nz + ny + nx)).transpose(perm).reshape(-1)
    temp = [None] * (D + 1)
    temp[D] = leaves
    lmin = lmax = leaves
    for d in range(D - 1, -1, -1):
        lmin = jnp.minimum(lmin[0::2], lmin[1::2])
        lmax = jnp.maximum(lmax[0::2], lmax[1::2])
        temp[d] = ((lmin.astype(jnp.uint16) + lmax) // 2).astype(jnp.uint8)

    # PASS 2 — Δ fit per level
    distance_map = np.zeros(max_depth + 1, dtype=np.uint8)
    level_codes = []
    recon = None
    for d in range(D + 1):
        truth = temp[d]
        parent = jnp.zeros(1, jnp.int32) if d == 0 else jnp.repeat(recon, 2)
        if seed_mode == "exact":
            seed = seed_level(np.asarray(truth), np.asarray(parent))
        else:
            raw = float(_seed_parallel(truth, parent))
            seed = float(np.floor(raw + 0.5))
        dist, codes, recon = _gd_fit_level_dev(truth, parent, max_epochs, seed)
        distance_map[d] = dist
        level_codes.append(codes)
    for i, dist in enumerate(ADD_LEVEL_DISTANCES):
        distance_map[D + 1 + i] = dist

    # PASS 3 — prune pyramid on device
    leaf_truth = temp[D].astype(jnp.int32)
    err_ok = jnp.abs(recon - leaf_truth) < tolerance
    pruned = (level_codes[D] == 0) & err_ok
    level_codes[D] = jnp.where(pruned, 3, level_codes[D]).astype(jnp.uint8)
    for d in range(D - 1, -1, -1):
        child_ok = pruned[0::2] & pruned[1::2]
        pruned = (level_codes[d] == 0) & child_ok
        level_codes[d] = jnp.where(pruned, 3, level_codes[d]).astype(jnp.uint8)

    # PASS 4 — branch growth: 7-step unrolled scan on device
    n = 1 << D
    chains = jnp.full((n, MAX_ADD_LEVELS), NO_NODE, dtype=jnp.uint8)
    rm = recon
    err = jnp.abs(rm - leaf_truth)
    leaf_code = level_codes[D]
    active = (leaf_code != 3) & (err > tolerance)
    needs_terminal = (leaf_code != 3) & ~active
    chains = chains.at[:, 0].set(jnp.where(needs_terminal, 3, chains[:, 0]))
    zero_start = jnp.full(n, -1, jnp.int32)
    for pos in range(MAX_ADD_LEVELS):
        dist = int(distance_map[D + 1 + pos])
        codes, new_rm, _ = _encode_level_dev(leaf_truth, rm, dist)
        # only active leaves take this step
        rm = jnp.where(active, new_rm, rm)
        chains = chains.at[:, pos].set(jnp.where(active, codes, chains[:, pos]))
        zero_start = jnp.where(active & (codes == 0),
                               jnp.where(zero_start == -1, pos, zero_start),
                               jnp.where(active, -1, zero_start))
        still = jnp.abs(rm - leaf_truth) > tolerance
        finished = active & ~still
        if pos + 1 < MAX_ADD_LEVELS:
            chains = chains.at[:, pos + 1].set(
                jnp.where(finished, 3, chains[:, pos + 1]))
        active = active & still
    # retro-prune trailing zero runs
    col = jnp.arange(MAX_ADD_LEVELS)[None, :]
    run = (zero_start[:, None] >= 0) & (col >= zero_start[:, None]) & (chains == 0)
    chains = jnp.where(run, 3, chains)

    tree = KdTree(
        dims=(X, Y, Z), orig_depth=D, max_depth=max_depth,
        distance_map=distance_map,
        level_codes=[np.asarray(c) for c in level_codes],
        chain_codes=np.asarray(chains), schedule=schedule,
        tolerance=tolerance, max_epochs=max_epochs,
        leaf_recon=np.asarray(rm), leaf_truth=np.asarray(temp[D]),
    )
    tree.num_active_nodes = _count_active(tree)
    return tree
