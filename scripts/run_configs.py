"""Run the five BASELINE.json benchmark configs end-to-end and emit one JSON
metrics line per config (naming the platform, device kind and count; the
script fails without a GPU).  Synthetic data stands in when the
Richtmyer-Meshkov bricks are absent (pass --rm-dir to use the real dataset).

  1. 64^3 sphere, dense 256^2 compositing raycast
  2. single 256^3 brick, dense raycast + isosurface, 512^2
  3. 256^3 with kd-tree compression + device decode, tolerance sweep, 512^2
  4. multi-brick (8), differentiable TF fit to a target image, 1024^2
  5. multi-timestep progressive stream (4 steps), z-sharded mesh, 1024^2
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from volumerenderer_tpu import (Camera, as_normalized_volume, backend,
                                generate_rays)
from volumerenderer_tpu.codecs import kdtree as K
from volumerenderer_tpu.diff.transfer import TFParams, tf_loss
from volumerenderer_tpu.io.bricks import BrickGrid, file_brick_source, load_bricks, synthetic_brick_source
from volumerenderer_tpu.io.streaming import TimestepStreamer
from volumerenderer_tpu.io.synthetic import sphere_volume, turbulence_volume
from volumerenderer_tpu.models import (best_isosurface_renderer,
                                       best_renderer, plan_compositing)
from volumerenderer_tpu.models.compressed import CompressedRenderer


def timed(fn):
    """(seconds of the second call, output); each call ends in
    ``block_until_ready``, the first one compiles."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return time.perf_counter() - t0, out


def emit(config, **kv):
    print(json.dumps({"config": config, **kv, **backend.device_info()}),
          flush=True)


def config1():
    vol = as_normalized_volume(sphere_volume((64, 64, 64)))
    rays = generate_rays(Camera(width=256, height=256))
    render = best_renderer()
    dt, _ = timed(lambda: render(vol, rays.entry_uv, rays.direction,
                                 rays.hit))
    emit(1, rays_per_s=256 * 256 / dt, seconds=dt,
         compositing_path=backend.compositing_impl())


def config2(brick):
    """Single 256^3 brick, dense raycast + isosurface shading at 512^2,
    through the renderers the backend chooses."""
    vol = as_normalized_volume(brick)
    Z, Y, X = vol.shape
    rays = generate_rays(Camera(width=512, height=512))
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit,
                            (X, Y, Z))
    dt_c, _ = timed(lambda: plan.render(vol))
    render_iso = best_isosurface_renderer()
    dt_i, _ = timed(lambda: render_iso(vol, rays.entry_uv, rays.direction,
                                       rays.hit))
    emit(2, compositing_rays_per_s=512 * 512 / dt_c,
         compositing_path=plan.impl,
         isosurface_rays_per_s=512 * 512 / dt_i,
         isosurface_path=backend.isosurface_impl())


def config3(brick):
    rays = generate_rays(Camera(width=512, height=512))
    for tol in (1, 4, 8):
        t0 = time.perf_counter()
        tree = K.build(brick, tolerance=tol, max_epochs=2)
        build_s = time.perf_counter() - t0
        r = CompressedRenderer(tree)
        dec = np.asarray(r.volume_at()) * 255.0
        err = np.abs(dec - brick.astype(np.float64))
        dt, _ = timed(lambda: r.render(rays))
        # compressed-domain resident bytes: packed tree + sparse slab pool
        # vs the dense u8 brick
        state = r.shade_pool_at()
        resident = ((tree.num_active_nodes + 3) // 4 + state.pool.nbytes
                    + state.slab_map.nbytes)
        # which decode served volume_at(): the host serves only after a
        # device decode ran out of memory
        decode = "device" if r.decoded_on_device() else "host"
        emit(3, tolerance=tol, build_s=build_s, decode=decode,
             bits_per_voxel=2 * tree.num_active_nodes / brick.size,
             max_err=float(err.max()), mean_err=float(err.mean()),
             resident_bytes=int(resident),
             resident_vs_dense_u8=float(resident / brick.size),
             rays_per_s=512 * 512 / dt)


def config4(source, grid, width=1024):
    """BASELINE config 4: multi-brick timestep (8 bricks) assembled ->
    hashed-kdtree build -> DEVICE hashed decode -> differentiable
    transfer-function fit at 1024^2 (jax.grad through the jnp march)."""
    from volumerenderer_tpu.codecs import hashed as HC

    multi = load_bricks(source, grid, 8, 2, 2, 2, 273)
    t0 = time.perf_counter()
    tree = HC.build(multi, tolerance=4)
    build_s = time.perf_counter() - t0
    dev = HC.to_device_hashed(tree)
    t0 = time.perf_counter()
    vol = as_normalized_volume(HC.level_cut_device_hashed(tree, dev))
    vol.block_until_ready()
    decode_s = time.perf_counter() - t0
    err = np.abs(np.asarray(vol, np.float64) * 255.0 - multi.astype(np.float64))

    rays = generate_rays(Camera(width=width, height=width))
    target = jnp.full(rays.entry_uv.shape[:-1] + (3,), 0.5, jnp.float32)
    params = TFParams.reference()
    loss_fn = jax.jit(lambda p: tf_loss(p, vol, rays.entry_uv, rays.direction,
                                        rays.hit, target, max_samples=64))
    grad_fn = jax.jit(jax.grad(lambda p: tf_loss(
        p, vol, rays.entry_uv, rays.direction, rays.hit, target,
        max_samples=64)))
    losses = []
    t0 = time.perf_counter()
    for _ in range(5):
        g = grad_fn(params)
        params = jax.tree.map(lambda p, gg: p - 0.05 * gg, params, g)
        losses.append(float(loss_fn(params)))
    fit_s = (time.perf_counter() - t0) / 5
    emit(4, hashed_build_s=build_s, hashed_device_decode_s=decode_s,
         hashed_max_err=float(err.max()), tf_fit_losses=losses,
         fit_step_s=fit_s, fit_path="jnp",
         improved=bool(losses[-1] < losses[0]))


def config5(source, grid, width=1024):
    """BASELINE config 5: 4-timestep progressive stream, a 1024^2 render
    per timestep and a TF-gradient step per timestep.  With >= 4 devices
    the render runs from the brick-sharded layout ((bz=2, by=2) mesh) and
    the gradient step psums over a (dp=1, rays) mesh; with one device both
    run unsharded."""
    from volumerenderer_tpu.parallel.bricks import (make_brick_mesh,
                                                    render_bricksharded,
                                                    shard_volume)
    from volumerenderer_tpu.parallel.sharding import make_mesh, tf_fit_step

    n_dev = len(jax.devices())
    streamer = TimestepStreamer(source, grid, timesteps=[270, 271, 272, 273],
                                num_bricks=grid.num_bricks(), I=grid.grid[0],
                                J=grid.grid[1], K_bricks=grid.grid[2],
                                tolerance=4, max_epochs=1, prefetch=2)
    rays = generate_rays(Camera(width=width, height=width))
    target = jnp.full(rays.entry_uv.shape[:-1] + (3,), 0.5, jnp.float32)
    params = TFParams.reference()
    bmesh = make_brick_mesh((2, 2, 1)) if n_dev >= 4 else None
    rmesh = make_mesh(min(n_dev, 4)) if n_dev > 1 else None
    render = best_renderer()

    losses = []
    t0 = time.perf_counter()
    n = 0
    for t, renderer in streamer:
        vol = renderer.volume_at()
        if bmesh is not None:
            rgb, _ = render_bricksharded(bmesh, shard_volume(bmesh, vol),
                                         rays.entry_uv, rays.direction,
                                         rays.hit, max_samples=64)
        else:
            rgb, _ = render(vol, rays.entry_uv, rays.direction, rays.hit, 64)
        jax.block_until_ready(rgb)
        if rmesh is not None:
            params, loss = tf_fit_step(rmesh, params, vol,
                                       rays.entry_uv[None],
                                       rays.direction[None], rays.hit[None],
                                       target[None], lr=0.05, max_samples=32)
        else:
            g = jax.grad(lambda p: tf_loss(
                p, vol, rays.entry_uv, rays.direction, rays.hit, target,
                max_samples=32))(params)
            loss = tf_loss(params, vol, rays.entry_uv, rays.direction,
                           rays.hit, target, max_samples=32)
            params = jax.tree.map(lambda p, gg: p - 0.05 * gg, params, g)
        losses.append(float(loss))
        n += 1
    dt = time.perf_counter() - t0
    assert all(np.isfinite(losses)), losses
    emit(5, timesteps=n, total_s=dt, per_timestep_s=dt / n, width=width,
         grad_losses=losses, grad_allreduce=rmesh is not None,
         layout="bricksharded(2,2)" if bmesh is not None else "one_device")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rm-dir", default=None, help="Richtmyer-Meshkov all_bricks dir")
    ap.add_argument("--small", action="store_true", help="CI-sized volumes")
    args = ap.parse_args()
    backend.require_gpu()
    backend.enable_compile_cache()

    if args.small:
        brick = turbulence_volume((64, 64, 64), seed=273)
        grid = BrickGrid(brick_dims=(16, 16, 16), grid=(2, 2, 2))
        src4 = synthetic_brick_source(grid)
        grid4 = grid
        width4 = 128
    elif args.rm_dir:
        rm_grid = BrickGrid()
        src = file_brick_source(args.rm_dir, rm_grid)
        brick = load_bricks(src, rm_grid, 1, 1, 1, 1, 273)
        grid = rm_grid
        src4, grid4, width4 = src, rm_grid, 1024
    else:
        brick = turbulence_volume((256, 256, 256), seed=273)
        grid = BrickGrid(brick_dims=(64, 64, 64), grid=(2, 2, 2))
        src4, grid4, width4 = synthetic_brick_source(grid), grid, 1024

    config1()
    config2(brick)
    config3(brick)
    config4(src4, grid4, width=width4)
    config5(synthetic_brick_source(grid), grid, width=width4)


if __name__ == "__main__":
    main()
