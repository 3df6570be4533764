"""Headline benchmark: steady-state rays/s for 1024² front-to-back
compositing renders of a 256³ volume (BASELINE.json "metric").

Protocol: a 16-frame orbit sequence (camera azimuth sweep, plan-once /
render-many, the plans built before the timer starts) is rendered frame by
frame and timed over whole sweeps, each ending in ``block_until_ready`` —
the analogue of the reference's 500-frame "LOOP" timing window
(``main.cpp:373-411``, ``DebugTimer.cpp:20-27``).

Also reports (one JSON line each, before the headline): the isosurface
path, the compressed-domain pooled path and the voxel-gradient step at the
same configuration.  The headline compositing line is printed LAST.  Every
line names the platform, device kind and device count; without a GPU the
script fails.

``vs_baseline`` is reported against a nominal 1e8 rays/s — the reference
publishes no numbers (SURVEY.md §6, BASELINE.json "published": {}).
"""
from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

from volumerenderer_tpu import backend

NOMINAL_BASELINE_RAYS_PER_S = 1.0e8
N_FRAMES = 16
W = H = 1024


def _time_sweep(sweep_fn, reps: int = 3, n_frames: int = N_FRAMES):
    """Seconds per frame: min over ``reps`` sweeps of ``sweep_fn()``, whose
    outputs are waited for with ``block_until_ready``, after one warm-up
    sweep that compiles.  ``n_frames`` MUST match the frames a sweep
    renders."""
    jax.block_until_ready(sweep_fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(sweep_fn())
        times.append(time.perf_counter() - t0)
    return min(times) / n_frames


def _emit(metric, value, unit="rays/s", vs_baseline=None):
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_baseline": (value / NOMINAL_BASELINE_RAYS_PER_S
                        if vs_baseline is None else vs_baseline),
        **backend.device_info(),
    }), flush=True)


def bench_isosurface(vol, rays_list):
    """Isosurface march + shading at the volume's median sample — a surface
    that exists in the synthetic turbulence field (the reference's 40/255
    targets the Richtmyer-Meshkov data; here it is an almost empty
    surface)."""
    from volumerenderer_tpu.models import best_isosurface_renderer

    render = best_isosurface_renderer()
    iso = float(jnp.median(vol))
    dt = _time_sweep(lambda: [render(vol, r.entry_uv, r.direction, r.hit,
                                     iso) for r in rays_list])
    _emit("iso_rays_per_s_per_chip_1024sq_256cube", W * H / dt)


def bench_voxel_grad(vol, plan):
    """Full voxel-gradient step (forward + all TF-param grads + voxel
    cotangent volume, ``diff.vjp.render_tf_o1``) against one forward frame.
    Emits the ratio (lower is better; value = step/frame)."""
    from volumerenderer_tpu.diff.transfer import TFParams
    from volumerenderer_tpu.diff.vjp import render_tf_o1

    params = TFParams.reference()
    target = jnp.full(plan.hit.shape + (3,), 0.5, jnp.float32)

    @jax.jit
    def grad_step(params, vol):
        def loss(p, v):
            rgb, _ = render_tf_o1(p, v, plan.entry_uv, plan.direction,
                                  plan.hit, plan.max_samples, True)
            return jnp.mean((rgb - target) ** 2)

        return jax.grad(loss, argnums=(0, 1))(params, vol)

    t_fwd = _time_sweep(lambda: plan.render(vol), n_frames=1)
    t_step = _time_sweep(lambda: grad_step(params, vol), n_frames=1)
    _emit("voxelgrad_step_frames_1024sq_256cube", t_step / t_fwd,
          unit="forward-frames/step",
          vs_baseline=3.0 / max(t_step / t_fwd, 1e-9))


def bench_pooled(vol, rays_list):
    """Compressed-domain march over the sparse z-slab pool
    (``ops.sampling.build_shade_pool``, ``sample_pooled``)."""
    from volumerenderer_tpu.ops.raycast import render_compositing
    from volumerenderer_tpu.ops.sampling import build_shade_pool, sample_pooled

    state = build_shade_pool(vol)
    dt = _time_sweep(lambda: [render_compositing(
        state, r.entry_uv, r.direction, r.hit, sample=sample_pooled)
        for r in rays_list])
    _emit("pooled_rays_per_s_per_chip_1024sq_256cube", W * H / dt)


def main():
    backend.require_gpu()
    backend.enable_compile_cache()
    from volumerenderer_tpu import (as_normalized_volume, generate_rays,
                                    orbit_camera)
    from volumerenderer_tpu.io.synthetic import turbulence_volume
    from volumerenderer_tpu.models import plan_compositing

    vol = as_normalized_volume(turbulence_volume((256, 256, 256), seed=0))
    Z, Y, X = vol.shape
    rays_list = [generate_rays(orbit_camera(2.0 * i, W, H))
                 for i in range(N_FRAMES)]
    plans = [plan_compositing(r.entry_uv, r.direction, r.hit, (X, Y, Z))
             for r in rays_list]

    bench_isosurface(vol, rays_list)
    bench_pooled(vol, rays_list)
    bench_voxel_grad(vol, plans[0])

    dt = _time_sweep(lambda: [p.render(vol) for p in plans])
    _emit("rays_per_s_per_chip_1024sq_256cube", W * H / dt)


if __name__ == "__main__":
    main()
