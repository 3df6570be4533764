"""Drive the renderer's main path once on one GPU and check every result.

    python chip_smoke.py               # phases (a)-(f) on one GPU
    python chip_smoke.py --four-gpus   # the sharded paths on four GPUs

Phases, each through the entry points a user calls, at the repo's sizes:

  a  headline compositing: 1024² orbit frame of a 256³ seeded turbulence
     volume through ``models.plan_compositing(...).render`` (the Triton
     march on a GPU) against XLA's jnp march, the jnp march against the
     GLSL oracle (``tests/oracles``) on 4096 rays, and the 300-step sphere
     frame, kernel against jnp;
  b  isosurface through ``best_isosurface_renderer()`` at the volume's
     median and at the reference's 40/255, against the GLSL oracle;
  c  ``app.run(AppConfig())`` in both render modes (kd build, device
     level-cut decode, 1600×1200 render);
  d  compressed-domain render ``CompressedRenderer.make_plan(rays,
     pooled=True)()`` in both modes against the dense jnp render;
  e  one transfer-function and voxel gradient step through
     ``diff.vjp.render_tf_o1`` at 1024², and its gradients against
     autodiff through ``diff.transfer.render_tf`` at 256²;
  f  the reference's scale: a 2048×2048×768 volume from 384 bricks
     (``main.cpp:242``), one 1600×1200 frame per mode, kernel against jnp.

``--four-gpus`` runs only the brick-sharded and z-sharded renders of frame
(f)'s volume and the sharded transfer-function step, each against the same
computation on one card.

Before any phase the script prints the card's name and power limit.  Per
phase it prints one JSON line: compile and warm seconds, the process's peak
device memory so far, and the implementation the backend chose; every
check prints its value beside its limit.  Its last line is the device
summary.  It exits non-zero when JAX finds no GPU, when a phase raises, or
when a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

# Tolerances, each with its reason.
# Kernel vs jnp and jnp vs the GLSL oracle: the oracle bound pinned in
# tests/test_raycast.py.  FMA contraction may move alpha across 0.99 by an
# ulp, so a ray may stop one step earlier on one side ("early-out flip");
# such rays are counted, must end with alpha within EARLY_OUT_BAND of the
# threshold or above on both sides, and may be at most MAX_FLIP_SHARE of
# the frame.
RGB_TOL = 2e-4
EARLY_OUT_BAND = 1e-5
MAX_FLIP_SHARE = 1e-4
# Isosurface: hit masks may differ where a sample lands within an ulp of
# the isovalue; RGB goes through pow(., 250), which amplifies ulps
# (tests/test_raycast.py bound).
ISO_MASK_AGREE = 0.999
ISO_RGB_TOL = 5e-3
# Pooled vs dense: both sample 8-bit values exactly; the packed sampler
# interpolates in 0..255 units and scales once, dense scales first, so
# samples differ by float rounding only.
POOLED_TOL = 2e-6
# Gradients: norm-relative error of the O(1) VJP (which inverts the alpha
# recurrence) against autodiff through the stored scan.
GRAD_REL_TOL = 1e-4
# Sharded vs one card: the bounds pinned in tests/test_brick_sharding.py,
# tests/test_context_parallel.py and tests/test_transfer_sharding.py.
SHARD_TOL = 2e-6
TF_STEP_TOL = 1e-6


class CheckFailed(AssertionError):
    pass


def check(name: str, value, limit, ok: bool):
    print(f"check {name}: {value} (limit {limit}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {value} (limit {limit})")


def timed(fn, reps: int = 3):
    """(output, compile_s, warm_s): the first call's seconds, then the
    median of ``reps`` calls, each ending in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, compile_s, statistics.median(times)


def compare_compositing(name, rgb_a, alpha_a, rgb_b, alpha_b, tol=RGB_TOL):
    """Per-ray max |Δ| over rgb and alpha within ``tol``, except early-out
    flips (see the tolerances above)."""
    rgb_a, rgb_b = np.asarray(rgb_a), np.asarray(rgb_b)
    alpha_a, alpha_b = np.asarray(alpha_a), np.asarray(alpha_b)
    d = np.maximum(np.abs(rgb_a - rgb_b).max(axis=-1),
                   np.abs(alpha_a - alpha_b)).reshape(-1)
    near = ((alpha_a.reshape(-1) >= 0.99 - EARLY_OUT_BAND)
            & (alpha_b.reshape(-1) >= 0.99 - EARLY_OUT_BAND))
    flips = (d > tol) & near
    rest = d[~flips]
    check(f"{name} max|d| outside early-out flips",
          float(rest.max()) if rest.size else 0.0, tol,
          bool(rest.size == 0 or rest.max() <= tol))
    check(f"{name} early-out flips", int(flips.sum()),
          f"{MAX_FLIP_SHARE:.2%} of {d.size}",
          bool(flips.sum() <= MAX_FLIP_SHARE * d.size))
    return {"max_d": float(d.max()), "flips": int(flips.sum())}


def compare_isosurface(name, rgb_a, hit_a, rgb_b, hit_b):
    hit_a, hit_b = np.asarray(hit_a).reshape(-1), np.asarray(hit_b).reshape(-1)
    agree = float((hit_a == hit_b).mean())
    check(f"{name} hit-mask agreement", agree, f">= {ISO_MASK_AGREE}",
          agree >= ISO_MASK_AGREE)
    both = hit_a & hit_b
    d = np.abs(np.asarray(rgb_a).reshape(-1, 3)[both]
               - np.asarray(rgb_b).reshape(-1, 3)[both])
    dmax = float(d.max()) if d.size else 0.0
    check(f"{name} max|d rgb| where both hit", dmax, ISO_RGB_TOL,
          dmax <= ISO_RGB_TOL)
    return {"hit_agree": agree, "max_d_rgb": dmax,
            "hit_share": float(hit_a.mean())}


def check_finite(name, *arrays):
    ok = all(bool(np.isfinite(np.asarray(a)).all()) for a in arrays)
    check(f"{name} finite", ok, True, ok)


def compositing_under_test(rays, dims, interpret: bool):
    """(render(volume) -> (rgb, alpha), implementation name).  On the card
    this is ``plan_compositing`` and the backend's choice; tests on a CPU
    pass ``interpret=True`` to run the Triton kernel in the interpreter."""
    if not interpret:
        from volumerenderer_tpu.models import plan_compositing

        plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit,
                                dims)
        return plan.render, plan.impl
    from volumerenderer_tpu.ops.pallas.raycast_kernel import (
        composite_march_triton)
    from volumerenderer_tpu.ops.raycast import apply_reference_transfer

    def render(vol):
        c, a = composite_march_triton(vol, rays.entry_uv, rays.direction,
                                      rays.hit, interpret=True)
        return apply_reference_transfer(c, a), a

    return render, "triton-interpret"


def grid_pixels(h, w, n):
    """About ``n`` pixels on a regular grid over an h×w image."""
    stride = max(1, int(np.sqrt(h * w / n)))
    return [(py, px) for py in range(stride // 2, h, stride)
            for px in range(stride // 2, w, stride)]


def _camera_kwargs(cam):
    return dict(cam_pos=cam.position, front=cam.front, up=cam.up,
                fov=cam.fov_y_degrees)


# ---------------------------------------------------------------- phases


def phase_a(size=1024, dims=256, oracle_rays=4096, interpret=False, reps=7):
    from volumerenderer_tpu import (as_normalized_volume, generate_rays,
                                    orbit_camera)
    from volumerenderer_tpu.io.synthetic import sphere_volume, turbulence_volume
    from volumerenderer_tpu.ops.raycast import render_compositing
    from oracles.glsl_oracle import render_compositing_oracle

    cam = orbit_camera(0.0, size, size)
    rays = generate_rays(cam)
    out = {}
    for field, u8 in (("turbulence", turbulence_volume((dims,) * 3, seed=0)),
                      ("sphere", sphere_volume((dims,) * 3))):
        vol = as_normalized_volume(u8)
        kernel, impl = compositing_under_test(rays, (dims,) * 3, interpret)
        (rgb_k, a_k), ck, wk = timed(lambda: kernel(vol), reps)
        (rgb_j, a_j), cj, wj = timed(lambda: render_compositing(
            vol, rays.entry_uv, rays.direction, rays.hit), reps)
        check_finite(f"a/{field}", rgb_k, a_k)
        cmp = compare_compositing(f"a/{field} kernel vs jnp", rgb_k, a_k,
                                  rgb_j, a_j)
        out[field] = {"impl": impl, "kernel_compile_s": ck,
                      "kernel_warm_s": wk, "xla_compile_s": cj,
                      "xla_warm_s": wj, **cmp}
        if field == "turbulence":
            pix = grid_pixels(size, size, oracle_rays)
            rows, cols = np.asarray(pix).T
            t0 = time.perf_counter()
            rgb_o, a_o = render_compositing_oracle(
                u8, size, size, pixels=pix, **_camera_kwargs(cam))
            out["oracle"] = {"rays": len(pix),
                             "oracle_s": time.perf_counter() - t0,
                             **compare_compositing(
                                 "a/jnp vs GLSL oracle",
                                 np.asarray(rgb_j)[rows, cols],
                                 np.asarray(a_j)[rows, cols], rgb_o, a_o)}
        del vol
    return {"impl": out["turbulence"]["impl"],
            "compile_s": out["turbulence"]["kernel_compile_s"],
            "warm_s": out["turbulence"]["kernel_warm_s"], **out}


def phase_b(size=1024, dims=256, oracle_rays=1024, reps=3):
    import jax.numpy as jnp
    from volumerenderer_tpu import (as_normalized_volume, backend,
                                    generate_rays, orbit_camera)
    from volumerenderer_tpu.io.synthetic import turbulence_volume
    from volumerenderer_tpu.models import best_isosurface_renderer
    from oracles.glsl_oracle import render_isosurface_oracle

    cam = orbit_camera(0.0, size, size)
    rays = generate_rays(cam)
    u8 = turbulence_volume((dims,) * 3, seed=0)
    vol = as_normalized_volume(u8)
    render = best_isosurface_renderer()
    pix = grid_pixels(size, size, oracle_rays)
    rows, cols = np.asarray(pix).T
    out = {"impl": backend.isosurface_impl()}
    for label, iso in (("median", float(jnp.median(vol))),
                       ("40/255", 40.0 / 255.0)):
        (rgb, hit), c_s, w_s = timed(lambda: render(
            vol, rays.entry_uv, rays.direction, rays.hit, iso), reps)
        check_finite(f"b/{label}", rgb)
        rgb_o, hit_o = render_isosurface_oracle(
            u8, size, size, iso=iso, pixels=pix, **_camera_kwargs(cam))
        out[label] = {"iso": iso, "compile_s": c_s, "warm_s": w_s,
                      **compare_isosurface(
                          f"b/{label} jnp vs GLSL oracle",
                          np.asarray(rgb)[rows, cols],
                          np.asarray(hit)[rows, cols], rgb_o, hit_o)}
    out["compile_s"] = out["median"]["compile_s"]
    out["warm_s"] = out["median"]["warm_s"]
    return out


def phase_c(cfg=None):
    import dataclasses
    from volumerenderer_tpu import app, backend
    from volumerenderer_tpu.config import AppConfig

    cfg = AppConfig() if cfg is None else cfg
    out = {"impl": {"compositing": backend.compositing_impl(),
                    "isosurface": backend.isosurface_impl()}}
    for mode in ("compositing", "isosurface"):
        c = dataclasses.replace(
            cfg, render=dataclasses.replace(cfg.render, render_mode=mode))
        t0 = time.perf_counter()
        frames, metrics = app.run(c, num_frames=1)
        total = time.perf_counter() - t0
        cam = c.render.camera
        check(f"c/{mode} frame shape", frames[0].shape,
              (cam.height, cam.width, 3),
              frames[0].shape == (cam.height, cam.width, 3))
        check_finite(f"c/{mode}", frames[0])
        check(f"c/{mode} level-cut decode", metrics.values["decode"],
              "device", metrics.values["decode"] == "device")
        out[mode] = {"run_s": total, **metrics.values}
    out["compile_s"] = out["compositing"]["run_s"]
    out["warm_s"] = None  # app.run builds its tree on every call
    return out


def phase_d(size=1024, dims=256, tolerance=6, max_epochs=5, reps=3):
    from volumerenderer_tpu import generate_rays, orbit_camera
    from volumerenderer_tpu.codecs import kdtree
    from volumerenderer_tpu.io.synthetic import turbulence_volume
    from volumerenderer_tpu.models.compressed import CompressedRenderer
    from volumerenderer_tpu.ops.isosurface import render_isosurface
    from volumerenderer_tpu.ops.raycast import render_compositing

    t0 = time.perf_counter()
    tree = kdtree.build(turbulence_volume((dims,) * 3, seed=0),
                        tolerance=tolerance, max_epochs=max_epochs)
    r = CompressedRenderer(tree)
    build_s = time.perf_counter() - t0
    rays = generate_rays(orbit_camera(0.0, size, size))
    dense = r.volume_at()
    ray_args = (rays.entry_uv, rays.direction, rays.hit)
    out = {"impl": "xla", "tree_build_s": build_s}
    pooled = r.make_plan(rays, mode="compositing", pooled=True)
    (rgb_p, a_p), c_s, w_s = timed(pooled, reps)
    rgb_d, a_d = render_compositing(dense, *ray_args)
    out["compositing"] = {"compile_s": c_s, "warm_s": w_s,
                          **compare_compositing("d/pooled vs dense", rgb_p,
                                                a_p, rgb_d, a_d, POOLED_TOL)}
    iso = 40.0 / 255.0
    pooled_iso = r.make_plan(rays, mode="isosurface", pooled=True,
                             iso_value=iso)
    (rgb_p, hit_p), c_s, w_s = timed(pooled_iso, reps)
    rgb_d, hit_d = render_isosurface(dense, *ray_args, iso)
    out["isosurface"] = {"compile_s": c_s, "warm_s": w_s,
                         **compare_isosurface("d/pooled vs dense", rgb_p,
                                              hit_p, rgb_d, hit_d)}
    state = r.shade_pool_at()
    out["resident_bytes"] = int(state.pool.nbytes + state.slab_map.nbytes
                                + (tree.num_active_nodes + 3) // 4)
    out["dense_u8_bytes"] = int(dense.size)
    out["compile_s"] = out["compositing"]["compile_s"]
    out["warm_s"] = out["compositing"]["warm_s"]
    return out


def phase_e(size=1024, dims=256, parity_size=256, parity_dims=None,
            max_samples=300, reps=3):
    import jax
    import jax.numpy as jnp
    from volumerenderer_tpu import (as_normalized_volume, generate_rays,
                                    orbit_camera)
    from volumerenderer_tpu.diff.transfer import TFParams, render_tf
    from volumerenderer_tpu.diff.vjp import render_tf_o1
    from volumerenderer_tpu.io.synthetic import turbulence_volume

    vol = as_normalized_volume(turbulence_volume((dims,) * 3, seed=0))
    params = TFParams.reference()

    def grads_fn(render, rays, n):
        target = jnp.full(rays.hit.shape + (3,), 0.5, jnp.float32)

        def loss(p, v):
            rgb, _ = render(p, v, rays.entry_uv, rays.direction, rays.hit, n)
            return jnp.mean((rgb - target) ** 2)

        return jax.jit(jax.grad(loss, argnums=(0, 1)))

    o1 = lambda p, v, e, d, h, n: render_tf_o1(p, v, e, d, h, n, True)
    rays = generate_rays(orbit_camera(0.0, size, size))
    step = grads_fn(o1, rays, max_samples)
    (gp, gv), c_s, w_s = timed(lambda: step(params, vol), reps)
    check_finite("e/step grads", gv, *jax.tree.leaves(gp))
    out = {"impl": "xla", "compile_s": c_s, "warm_s": w_s}

    pdims = dims if parity_dims is None else parity_dims
    pvol = vol if pdims == dims else as_normalized_volume(
        turbulence_volume((pdims,) * 3, seed=0))
    prays = generate_rays(orbit_camera(0.0, parity_size, parity_size))
    g_o1 = grads_fn(o1, prays, max_samples)(params, pvol)
    g_ad = grads_fn(render_tf, prays, max_samples)(params, pvol)
    for name, a, b in zip(list(TFParams._fields) + ["volume"],
                          list(g_o1[0]) + [g_o1[1]],
                          list(g_ad[0]) + [g_ad[1]]):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        check(f"e/grad {name} O(1) VJP vs autodiff, relative", rel,
              GRAD_REL_TOL, rel <= GRAD_REL_TOL)
        out[f"rel_{name}"] = rel
    return out


def reference_volume(grid=None, num_bricks=384, load_grid=(8, 8, 6)):
    """The reference's brick volume (``main.cpp:242``) as uint8 on the
    host, generated from the synthetic brick source on every core."""
    from volumerenderer_tpu.io.bricks import (BrickGrid, load_bricks,
                                              synthetic_brick_source)

    grid = BrickGrid() if grid is None else grid
    return load_bricks(synthetic_brick_source(grid), grid, num_bricks,
                       *load_grid, 273, workers=os.cpu_count() or 1)


def phase_f(grid=None, num_bricks=384, load_grid=(8, 8, 6), camera=None,
            interpret=False, reps=7):
    from volumerenderer_tpu import Camera, as_normalized_volume, generate_rays
    from volumerenderer_tpu.models import best_isosurface_renderer
    from volumerenderer_tpu.ops.raycast import render_compositing

    t0 = time.perf_counter()
    u8 = reference_volume(grid, num_bricks, load_grid)
    build_s = time.perf_counter() - t0
    vol = as_normalized_volume(u8)
    del u8
    cam = Camera() if camera is None else camera
    rays = generate_rays(cam)
    Z, Y, X = vol.shape
    kernel, impl = compositing_under_test(rays, (X, Y, Z), interpret)
    (rgb_k, a_k), ck, wk = timed(lambda: kernel(vol), reps)
    (rgb_j, a_j), cj, wj = timed(lambda: render_compositing(
        vol, rays.entry_uv, rays.direction, rays.hit), reps)
    check_finite("f/compositing", rgb_k, a_k)
    cmp = compare_compositing("f/kernel vs jnp", rgb_k, a_k, rgb_j, a_j)
    render_iso = best_isosurface_renderer()
    (rgb_i, hit_i), ci, wi = timed(lambda: render_iso(
        vol, rays.entry_uv, rays.direction, rays.hit, 40.0 / 255.0), reps)
    check_finite("f/isosurface", rgb_i)
    return {"impl": impl, "volume": [Z, Y, X], "voxels": int(vol.size),
            "volume_f32_bytes": int(vol.nbytes), "brick_build_s": build_s,
            "compile_s": ck, "warm_s": wk, "xla_compile_s": cj,
            "xla_warm_s": wj, **cmp, "iso_compile_s": ci, "iso_warm_s": wi,
            "iso_hit_share": float(np.asarray(hit_i).mean())}


def phase_four_gpus(grid=None, num_bricks=384, load_grid=(8, 8, 6),
                    camera=None, tf_size=256, tf_dims=256, max_samples=300,
                    n=4):
    """Brick-sharded (2, 2, 1) and z-sharded renders of frame (f)'s volume
    and the (dp=2, rays=2) transfer-function step, each against the same
    computation on one card, in one process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.sharding import SingleDeviceSharding
    from volumerenderer_tpu import Camera, as_normalized_volume, generate_rays
    from volumerenderer_tpu.diff.transfer import TFParams
    from volumerenderer_tpu.io.synthetic import turbulence_volume
    from volumerenderer_tpu.parallel.bricks import (make_brick_mesh,
                                                    render_bricksharded,
                                                    shard_volume)
    from volumerenderer_tpu.parallel.context import (make_z_mesh,
                                                     render_zsharded)
    from volumerenderer_tpu.parallel.sharding import make_mesh, tf_fit_step

    devs = jax.devices()
    check("four/devices", len(devs), f">= {n}", len(devs) >= n)
    one = devs[:1]
    t0 = time.perf_counter()
    u8 = reference_volume(grid, num_bricks, load_grid)
    build_s = time.perf_counter() - t0
    vol1 = as_normalized_volume(
        jax.device_put(u8, SingleDeviceSharding(devs[0])))
    rays = generate_rays(Camera() if camera is None else camera)
    ray_args = (rays.entry_uv, rays.direction, rays.hit, max_samples)
    out = {"impl": "xla", "brick_build_s": build_s}

    def compare(name, sharded, single):
        (rgb_s, a_s), (rgb_1, a_1) = sharded, single
        d = max(float(np.abs(np.asarray(rgb_s) - np.asarray(rgb_1)).max()),
                float(np.abs(np.asarray(a_s) - np.asarray(a_1)).max()))
        check(f"four/{name} sharded vs one card", d, SHARD_TOL,
              d <= SHARD_TOL)
        return d

    bmesh = make_brick_mesh((2, 2, 1), devs[:n])
    vol4 = shard_volume(bmesh, vol1)
    res, c4, w4 = timed(lambda: render_bricksharded(bmesh, vol4, *ray_args), 1)
    mesh1 = make_brick_mesh((1, 1, 1), one)
    ref, c1, w1 = timed(lambda: render_bricksharded(mesh1, vol1, *ray_args), 1)
    out["bricksharded"] = {"max_d": compare("bricksharded", res, ref),
                           "compile_s": c4, "warm_s": w4,
                           "one_card_compile_s": c1, "one_card_warm_s": w1}
    del vol4, res, ref

    zmesh = make_z_mesh(n, devs)
    volz = jax.device_put(vol1, NamedSharding(zmesh, P("z")))
    res, c4, w4 = timed(lambda: render_zsharded(zmesh, volz, *ray_args), 1)
    ref, c1, w1 = timed(lambda: render_zsharded(make_z_mesh(1, one), vol1,
                                                *ray_args), 1)
    out["zsharded"] = {"max_d": compare("zsharded", res, ref),
                       "compile_s": c4, "warm_s": w4,
                       "one_card_compile_s": c1, "one_card_warm_s": w1}
    del vol1, volz, res, ref

    tvol = as_normalized_volume(turbulence_volume((tf_dims,) * 3, seed=0))
    trays = generate_rays(Camera(width=tf_size, height=tf_size))
    B = 2
    batch = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
    targs = (batch(trays.entry_uv), batch(trays.direction), batch(trays.hit),
             jnp.full((B, tf_size, tf_size, 3), 0.5, jnp.float32))
    params = TFParams.reference()
    (p4, l4), c4, w4 = timed(lambda: tf_fit_step(
        make_mesh(n, dp=2, devices=devs), params, tvol, *targs,
        max_samples=max_samples), 1)
    (p1, l1), c1, w1 = timed(lambda: tf_fit_step(
        make_mesh(1, devices=one), params, tvol, *targs,
        max_samples=max_samples), 1)
    d = max([abs(float(l4) - float(l1))]
            + [float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(jax.tree.leaves(p4), jax.tree.leaves(p1))])
    check("four/tf_fit_step sharded vs one card", d, TF_STEP_TOL,
          d <= TF_STEP_TOL)
    out["tf_fit_step"] = {"max_d": d, "compile_s": c4, "warm_s": w4,
                          "one_card_compile_s": c1, "one_card_warm_s": w1}
    out["compile_s"] = out["bricksharded"]["compile_s"]
    out["warm_s"] = out["bricksharded"]["warm_s"]
    return out


PHASES = {"a": phase_a, "b": phase_b, "c": phase_c, "d": phase_d,
          "e": phase_e, "f": phase_f}


def run_phase(name, fn, **kwargs):
    import jax

    t0 = time.perf_counter()
    result = fn(**kwargs)
    stats = jax.devices()[0].memory_stats() or {}
    line = {"phase": name, "impl": result.pop("impl"),
            "compile_s": result.pop("compile_s"),
            "warm_s": result.pop("warm_s"),
            "phase_s": time.perf_counter() - t0,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"), **result}
    print(json.dumps(line), flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    from volumerenderer_tpu import backend

    info = backend.require_gpu()
    print(backend.card_name_and_power_limit(), flush=True)
    print(f"compile cache: {backend.enable_compile_cache()}", flush=True)
    if args.four_gpus:
        run_phase("four_gpus", phase_four_gpus)
    else:
        check("a/backend chooses the Triton march",
              backend.compositing_impl(), "triton",
              backend.compositing_impl() == "triton")
        for name, fn in PHASES.items():
            run_phase(name, fn)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))


if __name__ == "__main__":
    main()
