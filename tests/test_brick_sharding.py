"""Brick-sharded (3-D volume sharding) rendering tests on the 8-device CPU
mesh — BASELINE config 5's "brick-sharded across hosts" layout."""
import numpy as np

from volumerenderer_tpu import Camera, generate_rays, as_normalized_volume
from volumerenderer_tpu.ops.raycast import render_compositing
from volumerenderer_tpu.parallel.bricks import (
    host_local_bricks_3d, make_brick_mesh, render_bricksharded, shard_volume)
from volumerenderer_tpu.io.bricks import BrickGrid
from volumerenderer_tpu.io.synthetic import turbulence_volume


def _setup():
    # scale down so no ray saturates: the sharded march has no early-out
    vol = as_normalized_volume(turbulence_volume((16, 16, 16), seed=6)) * 0.25
    rays = generate_rays(Camera(width=24, height=16))
    return vol, rays


def test_bricksharded_matches_single_device():
    vol, rays = _setup()
    rgb_ref, a_ref = render_compositing(vol, rays.entry_uv, rays.direction,
                                        rays.hit, max_samples=64)
    mesh = make_brick_mesh((2, 2, 2))
    sharded = shard_volume(mesh, vol)
    rgb_s, a_s = render_bricksharded(mesh, sharded, rays.entry_uv,
                                     rays.direction, rays.hit, max_samples=64)
    np.testing.assert_allclose(np.asarray(rgb_s), np.asarray(rgb_ref),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(a_s), np.asarray(a_ref), atol=2e-6)


def test_mesh_shape_invariance():
    """Any brick decomposition gives the same image (incl. oblique camera so
    rays cross brick boundaries on all axes)."""
    vol, _ = _setup()
    cam = Camera(position=(0.5, 0.4, -0.6), front=(-0.55, -0.45, 0.7),
                 width=16, height=16)
    rays = generate_rays(cam)
    out = {}
    for shape in ((1, 1, 1), (2, 2, 2), (1, 2, 4), (8, 1, 1), (1, 1, 8)):
        mesh = make_brick_mesh(shape)
        rgb, a = render_bricksharded(mesh, shard_volume(mesh, vol),
                                     rays.entry_uv, rays.direction, rays.hit,
                                     max_samples=48)
        out[shape] = (np.asarray(rgb), np.asarray(a))
    ref = out[(1, 1, 1)]
    for shape, (rgb, a) in out.items():
        np.testing.assert_allclose(rgb, ref[0], atol=2e-6, err_msg=str(shape))
        np.testing.assert_allclose(a, ref[1], atol=2e-6, err_msg=str(shape))


def test_descending_and_mixed_rays():
    """A camera on the +corner looking back: all direction signs negative."""
    vol, _ = _setup()
    cam = Camera(position=(0.6, 0.5, 0.75), front=(-0.5, -0.45, -0.7),
                 width=16, height=16)
    rays = generate_rays(cam)
    rgb_ref, a_ref = render_compositing(vol, rays.entry_uv, rays.direction,
                                        rays.hit, max_samples=48)
    mesh = make_brick_mesh((2, 2, 2))
    rgb_s, a_s = render_bricksharded(mesh, shard_volume(mesh, vol),
                                     rays.entry_uv, rays.direction, rays.hit,
                                     max_samples=48)
    np.testing.assert_allclose(np.asarray(rgb_s), np.asarray(rgb_ref),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(a_s), np.asarray(a_ref), atol=2e-6)


def test_host_local_bricks_3d_partition():
    """Every brick file lands in at least one shard's read set; a (2, 2, 2)
    mesh over an 8x8x4 brick grid assigns each brick exactly once."""
    grid = BrickGrid(brick_dims=(16, 16, 16), grid=(8, 8, 4))
    seen = []
    for iz in range(2):
        for iy in range(2):
            for ix in range(2):
                seen += host_local_bricks_3d(grid, (2, 2, 2), (iz, iy, ix))
    assert sorted(seen) == list(range(grid.num_bricks()))


def test_early_out_envelope_bricksharded():
    """Same approximation envelope as the z-sharded path (see
    test_context_parallel.test_early_out_envelope): the brick-sharded march
    omits only post-early-out contributions, so it stays within
    tau0/ALPHA_SCALE (color) and tau0 (alpha) of the early-out single-device
    renderer, with tau0 = 1 - EARLY_OUT_ALPHA = 0.01."""
    from volumerenderer_tpu.ops.raycast import ALPHA_SCALE, EARLY_OUT_ALPHA

    tau0 = 1.0 - EARLY_OUT_ALPHA
    vol = as_normalized_volume(turbulence_volume((16, 16, 16), seed=6))
    rays = generate_rays(Camera(width=24, height=16))
    rgb_eo, a_eo = render_compositing(vol, rays.entry_uv, rays.direction,
                                      rays.hit, max_samples=64,
                                      early_exit=True)
    assert float(np.asarray(a_eo).max()) > EARLY_OUT_ALPHA
    mesh = make_brick_mesh((2, 2, 2))
    rgb_s, a_s = render_bricksharded(mesh, shard_volume(mesh, vol),
                                     rays.entry_uv, rays.direction, rays.hit,
                                     max_samples=64)
    assert float(np.abs(np.asarray(rgb_s) - np.asarray(rgb_eo)).max()) \
        <= tau0 / ALPHA_SCALE + 1e-5
    assert float(np.abs(np.asarray(a_s) - np.asarray(a_eo)).max()) \
        <= tau0 + 1e-5
