"""Golden tests: jnp renderers vs the scalar NumPy transliteration of the GLSL
pipeline (tests/oracles/glsl_oracle.py), per SURVEY.md §4."""
import numpy as np
import jax.numpy as jnp
import pytest

from volumerenderer_tpu import (
    Camera,
    generate_rays,
    as_normalized_volume,
    render_compositing,
    render_isosurface,
)
from volumerenderer_tpu.io.synthetic import sphere_volume, ramp_volume
from oracles.glsl_oracle import render_compositing_oracle, render_isosurface_oracle

W, H = 40, 30  # tiny viewport keeps the scalar oracle fast


@pytest.mark.parametrize("volume_fn", [sphere_volume, ramp_volume])
def test_compositing_matches_oracle(volume_fn):
    vol_u8 = volume_fn((32, 32, 32))
    cam = Camera(width=W, height=H)
    rays = generate_rays(cam)
    vol = as_normalized_volume(vol_u8)
    rgb, alpha = render_compositing(vol, rays.entry_uv, rays.direction, rays.hit)

    ref_rgb, ref_alpha = render_compositing_oracle(vol_u8, W, H)
    np.testing.assert_allclose(np.asarray(rgb), ref_rgb, atol=2e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(alpha), ref_alpha, atol=2e-4, rtol=0)


def test_compositing_nontrivial():
    vol_u8 = sphere_volume((32, 32, 32))
    cam = Camera(width=W, height=H)
    rays = generate_rays(cam)
    rgb, alpha = render_compositing(as_normalized_volume(vol_u8), rays.entry_uv,
                                    rays.direction, rays.hit)
    rgb = np.asarray(rgb)
    assert np.asarray(alpha).max() > 0.5          # the sphere saturates some rays
    assert rgb[..., 0].min() < 0.5                # dark pixels where density accumulated
    assert np.allclose(rgb[..., 2], 1.0)          # blue channel pinned at 1 (frag:84)


def test_isosurface_matches_oracle():
    vol_u8 = sphere_volume((32, 32, 32))
    cam = Camera(width=W, height=H)
    rays = generate_rays(cam)
    rgb, found = render_isosurface(as_normalized_volume(vol_u8), rays.entry_uv,
                                   rays.direction, rays.hit, iso_value=40.0 / 255.0)
    ref_rgb, ref_hit = render_isosurface_oracle(vol_u8, W, H, iso=40.0 / 255.0)
    np.testing.assert_array_equal(np.asarray(found), ref_hit)
    np.testing.assert_allclose(np.asarray(rgb), ref_rgb, atol=5e-3, rtol=0)
    assert ref_hit.any()


def test_rays_camera_defaults():
    cam = Camera()
    assert cam.width == 1600 and cam.height == 1200 and cam.fov_y_degrees == 50.0
    rays = generate_rays(cam, 16, 12)
    assert rays.entry_uv.shape == (12, 16, 3)
    hit = np.asarray(rays.hit)
    assert hit.any()
    # central ray looks straight down +z and enters at the front face z=0
    entry = np.asarray(rays.entry_uv)[6, 8]
    assert abs(entry[2]) < 1e-5


def test_wrap_repeat_mode_runs():
    vol_u8 = sphere_volume((16, 16, 16))
    cam = Camera(width=8, height=8)
    rays = generate_rays(cam)
    rgb, _ = render_compositing(as_normalized_volume(vol_u8), rays.entry_uv,
                                rays.direction, rays.hit, wrap="repeat")
    ref_rgb, _ = render_compositing_oracle(vol_u8, 8, 8, wrap="repeat")
    np.testing.assert_allclose(np.asarray(rgb), ref_rgb, atol=2e-4, rtol=0)


def test_sample_trilinear_pooled_matches_packed():
    """Sparse-pool shading sampler == dense packed-neighborhood sampler on a
    sparse volume (zero-slot reads are exact) and a dense one."""
    from volumerenderer_tpu.ops.sampling import (
        build_shade_pool, pack_neighborhoods, sample_trilinear_packed,
        sample_trilinear_pooled)

    rng = np.random.default_rng(3)
    Z, Y, X = 24, 8, 16
    v = np.zeros((Z, Y, X), np.float32)
    v[9:14] = rng.random((5, Y, X))
    for vol in (v, rng.random((Z, Y, X)).astype(np.float32)):
        vol = jnp.asarray(np.round(vol * 255.0) / 255.0, jnp.float32)
        state = build_shade_pool(vol)
        packed = pack_neighborhoods(vol)
        uvw = jnp.asarray(rng.random((257, 3)), jnp.float32)
        a = sample_trilinear_pooled(state.pool, state.slab_map, (X, Y, Z), uvw)
        b = sample_trilinear_packed(packed, uvw)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    assert state.pool.shape[0] <= Z // 8 + 1 and state.shape == (Z, Y, X)
