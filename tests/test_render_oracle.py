"""jnp marches against the scalar GLSL transliteration across fields,
cameras and isovalues; the two compositing loops against each other; and
the compressed-domain (pooled) sampler against the dense one inside both
marches."""
import jax.numpy as jnp
import numpy as np
import pytest

from volumerenderer_tpu import as_normalized_volume, generate_rays
from volumerenderer_tpu.ops.isosurface import render_isosurface
from volumerenderer_tpu.ops.raycast import (composite_march,
                                            composite_march_early_exit,
                                            render_compositing)
from volumerenderer_tpu.ops.sampling import build_shade_pool, sample_pooled

from fields_and_cameras import CAMERAS, FIELDS
from oracles.glsl_oracle import (render_compositing_oracle,
                                 render_isosurface_oracle)

W, H = 12, 10
DIMS = (16, 16, 16)


def _oracle_camera(cam):
    return dict(cam_pos=cam.position, front=cam.front, up=cam.up,
                fov=cam.fov_y_degrees)


@pytest.mark.parametrize("camera", sorted(CAMERAS))
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_compositing_matches_oracle(field, camera):
    u8 = FIELDS[field](DIMS)
    cam = CAMERAS[camera](W, H)
    rays = generate_rays(cam)
    rgb, alpha = render_compositing(as_normalized_volume(u8), rays.entry_uv,
                                    rays.direction, rays.hit)
    ref_rgb, ref_alpha = render_compositing_oracle(u8, W, H,
                                                   **_oracle_camera(cam))
    np.testing.assert_allclose(np.asarray(rgb), ref_rgb, atol=2e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(alpha), ref_alpha, atol=2e-4,
                               rtol=0)


@pytest.mark.parametrize("iso", [40.0 / 255.0, 128.0 / 255.0])
@pytest.mark.parametrize("camera", ["default", "orbit", "inside"])
@pytest.mark.parametrize("field", ["sphere", "turbulence", "shell"])
def test_isosurface_matches_oracle(field, camera, iso):
    u8 = FIELDS[field](DIMS)
    cam = CAMERAS[camera](W, H)
    rays = generate_rays(cam)
    rgb, found = render_isosurface(as_normalized_volume(u8), rays.entry_uv,
                                   rays.direction, rays.hit, iso)
    ref_rgb, ref_hit = render_isosurface_oracle(u8, W, H, iso=iso,
                                                **_oracle_camera(cam))
    np.testing.assert_array_equal(np.asarray(found), ref_hit)
    np.testing.assert_allclose(np.asarray(rgb), ref_rgb, atol=5e-3, rtol=0)


def test_oracle_pixel_subset_matches_full_image():
    u8 = FIELDS["turbulence"](DIMS)
    pix = [(0, 0), (3, 7), (9, 11), (5, 5)]
    rgb, alpha = render_compositing_oracle(u8, W, H)
    rgb_s, alpha_s = render_compositing_oracle(u8, W, H, pixels=pix)
    rows, cols = np.asarray(pix).T
    np.testing.assert_array_equal(rgb_s, rgb[rows, cols])
    np.testing.assert_array_equal(alpha_s, alpha[rows, cols])
    irgb, ihit = render_isosurface_oracle(u8, W, H)
    irgb_s, ihit_s = render_isosurface_oracle(u8, W, H, pixels=pix)
    np.testing.assert_array_equal(ihit_s, ihit[rows, cols])


@pytest.mark.parametrize("camera", sorted(CAMERAS))
@pytest.mark.parametrize("field", ["sphere", "turbulence", "shell"])
def test_fixed_trip_and_early_exit_loops_agree(field, camera):
    vol = as_normalized_volume(FIELDS[field](DIMS))
    rays = generate_rays(CAMERAS[camera](W, H))
    args = (vol, rays.entry_uv, rays.direction, rays.hit, 64)
    c0, a0 = composite_march(*args)
    c1, a1 = composite_march_early_exit(*args)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c0), atol=1e-7)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a0), atol=1e-7)


@pytest.mark.parametrize("dims", [(16, 16, 16), (20, 12, 16), (13, 16, 8)])
@pytest.mark.parametrize("field", ["turbulence", "shell"])
def test_pooled_marches_match_dense(field, dims):
    """Both marches over the sparse slab pool equal the dense ones to float
    rounding (8-bit-exact samples), also when Z is not a multiple of 8."""
    vol = as_normalized_volume(FIELDS[field](dims))
    state = build_shade_pool(vol)
    assert state.shape == dims
    rays = generate_rays(CAMERAS["orbit"](W, H))
    args = (rays.entry_uv, rays.direction, rays.hit)
    rgb_p, a_p = render_compositing(state, *args, sample=sample_pooled)
    rgb_d, a_d = render_compositing(vol, *args)
    np.testing.assert_allclose(np.asarray(rgb_p), np.asarray(rgb_d),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_d), atol=2e-6)
    irgb_p, hit_p = render_isosurface(state, *args, 100.0 / 255.0,
                                      sample=sample_pooled)
    irgb_d, hit_d = render_isosurface(vol, *args, 100.0 / 255.0)
    np.testing.assert_array_equal(np.asarray(hit_p), np.asarray(hit_d))
    np.testing.assert_allclose(np.asarray(irgb_p), np.asarray(irgb_d),
                               atol=5e-3)


def test_pooled_sampler_rejects_repeat_wrap():
    state = build_shade_pool(jnp.zeros((8, 8, 8), jnp.float32))
    with pytest.raises(ValueError):
        sample_pooled(state, jnp.zeros((1, 3)), "repeat")
