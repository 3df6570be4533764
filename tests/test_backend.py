"""The backend decision, the compile-cache rule, the compositing plan, the
decode fallback rule and threaded brick assembly."""
import os

import jax
import numpy as np
import pytest

from volumerenderer_tpu import Camera, as_normalized_volume, backend
from volumerenderer_tpu.io.synthetic import turbulence_volume


@pytest.mark.parametrize("platform,compositing", [("gpu", "triton"),
                                                  ("cpu", "xla"),
                                                  ("other", "xla")])
def test_backend_choice_by_platform(platform, compositing):
    assert backend.compositing_impl(platform) == compositing
    assert backend.isosurface_impl(platform) == "xla"


def test_best_renderers_on_this_platform():
    from volumerenderer_tpu.models import (best_isosurface_renderer,
                                           best_renderer)
    from volumerenderer_tpu.ops.isosurface import render_isosurface
    from volumerenderer_tpu.ops.raycast import render_compositing

    assert backend.platform() == "cpu"
    assert best_renderer() is render_compositing
    assert best_isosurface_renderer() is render_isosurface


def test_device_info_and_require_gpu():
    info = backend.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.require_gpu()


def test_compositing_plan_holds_rays_and_renders():
    from volumerenderer_tpu import generate_rays
    from volumerenderer_tpu.models import plan_compositing
    from volumerenderer_tpu.ops.raycast import render_compositing

    vol = as_normalized_volume(turbulence_volume((8, 12, 16), seed=1))
    rays = generate_rays(Camera(width=10, height=6))
    plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit,
                            (16, 12, 8), max_samples=40)
    assert plan.impl == "xla" and plan.dims == (16, 12, 8)
    rgb, alpha = plan.render(vol)
    ref_rgb, ref_alpha = render_compositing(vol, rays.entry_uv,
                                            rays.direction, rays.hit, 40)
    np.testing.assert_array_equal(np.asarray(rgb), np.asarray(ref_rgb))
    with pytest.raises(ValueError, match="planned"):
        plan.render(vol.transpose(2, 1, 0))


def test_compile_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        backend.__file__)))
    assert backend.compile_cache_dir() == os.path.join(checkout, ".jax_cache")


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert backend.enable_compile_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def _renderer():
    from volumerenderer_tpu.codecs.kdtree import build as build_tree
    from volumerenderer_tpu.models.compressed import CompressedRenderer

    v = turbulence_volume((8, 8, 8), seed=3)
    return CompressedRenderer(build_tree(v, tolerance=4, max_epochs=1))


@pytest.mark.parametrize("message,falls_back", [
    ("RESOURCE_EXHAUSTED: Out of memory while trying to allocate", True),
    ("INTERNAL: an actual decode fault", False),
])
def test_decode_falls_back_only_on_resource_exhausted(monkeypatch, message,
                                                      falls_back):
    from volumerenderer_tpu.models import compressed

    r = _renderer()
    want = np.asarray(compressed.level_cut_device(r.dtree, r.spec,
                                                  r.spec["max_depth"]))

    def failing(*a, **k):
        raise RuntimeError(message)

    monkeypatch.setattr(compressed, "level_cut_device", failing)
    monkeypatch.setattr(compressed.CompressedRenderer,
                        "_device_decode_broken", {})
    if falls_back:
        with pytest.warns(UserWarning, match="ran out of memory"):
            got = r._decoded(r.spec["max_depth"])
        np.testing.assert_array_equal(np.asarray(got), want)
        assert not r.decoded_on_device()
    else:
        with pytest.raises(RuntimeError, match="decode fault"):
            r._decoded(r.spec["max_depth"])
        assert r.decoded_on_device()


def test_threaded_brick_assembly_matches_serial():
    from volumerenderer_tpu.io.bricks import (BrickGrid, load_bricks,
                                              synthetic_brick_source)

    grid = BrickGrid(brick_dims=(8, 8, 4), grid=(4, 2, 3))
    src = synthetic_brick_source(grid)
    a = load_bricks(src, grid, 24, 4, 2, 3, 273)
    b = load_bricks(src, grid, 24, 4, 2, 3, 273, workers=4)
    assert a.shape == (12, 16, 32)
    np.testing.assert_array_equal(a, b)


def test_orbit_camera_circles_the_volume():
    from volumerenderer_tpu import orbit_camera

    for az in (0.0, 90.0, 200.0):
        cam = orbit_camera(az, 8, 6)
        pos, front = np.asarray(cam.position), np.asarray(cam.front)
        assert abs(np.linalg.norm(pos) - 0.75) < 1e-9
        np.testing.assert_allclose(front, -pos / 0.75, atol=1e-9)
