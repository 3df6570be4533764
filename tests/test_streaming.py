"""Multi-timestep streaming pipeline tests (BASELINE config 5)."""
import numpy as np

from volumerenderer_tpu import Camera, generate_rays
from volumerenderer_tpu.io.bricks import BrickGrid, synthetic_brick_source
from volumerenderer_tpu.io.streaming import TimestepStreamer


def _grid():
    return BrickGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))


def test_stream_renders_all_timesteps():
    grid = _grid()
    src = synthetic_brick_source(grid)
    streamer = TimestepStreamer(src, grid, timesteps=[270, 271, 272, 273],
                                num_bricks=8, I=2, J=2, K_bricks=2,
                                tolerance=2, max_epochs=1, prefetch=2)
    rays = generate_rays(Camera(width=16, height=16))
    seen = []
    imgs = []
    for t, renderer in streamer:
        rgb, alpha = renderer.render(rays)
        seen.append(t)
        imgs.append(np.asarray(rgb))
    assert seen == [270, 271, 272, 273]
    # different timesteps produce different imagery
    assert not np.allclose(imgs[0], imgs[1])


def test_stream_checkpoint_resume(tmp_path):
    grid = _grid()
    src = synthetic_brick_source(grid)
    kw = dict(num_bricks=8, I=2, J=2, K_bricks=2, tolerance=2, max_epochs=1,
              cache_dir=str(tmp_path))
    rays = generate_rays(Camera(width=8, height=8))

    s1 = TimestepStreamer(src, grid, timesteps=[270, 271], **kw)
    first = {t: np.asarray(r.render(rays)[0]) for t, r in s1}

    # second run resumes from the checkpoint files (decode-only path)
    calls = []
    def counting_src(b, t):
        calls.append((b, t))
        return src(b, t)

    from volumerenderer_tpu.models.compressed import CompressedRenderer

    s2 = TimestepStreamer(counting_src, grid, timesteps=[270, 271], **kw)
    second = {}
    for t, r in s2:
        # resume keeps the compressed-renderer class (cut-depth control,
        # device decode, tree-metadata occupancy)
        assert isinstance(r, CompressedRenderer)
        second[t] = np.asarray(r.render(rays)[0])
    assert not calls  # no brick reads on resume
    for t in (270, 271):
        np.testing.assert_allclose(second[t], first[t], atol=1e-6)
