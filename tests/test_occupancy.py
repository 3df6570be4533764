"""Tree occupancy mip, packed-neighborhood sampler and compressed-renderer
plan tests (CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest

from volumerenderer_tpu.codecs.device import block_max8
from volumerenderer_tpu.ops.sampling import (as_normalized_volume,
                                             pack_neighborhoods,
                                             sample_trilinear,
                                             sample_trilinear_packed)


def _rand_vol(shape, seed=0):
    rng = np.random.default_rng(seed)
    return as_normalized_volume(rng.integers(0, 256, size=shape,
                                             dtype=np.uint8))


def test_packed_sampler_matches_dense():
    vol = _rand_vol((16, 24, 32), seed=5)
    packed = pack_neighborhoods(vol)
    rng = np.random.default_rng(6)
    uvw = jnp.asarray(rng.random((500, 3)).astype(np.float32))
    a = np.asarray(sample_trilinear(vol, uvw))
    b = np.asarray(sample_trilinear_packed(packed, uvw))
    np.testing.assert_allclose(a, b, atol=2e-6)


def test_packed_sampler_edges():
    """Clamp-to-edge behavior at both faces matches the dense sampler."""
    vol = _rand_vol((8, 8, 8), seed=7)
    packed = pack_neighborhoods(vol)
    edge = np.array([[0.001, 0.5, 0.5], [0.999, 0.5, 0.5],
                     [0.5, 0.001, 0.999], [0.03, 0.97, 0.5],
                     [0.0625, 0.0625, 0.0625]], np.float32)
    a = np.asarray(sample_trilinear(vol, jnp.asarray(edge)))
    b = np.asarray(sample_trilinear_packed(packed, jnp.asarray(edge)))
    np.testing.assert_allclose(a, b, atol=2e-6)


def _small_renderer():
    from volumerenderer_tpu.codecs.kdtree import build as build_tree
    from volumerenderer_tpu.models.compressed import CompressedRenderer

    rng = np.random.default_rng(11)
    vol = rng.integers(0, 255, size=(16, 16, 16), dtype=np.uint8)
    vol[:, :, :5] = 0  # some empty space for the pool
    return CompressedRenderer(build_tree(vol, tolerance=2, max_epochs=2))


@pytest.mark.parametrize("pooled", [False, True])
def test_compressed_renderer_make_plan(pooled):
    """Plan-once compressed rendering (dense cut, or the compressed-domain
    slab pool) matches the per-call path in both modes."""
    from volumerenderer_tpu import Camera, generate_rays

    r = _small_renderer()
    rays = generate_rays(Camera(width=32, height=16))
    rgb_a, alpha_a = r.render(rays, mode="compositing")
    rgb_b, alpha_b = r.make_plan(rays, mode="compositing", pooled=pooled)()
    np.testing.assert_allclose(np.asarray(rgb_a), np.asarray(rgb_b),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(alpha_a), np.asarray(alpha_b),
                               atol=2e-6)
    rgb_c, found_c = r.make_plan(rays, mode="isosurface", pooled=pooled)()
    rgb_d, found_d = r.render(rays, mode="isosurface")
    np.testing.assert_array_equal(np.asarray(found_c), np.asarray(found_d))
    np.testing.assert_allclose(np.asarray(rgb_c), np.asarray(rgb_d),
                               atol=5e-3)


def test_compressed_renderer_rejects_unknown_mode():
    from volumerenderer_tpu import Camera, generate_rays

    r = _small_renderer()
    rays = generate_rays(Camera(width=4, height=4))
    with pytest.raises(ValueError):
        r.make_plan(rays, mode="mip")
    with pytest.raises(ValueError):
        r.render(rays, mode="mip")


def test_shade_pool_residency_from_tree_metadata():
    """The pool keeps only slabs the tree says are occupied (plus neighbors
    whose z1 taps reach in); an empty tree keeps none beyond slot 0."""
    from volumerenderer_tpu.codecs.kdtree import build as build_tree
    from volumerenderer_tpu.models.compressed import CompressedRenderer

    v = np.zeros((32, 8, 8), np.uint8)
    v[20:22] = 200
    r = CompressedRenderer(build_tree(v, tolerance=1, max_epochs=1))
    state = r.shade_pool_at()
    assert state.shape == (32, 8, 8)
    smap = np.asarray(state.slab_map)
    assert smap[2] > 0 and smap[0] == 0 and smap[3] == 0
    assert state.pool.shape[0] == 1 + int((smap > 0).sum())


@pytest.mark.parametrize("shape", [(8, 8, 8), (9, 17, 3), (16, 5, 24)])
def test_block_max8_pads_ragged_edges(shape):
    vol = _rand_vol(shape, seed=sum(shape))
    s = np.round(np.asarray(vol) * 255.0)
    m = np.asarray(block_max8(vol))
    assert m.shape == tuple(-(-n // 8) for n in shape)
    for i, j, k in np.ndindex(m.shape):
        assert m[i, j, k] == s[8 * i:8 * i + 8, 8 * j:8 * j + 8,
                               8 * k:8 * k + 8].max()

def test_tree_occupancy_mip8_matches_dense_block_max():
    """The tree-metadata occupancy grid equals the dense volume's per-8³
    block max at every cut depth (the decoded cut is piecewise constant on
    cut-depth node boxes) — zero dense-volume pass."""
    from volumerenderer_tpu.codecs.kdtree import build as build_tree
    from volumerenderer_tpu.codecs.device import (level_cut_device,
                                                  to_device,
                                                  tree_occupancy_mip8)

    rng = np.random.default_rng(21)
    v = np.zeros((16, 32, 8), np.uint8)      # (Z, Y, X), non-cubic
    v[4:10, 8:20, 2:6] = rng.integers(50, 255, size=(6, 12, 4),
                                      dtype=np.uint8)
    tree = build_tree(v, tolerance=2, max_epochs=2)
    dtree, spec = to_device(tree)
    for cut in (spec["orig_depth"] // 2, spec["orig_depth"],
                spec["max_depth"]):
        decoded = as_normalized_volume(level_cut_device(dtree, spec, cut))
        want = np.asarray(block_max8(decoded))
        got = np.asarray(tree_occupancy_mip8(dtree, spec, cut))
        np.testing.assert_array_equal(got, want)


