"""HashedKdtree (Morton-hash) codec tests."""
import numpy as np

from volumerenderer_tpu.codecs import hashed as H
from volumerenderer_tpu.io.synthetic import sphere_volume, turbulence_volume


def test_uniform_volume_reconstructs_within_tolerance():
    # Reference quirk: the residual-based distance sums make a uniform volume
    # seed Δ=0 at every level (the first node encodes exactly, accumulating a
    # zero residual), so reconstruction happens entirely through pass-2 branch
    # growth with the 64/32/16/8 ladder: truth 77 -> 64+16 = 80 (err 3 <= tol).
    vol = np.full((8, 8, 8), 77, dtype=np.uint8)
    tree = H.build(vol, tolerance=4)
    assert int(tree.distance_map[0]) == 0
    dec = H.level_cut(tree)
    assert np.abs(dec.astype(int) - 77).max() <= 4


def test_reconstruction_accuracy():
    vol = turbulence_volume((16, 16, 16), seed=13)
    tree = H.build(vol, tolerance=4)
    dec = H.level_cut(tree)
    err = np.abs(dec.astype(int) - vol.astype(int))
    # pass-2 splits any erroneous leaf above orig depth; growth caps at Δ=8,
    # so errors stay moderate (the hashed codec is lossier than the kd-tree)
    assert err.mean() < 8.0, err.mean()
    assert tree.num_collisions > 0  # undersized table must collide


def test_level_cut_coarse():
    vol = sphere_volume((16, 16, 16))
    tree = H.build(vol)
    coarse = H.level_cut(tree, cut_depth=4)
    assert coarse.shape == vol.shape
    assert len(np.unique(coarse)) <= 16


def test_save_open_roundtrip(tmp_path):
    vol = turbulence_volume((8, 8, 8), seed=2)
    tree = H.build(vol)
    p = str(tmp_path / "h.bin")
    H.save(tree, p)
    back = H.open_tree(p)
    assert back.tree_depth == tree.tree_depth
    assert back.hash_mask == tree.hash_mask
    np.testing.assert_array_equal(back.distance_map, tree.distance_map)
    np.testing.assert_array_equal(back.tree_data, tree.tree_data)
    np.testing.assert_array_equal(back.tree_structure, tree.tree_structure)
    np.testing.assert_array_equal(H.level_cut(back), H.level_cut(tree))


def test_growth_extends_depth():
    # high-frequency volume with tight tolerance forces branch growth
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 256, (8, 8, 8)).astype(np.uint8)
    tree = H.build(vol, tolerance=1)
    assert tree.tree_depth >= tree.orig_depth
    dec = H.level_cut(tree)
    assert dec.shape == vol.shape


def test_device_decode_matches_host():
    from volumerenderer_tpu.codecs.hashed import to_device_hashed, level_cut_device_hashed

    for vol in (turbulence_volume((16, 16, 16), seed=13),
                sphere_volume((16, 16, 16))):
        tree = H.build(vol, tolerance=4)
        dev = to_device_hashed(tree)
        for cut in (4, tree.orig_depth, tree.tree_depth):
            host = H.level_cut(tree, cut)
            devv = np.asarray(level_cut_device_hashed(tree, dev, cut))
            np.testing.assert_array_equal(devv, host)


def test_config4_pipeline_hashed_fit():
    """BASELINE config 4 end-to-end at CI scale: 8-brick assembly ->
    hashed-kdtree build -> DEVICE hashed decode -> differentiable TF fit
    (the hashed codec inside an actual render+fit pipeline)."""
    import jax
    import jax.numpy as jnp
    from volumerenderer_tpu import Camera, generate_rays, as_normalized_volume
    from volumerenderer_tpu.codecs import hashed as H
    from volumerenderer_tpu.diff.transfer import TFParams, tf_loss
    from volumerenderer_tpu.io.bricks import (BrickGrid, load_bricks,
                                              synthetic_brick_source)

    grid = BrickGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))
    multi = load_bricks(synthetic_brick_source(grid), grid, 8, 2, 2, 2, 273)
    tree = H.build(multi, tolerance=4)
    dev = H.to_device_hashed(tree)
    dec = H.level_cut_device_hashed(tree, dev)
    np.testing.assert_array_equal(np.asarray(dec), H.level_cut(tree))
    vol = as_normalized_volume(dec)

    rays = generate_rays(Camera(width=32, height=16))
    target = jnp.full(rays.entry_uv.shape[:-1] + (3,), 0.5, jnp.float32)
    params = TFParams.reference()
    loss0 = float(tf_loss(params, vol, rays.entry_uv, rays.direction,
                          rays.hit, target, max_samples=24))
    g = jax.grad(lambda p: tf_loss(p, vol, rays.entry_uv, rays.direction,
                                   rays.hit, target, max_samples=24))(params)
    params = jax.tree.map(lambda p, gg: p - 0.05 * gg, params, g)
    loss1 = float(tf_loss(params, vol, rays.entry_uv, rays.direction,
                          rays.hit, target, max_samples=24))
    assert np.isfinite(loss1) and loss1 < loss0


def test_native_build_matches_python():
    """The native hashed builder (hashed_native.cpp) is bit-identical to the
    Python passes: tables, collision map, distance map, and decode."""
    from volumerenderer_tpu.io.synthetic import turbulence_volume

    v = turbulence_volume((16, 32, 16), seed=5)
    tp = H.build(v, tolerance=4, use_native=False)
    tn = H.build(v, tolerance=4)
    assert tp.tree_depth == tn.tree_depth
    np.testing.assert_array_equal(tp.distance_map, tn.distance_map)
    np.testing.assert_array_equal(tp.tree_data, tn.tree_data)
    np.testing.assert_array_equal(tp.tree_structure, tn.tree_structure)
    np.testing.assert_array_equal(tp.coll_keys, tn.coll_keys)
    np.testing.assert_array_equal(tp.coll_data[tp.coll_vals],
                                  tn.coll_data[tn.coll_vals])
    np.testing.assert_array_equal(tp.coll_structure[tp.coll_vals],
                                  tn.coll_structure[tn.coll_vals])
    np.testing.assert_array_equal(H.level_cut(tp), H.level_cut(tn))


def test_device_decode_stays_on_device_and_uint32_codes():
    """The hashed decode must be fully device-
    resident (no host round-trip for the leaf permutation), and its Morton
    arithmetic must stay exact past the int32 boundary (uint32 codes)."""
    import jax
    import jax.numpy as jnp

    vol = turbulence_volume((16, 16, 16), seed=3)
    tree = H.build(vol, tolerance=4)
    dev = H.to_device_hashed(tree)
    out = H.level_cut_device_hashed(tree, dev)
    assert isinstance(out, jax.Array)
    np.testing.assert_array_equal(np.asarray(out), H.level_cut(tree))

    # depth-31 codes live in [2^31, 2^32): uint32 key extraction and
    # sorted-search must equal the int64 oracle exactly
    m64 = (np.int64(1) << 31) + np.arange(64, dtype=np.int64) * 101
    keys64 = np.sort(m64[::3])
    mask = (1 << 18) - 1
    m32 = jnp.asarray(m64.astype(np.uint32))
    k32 = jnp.asarray(keys64.astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray((m32 & jnp.uint32(mask)).astype(jnp.int32)),
        (m64 & mask).astype(np.int32))
    np.testing.assert_array_equal(np.asarray(jnp.searchsorted(k32, m32)),
                                  np.searchsorted(keys64, m64))
