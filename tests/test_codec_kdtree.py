"""Parity tests: vectorized kd-tree codec vs the sequential transliteration of
the reference (SURVEY.md §4 "Unit"): distance maps, preorder byte streams,
level-cut decodes, serialization round trips."""
import numpy as np
import pytest

from volumerenderer_tpu.codecs import kdtree as K
from volumerenderer_tpu.codecs.reference_impl import SequentialKdTree, decode_preorder
from volumerenderer_tpu.io.synthetic import sphere_volume, turbulence_volume


def _volumes():
    return [
        ("sphere16", sphere_volume((16, 16, 16))),
        ("turb16", turbulence_volume((16, 16, 16), seed=3)),
        ("rand8", np.random.default_rng(7).integers(0, 256, (8, 8, 8)).astype(np.uint8)),
        ("aniso", turbulence_volume((8, 16, 32), seed=5)),  # non-cubic pow2
    ]


def test_split_schedule_cycles_and_skips():
    # cubic: plain x,y,z cycle
    assert K.split_schedule(8, 8, 8) == [0, 1, 2, 0, 1, 2, 0, 1, 2]
    # X exhausted first -> later depths skip x
    s = K.split_schedule(2, 4, 4)
    assert s[0] == 0 and s.count(0) == 1 and s.count(1) == 2 and s.count(2) == 2
    with pytest.raises(ValueError):
        K.split_schedule(6, 8, 8)


def test_leaf_permutation_roundtrip():
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 256, (8, 16, 4)).astype(np.uint8)
    sched = K.split_schedule(4, 16, 8)
    leaves = K.volume_to_leaves(vol, sched)
    back = K.leaves_to_volume(leaves, (4, 16, 8), sched)
    np.testing.assert_array_equal(vol, back)


def test_leaf_order_matches_sequential_build():
    """The breadth-first leaf ordering implied by the transpose must equal the
    recursion order of buildRecursive."""
    vol = np.random.default_rng(1).integers(0, 256, (4, 4, 4)).astype(np.uint8)
    seq = SequentialKdTree(vol.reshape(-1), 4, 4, 4)
    seq.build()
    sched = K.split_schedule(4, 4, 4)
    leaves = K.volume_to_leaves(vol, sched)
    np.testing.assert_array_equal(leaves, seq.temp)  # temp holds leaves post-build


def test_midrange_pyramid_vs_bruteforce():
    vol = np.random.default_rng(2).integers(0, 256, (4, 4, 4)).astype(np.uint8)
    seq = SequentialKdTree(vol.reshape(-1), 4, 4, 4)
    seq.build()
    # rebuild pyramid via the vectorized path and compare interior midranges
    sched = K.split_schedule(4, 4, 4)
    leaves = K.volume_to_leaves(vol, sched)
    lmin = lmax = leaves
    D = len(sched)
    full = np.zeros((1 << (D + 1)) - 1, dtype=np.uint8)
    full[(1 << D) - 1:] = leaves
    for d in range(D - 1, -1, -1):
        lmin = np.minimum(lmin[0::2], lmin[1::2])
        lmax = np.maximum(lmax[0::2], lmax[1::2])
        full[(1 << d) - 1:(1 << (d + 1)) - 1] = (
            (lmin.astype(np.uint16) + lmax) // 2).astype(np.uint8)
    # sequential temp was truncated to leaves; rebuild a fresh one to compare
    seq2 = SequentialKdTree(vol.reshape(-1), 4, 4, 4)
    seq2.build = lambda: None
    seq2.orig_depth = D
    seq2.temp = np.zeros((1 << (D + 1)) - 1, dtype=np.uint8)
    seq2._build_recursive(0, 0, [0, 0, 0], [4, 4, 4])
    np.testing.assert_array_equal(full, seq2.temp)


@pytest.mark.parametrize("name,vol", _volumes())
@pytest.mark.parametrize("tol,epochs", [(1, 2), (6, 5)])
def test_vectorized_matches_sequential(name, vol, tol, epochs):
    Z, Y, X = vol.shape
    tree = K.build(vol, tolerance=tol, max_epochs=epochs)
    seq = SequentialKdTree(vol.reshape(-1).copy(), X, Y, Z,
                           tolerance=tol, max_epochs=epochs)
    seq.build()

    np.testing.assert_array_equal(tree.distance_map, seq.distance_map)
    pre = K.to_preorder(tree)
    assert tree.num_active_nodes == seq.num_active_nodes
    np.testing.assert_array_equal(pre, seq.preorder)

    for cut in [tree.orig_depth // 2, tree.orig_depth, tree.max_depth]:
        vec = K.level_cut(tree, cut)
        ref = seq.level_cut(cut)
        np.testing.assert_array_equal(vec, ref)


def test_save_open_roundtrip(tmp_path):
    vol = sphere_volume((16, 16, 16))
    tree = K.build(vol, tolerance=2, max_epochs=2)
    path = str(tmp_path / "tree.bin")
    K.save(tree, path)
    raw = K.open_tree(path)
    assert raw["dims"] == (16, 16, 16)
    assert raw["orig_depth"] == tree.orig_depth
    assert raw["max_depth"] == tree.max_depth
    assert raw["num_active_nodes"] == tree.num_active_nodes
    np.testing.assert_array_equal(raw["distance_map"], tree.distance_map)
    np.testing.assert_array_equal(raw["preorder"], K.to_preorder(tree))
    # decode straight from the serialized stream with the reference stack machine
    dec_file = decode_preorder(raw["preorder"], raw["distance_map"], 16, 16, 16,
                               raw["orig_depth"], raw["max_depth"], raw["max_depth"])
    np.testing.assert_array_equal(dec_file, K.level_cut(tree, tree.max_depth))


def test_reconstruction_accuracy():
    vol = turbulence_volume((32, 32, 32), seed=11)
    tree = K.build(vol, tolerance=1, max_epochs=2)
    dec = K.level_cut(tree, tree.max_depth)
    err = np.abs(dec.astype(np.int32) - vol.astype(np.int32))
    # branch growth drives leaves to ~tolerance; the Δ ladder reaches 1
    assert err.mean() < 4.0, err.mean()


def test_compression_on_smooth_volume():
    vol = sphere_volume((32, 32, 32))
    tree = K.build(vol, tolerance=6, max_epochs=5)
    # 2 bits/active node vs 8 bits/voxel; smooth data prunes heavily
    ratio = vol.size * 8 / (tree.num_active_nodes * 2)
    assert ratio > 2.0, ratio
    dec = K.level_cut(tree, tree.max_depth)
    err = np.abs(dec.astype(np.int32) - vol.astype(np.int32))
    assert err.mean() < 8.0, err.mean()


def test_native_seed_matches_python():
    rng = np.random.default_rng(3)
    truth = rng.integers(0, 256, 4096).astype(np.uint8)
    parent = rng.integers(0, 256, 4096).astype(np.int32)
    from volumerenderer_tpu.codecs.kdtree import _seed_level_py
    s_py, c_py = _seed_level_py(truth, parent)
    try:
        from volumerenderer_tpu.native import kdtree_native
        s_n, c_n = kdtree_native.seed_level(truth.astype(np.float64),
                                            parent.astype(np.float64))
    except OSError:
        pytest.skip("native toolchain unavailable")
    assert s_py == s_n and c_py == c_n

    codes_n, recon_n, sq_n = kdtree_native.encode_level(truth, parent, 17)
    codes_v, recon_v, min_err = K.encode_level(truth, parent, 17)
    np.testing.assert_array_equal(codes_n, codes_v)
    np.testing.assert_array_equal(recon_n, recon_v)
    assert sq_n == int(np.sum(min_err * min_err, dtype=np.int64))


def test_error_queries():
    vol = turbulence_volume((16, 16, 16), seed=1)
    tree = K.build(vol, tolerance=2, max_epochs=2)
    dec = K.level_cut(tree, tree.max_depth)
    mx = K.measure_max_error(dec, vol)
    mn = K.measure_mean_error(dec, vol)
    err_vol = K.query_error(dec, vol)
    assert mx == int(np.abs(dec.astype(int) - vol.astype(int)).max())
    assert 0 <= mn <= mx
    assert err_vol.dtype == np.uint8 and err_vol.max() == mx


def test_native_decode_matches_python():
    vol = turbulence_volume((16, 16, 16), seed=19)
    tree = K.build(vol, tolerance=2, max_epochs=2)
    pre = K.to_preorder(tree)
    for cut in (tree.orig_depth, tree.max_depth):
        py = decode_preorder(pre, tree.distance_map, 16, 16, 16,
                             tree.orig_depth, tree.max_depth, cut,
                             use_native=False)
        try:
            nat = decode_preorder(pre, tree.distance_map, 16, 16, 16,
                                  tree.orig_depth, tree.max_depth, cut,
                                  use_native=True)
        except OSError:
            pytest.skip("native toolchain unavailable")
        np.testing.assert_array_equal(nat, py)


def test_native_full_build_matches_python_nonpow2():
    """Arbitrary-dims C++ build vs the Python transliteration (incl. a
    non-power-of-two z where per-node extents diverge)."""
    from volumerenderer_tpu.codecs.reference_impl import SequentialKdTree, build_arbitrary

    rng = np.random.default_rng(23)
    for dims in [(12, 8, 8), (8, 8, 8), (6, 16, 4)]:
        vol = rng.integers(0, 256, dims).astype(np.uint8)
        Z, Y, X = dims
        py = SequentialKdTree(vol.reshape(-1).copy(), X, Y, Z, tolerance=2,
                              max_epochs=2)
        py.build()
        nat = build_arbitrary(vol, tolerance=2, max_epochs=2)
        np.testing.assert_array_equal(nat.distance_map, py.distance_map)
        assert nat.num_active_nodes == py.num_active_nodes, dims
        np.testing.assert_array_equal(nat.preorder, py.preorder)
        np.testing.assert_array_equal(nat.level_cut(nat.max_depth),
                                      py.level_cut(py.max_depth))


def test_open_tree_full_roundtrip():
    """Checkpoint -> full level-structured KdTree: the inverse preorder walk
    (native + Python automaton) reproduces the codes (re-serialization is
    byte-equal, enforced inside open_tree_full) and the same decode."""
    import tempfile, os
    from volumerenderer_tpu.codecs import kdtree as K

    rng = np.random.default_rng(9)
    vol = rng.integers(0, 255, size=(8, 16, 32), dtype=np.uint8)
    tree = K.build(vol, tolerance=1, max_epochs=2)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.bin")
        K.save(tree, path)
        t2 = K.open_tree_full(path)
    np.testing.assert_array_equal(K.level_cut(t2), K.level_cut(tree))
    np.testing.assert_array_equal(K.to_preorder(t2), K.to_preorder(tree))
    assert t2.num_active_nodes == tree.num_active_nodes

    # Python-fallback automaton agrees with the native walk
    pre = K.to_preorder(tree)
    lc_n, ch_n = K.preorder_to_levels(pre, tree.orig_depth, tree.max_depth)
    import volumerenderer_tpu.codecs.kdtree as KM
    import volumerenderer_tpu.native as NM

    real = KM.kdtree_native if hasattr(KM, "kdtree_native") else None
    orig_load = NM._load
    NM._load = lambda: (_ for _ in ()).throw(OSError("forced fallback"))
    try:
        lc_p, ch_p = K.preorder_to_levels(pre, tree.orig_depth,
                                          tree.max_depth)
    finally:
        NM._load = orig_load
    for a, b in zip(lc_n, lc_p):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ch_n, ch_p)


def test_chunked_device_decode_matches_host():
    """Deep trees decode ON DEVICE in bounded
    chunks (per depth-K subtree, lax.map) — bit-identical to the host decode
    at every cut depth, including cuts below the chunk split, at orig_depth,
    and through the grown chains."""
    from volumerenderer_tpu.codecs.device import level_cut_device, to_device

    vol = turbulence_volume((16, 32, 16), seed=2)
    tree = K.build(vol, tolerance=1, max_epochs=2)
    dtree, spec = to_device(tree)
    assert spec["chain_len"] > 0  # chains must be exercised
    for cut in (4, spec["orig_depth"] // 2, spec["orig_depth"],
                spec["max_depth"]):
        host = K.level_cut(tree, cut)
        chunked = np.asarray(level_cut_device(dtree, spec, cut, chunk_bits=7))
        np.testing.assert_array_equal(chunked, host)


def test_mip8_chunked_path_matches_flat():
    """Deep trees compute the occupancy mip from the chunked decode (the
    flat (2,)*D reshape impl pads ~128x on deep trees); both paths must
    agree exactly."""
    from volumerenderer_tpu.codecs import device as DV

    vol = turbulence_volume((16, 16, 16), seed=9)
    tree = K.build(vol, tolerance=2, max_epochs=2)
    dtree, spec = to_dev = DV.to_device(tree)
    dtree, spec = to_dev
    spec_key = (tuple(spec["dims"]), spec["orig_depth"], spec["max_depth"],
                tuple(spec["schedule"]), spec["chain_len"])
    flat = np.asarray(DV._tree_mip8_impl(dtree, spec_key, spec["max_depth"]))
    via_cut = np.asarray(DV._mip8_of_cut(
        DV.level_cut_device(dtree, spec, chunk_bits=7)))
    np.testing.assert_array_equal(via_cut, flat)
