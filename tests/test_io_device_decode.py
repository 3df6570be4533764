"""Tests for brick I/O assembly and the device (jnp) level-cut decoder."""
import numpy as np
import pytest

from volumerenderer_tpu.io import bricks as B
from volumerenderer_tpu.codecs import kdtree as K
from volumerenderer_tpu.codecs.device import to_device, level_cut_device
from volumerenderer_tpu.io.synthetic import turbulence_volume


def test_brick_coords_match_reference_map():
    """fillVolumeBrickMap semantics (main.cpp:599-619): i fastest, j next, k
    every I*J bricks."""
    grid = B.BrickGrid(brick_dims=(4, 4, 2), grid=(8, 8, 15))
    # transliterate the reference loop
    i = j = k = 0
    for b in range(8 * 8 * 15):
        assert grid.brick_coords(b) == (i, j, k), b
        if (b + 1) % 64 == 0:
            i = j = 0
            k += 1
        elif (b + 1) % 8 == 0:
            i = 0
            j += 1
        else:
            i += 1


def test_rm_brick_path():
    p = B.rm_brick_path("/data", 7, 273)
    assert p == "/data/bob273/d_0273_0007"


def test_brick_file_roundtrip(tmp_path):
    grid = B.BrickGrid(brick_dims=(8, 4, 2), grid=(2, 2, 2))
    rng = np.random.default_rng(0)
    brick = rng.integers(0, 256, (2, 4, 8)).astype(np.uint8)
    path = tmp_path / "b"
    brick.tofile(path)
    loaded = B.load_brick_file(str(path), grid.brick_dims)
    np.testing.assert_array_equal(loaded, brick)
    # size check
    (tmp_path / "bad").write_bytes(b"123")
    with pytest.raises(ValueError):
        B.load_brick_file(str(tmp_path / "bad"), grid.brick_dims)


def test_assembly_matches_rowwise_reference(tmp_path):
    """Block assignment must equal the reference's per-row global index math
    (VolumeReader.h:184-204)."""
    bx, by, bz = 4, 3, 2
    I, J, K = 3, 2, 2
    grid = B.BrickGrid(brick_dims=(bx, by, bz), grid=(I, J, K))
    rng = np.random.default_rng(1)
    bricks = {b: rng.integers(0, 256, (bz, by, bx)).astype(np.uint8)
              for b in range(I * J * K)}
    src = lambda b, t: bricks[b]
    vol = B.load_bricks(src, grid, I * J * K, I, J, K, timestep=0)

    # reference-style flat assembly
    X, Y, Z = I * bx, J * by, K * bz
    flat = np.zeros(X * Y * Z, dtype=np.uint8)
    XY = bx * by
    XYZ = XY * bz
    XYZIJ = XYZ * I * J
    XYI = XY * I
    XI = bx * I
    XYIJ = XY * I * J
    for b in range(I * J * K):
        i, j, k = grid.brick_coords(b)
        tb = bricks[b].reshape(-1)  # x-fastest
        shift = k * XYZIJ + j * XYI + i * bx
        for z in range(bz):
            for y in range(by):
                gstart = shift + z * XYIJ + y * XI
                bstart = z * XY + y * bx
                flat[gstart:gstart + bx] = tb[bstart:bstart + bx]
    np.testing.assert_array_equal(vol.reshape(-1), flat)


def test_synthetic_brick_source():
    grid = B.BrickGrid(brick_dims=(8, 8, 8), grid=(2, 2, 2))
    src = B.synthetic_brick_source(grid)
    vol = B.load_bricks(src, grid, 8, 2, 2, 2, timestep=273)
    assert vol.shape == (16, 16, 16)
    assert vol.std() > 0
    # deterministic
    vol2 = B.load_bricks(src, grid, 8, 2, 2, 2, timestep=273)
    np.testing.assert_array_equal(vol, vol2)


@pytest.mark.parametrize("cut_offset", [0, -3, 4, None])
def test_device_decode_matches_host(cut_offset):
    vol = turbulence_volume((16, 16, 16), seed=9)
    tree = K.build(vol, tolerance=2, max_epochs=2)
    dtree, spec = to_device(tree)
    if cut_offset is None:
        cut = None
        host = K.level_cut(tree, tree.max_depth)
    else:
        cut = tree.orig_depth + cut_offset
        host = K.level_cut(tree, cut)
    dev = np.asarray(level_cut_device(dtree, spec, cut))
    np.testing.assert_array_equal(dev, host)


GOLDEN_ASSEMBLY_CRC = 0xd1f19e43  # recorded 2026-08-19


def test_assembly_golden_at_rm_brick_dims():
    """8-brick (2x2x2) assembly at the REAL RM brick dims (256x256x128,
    ``main.cpp:78-79``): marker bricks prove the i-fastest global placement
    at scale, and a recorded checksum pins the index math (locks the layout
    until real-brick goldens exist)."""
    import zlib
    from volumerenderer_tpu.io.bricks import BrickGrid, load_bricks

    grid = BrickGrid(brick_dims=(256, 256, 128), grid=(2, 2, 2))
    bx, by, bz = grid.brick_dims

    def source(b, t):
        # brick-constant marker + a deterministic in-brick ramp so both the
        # placement AND the per-brick orientation are pinned
        ramp = (np.arange(bx, dtype=np.uint32)[None, None, :]
                + 7 * np.arange(by, dtype=np.uint32)[None, :, None]
                + 13 * np.arange(bz, dtype=np.uint32)[:, None, None])
        return ((b * 31 + t + ramp) % 251).astype(np.uint8)

    vol = load_bricks(source, grid, 8, 2, 2, 2, 273)
    assert vol.shape == (2 * bz, 2 * by, 2 * bx)
    # marker spot checks: brick b at (i, j, k) = (b%2, (b//2)%2, b//4)
    for b in range(8):
        i, j, k = b % 2, (b // 2) % 2, b // 4
        expect = source(b, 273)
        got = vol[k * bz:(k + 1) * bz, j * by:(j + 1) * by,
                  i * bx:(i + 1) * bx]
        np.testing.assert_array_equal(got[::64, ::64, ::64],
                                      expect[::64, ::64, ::64])
    # recorded golden checksum of the full 128 MiB assembly
    crc = zlib.crc32(vol.tobytes())
    assert crc == GOLDEN_ASSEMBLY_CRC, hex(crc)
