"""One-command Richtmyer-Meshkov dataset smoke test: keeps RM-data
integration ready, so validation is one command the day the dataset is
mounted.

    python scripts/rm_smoke.py --rm-dir /path/to/rm [--timestep 273]
                               [--bricks 8] [--grid 2,2,2] [--render]

Checks, in order (mirroring the reference driver ``main.cpp:242-292``):

1. **File discovery**: the path template ``bob<ttt>/d_<tttt>_<bbbb>``
   (``main.cpp:580-597``) resolves for every requested brick.
2. **Size check**: every brick file is exactly brick_dims bytes of uint8
   (``VolumeReader.h:253-261`` — hard failure otherwise).
3. **Assembly**: bricks assemble into the dense volume with the i-fastest
   (x-major) brick map (``main.cpp:599-619``); prints the volume CRC32 so
   real-data goldens can be recorded the first time this runs, and basic
   stats (min/max/mean) as a sanity signal.
4. **Compression round-trip** (optional quick check at tolerance 1, epochs 2
   like ``main.cpp:253-258``): builds the kd-tree codec on the assembled
   volume and reports max/mean reconstruction error at the leaf cut.
5. ``--render``: renders one 1024² compositing frame of the assembled volume
   through ``models.plan_compositing`` (the renderer the backend chooses)
   and writes ``out/rm_frame.npy``.
"""
from __future__ import annotations

import argparse
import os
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rm-dir", required=True,
                    help="dataset root holding bob<ttt>/ directories")
    ap.add_argument("--timestep", type=int, default=273)
    ap.add_argument("--bricks", type=int, default=8,
                    help="number of bricks to load (I*J*K)")
    ap.add_argument("--grid", default="2,2,2",
                    help="I,J,K sub-grid to assemble (x,y,z brick counts)")
    ap.add_argument("--no-codec", action="store_true")
    ap.add_argument("--render", action="store_true")
    args = ap.parse_args()

    from volumerenderer_tpu.io.bricks import (BrickGrid, file_brick_source,
                                              load_bricks, rm_brick_path)

    I, J, K = (int(v) for v in args.grid.split(","))
    assert I * J * K == args.bricks, (args.grid, args.bricks)
    grid = BrickGrid(brick_dims=(256, 256, 128), grid=(8, 8, 15))

    # 1. discovery
    missing = []
    for b in range(args.bricks):
        p = rm_brick_path(args.rm_dir, b, args.timestep)
        if not os.path.exists(p):
            missing.append(p)
    if missing:
        print(f"MISSING {len(missing)} brick files, e.g. {missing[0]}")
        return 1
    print(f"found {args.bricks} brick files for timestep {args.timestep}")

    # 2+3. size-checked load + assembly (typed errors on bad sizes)
    source = file_brick_source(args.rm_dir, grid)
    vol = load_bricks(source, grid, args.bricks, I, J, K, args.timestep)
    crc = zlib.crc32(vol.tobytes())
    print(f"assembled {vol.shape} volume; CRC32 0x{crc:08x}; "
          f"min {vol.min()} max {vol.max()} mean {vol.mean():.3f}")

    # 4. codec round trip (native build; main.cpp:253-258 settings)
    if not args.no_codec:
        from volumerenderer_tpu.codecs.kdtree import build_tree, level_cut

        tree = build_tree(vol, tolerance=1, max_epochs=2)
        rec = level_cut(tree, tree.orig_depth)
        err = np.abs(rec.astype(np.int32) - vol.astype(np.int32))
        print(f"codec leaf cut: max err {err.max()}, mean {err.mean():.4f}, "
              f"active nodes {tree.num_active_nodes}")

    # 5. one rendered frame through the compositing plan
    if args.render:
        from volumerenderer_tpu import (Camera, as_normalized_volume, backend,
                                        generate_rays)
        from volumerenderer_tpu.models import plan_compositing

        backend.enable_compile_cache()
        nv = as_normalized_volume(vol)
        Z, Y, X = nv.shape
        rays = generate_rays(Camera(width=1024, height=1024))
        plan = plan_compositing(rays.entry_uv, rays.direction, rays.hit,
                                (X, Y, Z))
        rgb, alpha = plan.render(nv)
        os.makedirs("out", exist_ok=True)
        np.save("out/rm_frame.npy", np.asarray(rgb))
        print("wrote out/rm_frame.npy; renderer =", plan.impl)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
