"""REAL multi-process multi-host validation (SURVEY §5 "distributed comm
backend").

Two separate Python processes join one ``jax.distributed`` runtime (the
same call a multi-host GPU job uses; collectives ride Gloo on CPU here, NCCL
on GPUs), each exposing 4 CPU devices — an 8-device global mesh across 2
"hosts".  Each process:

* reads ONLY its own bricks (``multihost.host_local_bricks`` /
  ``load_bricks_for_host`` — per-host I/O),
* donates its slab to the global z-sharded volume
  (``jax.make_array_from_process_local_data``),
* renders with ``render_zsharded`` over the global mesh — ppermute halo
  exchange and the segment composition now run ACROSS PROCESSES,
* checks the result against the full-volume single-process jnp renderer
  (the synthetic source is deterministic, so each process can build the
  reference locally).

This is the closest a single machine gets to the >=2-host north star; the
remaining gap (real cross-host numbers) needs several hosts.
"""
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
port = sys.argv[2]
sys.path.insert(0, {repo!r})

from volumerenderer_tpu.parallel import multihost as MH
MH.initialize(f"localhost:{{port}}", num_processes=2, process_id=pid)
assert jax.process_count() == 2 and jax.device_count() == 8

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from volumerenderer_tpu import Camera, generate_rays, as_normalized_volume
from volumerenderer_tpu.io.bricks import BrickGrid, load_bricks, synthetic_brick_source
from volumerenderer_tpu.parallel.context import make_z_mesh, render_zsharded
from volumerenderer_tpu.ops.raycast import render_compositing

grid = BrickGrid(brick_dims=(32, 16, 8), grid=(2, 2, 4))
src = synthetic_brick_source(grid)

# per-host brick I/O: this process reads only the bricks backing its slab
mine = MH.host_local_bricks(grid, jax.process_count())
assert len(mine) == grid.num_bricks() // 2, (pid, mine)
slab = MH.load_bricks_for_host(src, grid, timestep=273)
assert slab is not None and slab.shape[0] == 16, slab.shape

zmesh = make_z_mesh(8)
sharding = NamedSharding(zmesh, P("z"))
# dim the field like tests/test_context_parallel.py: with saturating
# opacity the segment-factorized transmittance products lose ~1e-2 of
# precision vs the fused recurrence (same envelope single-process)
vol = jax.make_array_from_process_local_data(
    sharding, np.asarray(as_normalized_volume(slab)) * 0.25)
assert vol.shape == (32, 32, 64), vol.shape

rays = generate_rays(Camera(width=32, height=16))
rgb, alpha = render_zsharded(zmesh, vol, rays.entry_uv, rays.direction,
                             rays.hit, max_samples=16)

# reference: full volume assembled locally (deterministic synthetic source)
full = as_normalized_volume(load_bricks(src, grid, grid.num_bricks(),
                                        2, 2, 4, 273)) * 0.25
rgb_ref, a_ref = render_compositing(full, rays.entry_uv, rays.direction,
                                    rays.hit, max_samples=16,
                                    early_exit=False)
np.testing.assert_allclose(np.asarray(rgb), np.asarray(rgb_ref), atol=1e-5)
np.testing.assert_allclose(np.asarray(alpha), np.asarray(a_ref), atol=1e-5)
print(f"proc {{pid}} OK", flush=True)
'''


def test_two_process_zsharded_render(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "mh_worker.py"
    script.write_text(WORKER.format(repo=REPO))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen([sys.executable, "-u", str(script), str(i),
                               str(port)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out, out[-2000:]
