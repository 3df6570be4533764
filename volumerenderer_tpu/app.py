"""End-to-end application driver — the ``main()`` equivalent
(``main.cpp:84-422``): load bricks -> compress -> save -> decode level cut ->
render frames, plus the interactive camera-state machine (WASD/arrow motion,
mouse look, scroll zoom, isovalue stepping: ``main.cpp:462-578``) as pure
functions over a ``CameraState``.
"""
from __future__ import annotations

import dataclasses
import math


import numpy as np

from .camera import Camera, generate_rays
from .config import AppConfig
from .codecs import kdtree as K
from .io.bricks import BrickGrid, file_brick_source, load_bricks
from .io.synthetic import turbulence_volume, sphere_volume
from .models.compressed import CompressedRenderer
from .utils.timer import DebugTimer, Metrics

__all__ = ["run", "CameraState", "move", "look", "zoom", "reset", "step_isovalue"]


# ---------------------------------------------------------------------------
# Camera-state machine (main.cpp:462-578)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CameraState:
    position: tuple = (0.0, 0.0, -0.75)      # main.cpp:33
    front: tuple = (0.0, 0.0, 1.0)
    up: tuple = (0.0, 1.0, 0.0)
    yaw: float = 0.0
    pitch: float = 0.0
    fov: float = 50.0
    iso_value: float = 40.0                  # main.cpp:52 (in 0..255)

    def camera(self, width: int, height: int) -> Camera:
        return Camera(position=self.position, front=self.front, up=self.up,
                      fov_y_degrees=self.fov, width=width, height=height)


def move(st: CameraState, key: str, dt: float) -> CameraState:
    """WASD/arrow motion (``do_movement``, main.cpp:462-478): speed 2.5*dt."""
    speed = 2.5 * dt
    pos = np.asarray(st.position, np.float64)
    front = np.asarray(st.front, np.float64)
    up = np.asarray(st.up, np.float64)
    if key == "up":
        pos = pos + speed * front
    elif key == "down":
        pos = pos - speed * front
    elif key == "left":
        right = np.cross(front, up)
        pos = pos - right / np.linalg.norm(right) * speed
    elif key == "right":
        right = np.cross(front, up)
        pos = pos + right / np.linalg.norm(right) * speed
    return dataclasses.replace(st, position=tuple(pos))


def look(st: CameraState, dx: float, dy: float) -> CameraState:
    """Mouse look (``mouse_callback``, main.cpp:525-566): yaw += dx,
    pitch += dy clamped to +-89; front from spherical angles."""
    yaw = st.yaw + dx
    pitch = min(89.0, max(-89.0, st.pitch + dy))
    front = (
        math.cos(math.radians(pitch)) * math.cos(math.radians(yaw)),
        math.sin(math.radians(pitch)),
        math.sin(math.radians(yaw)),
    )
    n = math.sqrt(sum(f * f for f in front))
    return dataclasses.replace(st, yaw=yaw, pitch=pitch,
                               front=tuple(f / n for f in front))


def zoom(st: CameraState, scroll: float) -> CameraState:
    """Scroll zoom (``scroll_callback``, main.cpp:509-518): fov in [1, 50]."""
    fov = st.fov
    if 1.0 <= fov <= 50.0:
        fov -= scroll
    return dataclasses.replace(st, fov=min(50.0, max(1.0, fov)))


def reset(st: CameraState) -> CameraState:
    """Enter key (``reset``, main.cpp:568-578)."""
    return CameraState(iso_value=st.iso_value)


def step_isovalue(st: CameraState, direction: int) -> CameraState:
    """Keys 0/1 step the isovalue by 5 within [0, 255] (main.cpp:489-498)."""
    v = st.iso_value + 5.0 * direction
    return dataclasses.replace(st, iso_value=min(255.0, max(0.0, v)))


# ---------------------------------------------------------------------------
# End-to-end pipeline
# ---------------------------------------------------------------------------

def run(cfg: AppConfig = AppConfig(), num_frames: int = 1, save_tree: bool = False):
    """The reference main() flow.  Returns (frames, metrics)."""
    metrics = Metrics()

    # 1. load dataset (main.cpp:242)
    DebugTimer.begin(1, "LOAD")
    if cfg.dataset.source == "rm_bricks":
        grid = BrickGrid(cfg.dataset.brick_dims, cfg.dataset.volume_grid)
        src = file_brick_source(cfg.dataset.top_dir, grid)
        I, J, Kb = cfg.dataset.load_grid
        volume = load_bricks(src, grid, cfg.dataset.num_bricks, I, J, Kb,
                             cfg.dataset.timestep)
    elif cfg.dataset.synthetic_kind == "sphere":
        volume = sphere_volume(cfg.dataset.synthetic_dims)
    else:
        volume = turbulence_volume(cfg.dataset.synthetic_dims,
                                   seed=cfg.dataset.timestep)
    DebugTimer.end("LOAD")
    metrics.record(volume_gb=volume.nbytes / 1e9)

    # 2. compress (main.cpp:251-259)
    DebugTimer.begin(1, "TOTAL_CONSTRUCTION")
    tree = K.build(volume, tolerance=cfg.codec.tolerance,
                   max_epochs=cfg.codec.max_epochs)
    DebugTimer.end("TOTAL_CONSTRUCTION")
    metrics.record(num_active_nodes=tree.num_active_nodes,
                   compressed_bits_per_voxel=2 * tree.num_active_nodes / volume.size)

    # 3. save (main.cpp:267)
    if save_tree:
        K.save(tree, cfg.tree_path)

    # 4. decode + render loop (main.cpp:280-411)
    renderer = CompressedRenderer(tree)
    cam = cfg.render.camera
    rays = generate_rays(cam)
    frames = []
    DebugTimer.begin(max(1, num_frames), "LOOP")
    for _ in range(num_frames):
        if cfg.render.render_mode == "isosurface":
            rgb, aux = renderer.render(rays, cut_depth=cfg.codec.cut_depth,
                                       mode="isosurface",
                                       iso_value=cfg.render.iso_value)
        else:
            rgb, aux = renderer.render(rays, cut_depth=cfg.codec.cut_depth,
                                       max_samples=cfg.render.max_samples)
        frames.append(np.asarray(rgb))  # forces completion (honest timing)
    DebugTimer.end("LOOP")
    metrics.record(frame_ms=DebugTimer.mean_ms("LOOP"),
                   decode="device" if renderer.decoded_on_device(
                       cfg.codec.cut_depth) else "host")
    return frames, metrics
