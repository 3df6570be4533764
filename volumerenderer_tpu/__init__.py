"""volumerenderer_tpu — a differentiable volume-rendering framework in JAX.

Built from scratch in JAX/XLA with a Pallas (Triton) march kernel for the GPU,
replicating the capabilities of the C++/OpenGL reference renderer
(AugmentariumLab/VolumeRenderer; see SURVEY.md): bricked scalar-volume I/O,
progressive kd-tree compression with 2-bit delta codes and
gradient-descent-fit distance maps (plus mid-range dual-tree, Morton-hashed,
and octree variants), level-cut decode, and front-to-back compositing / Phong
isosurface raycasting — differentiable end-to-end and sharded across device
meshes with ``shard_map``.
"""

from .camera import Camera, RayBundle, generate_rays, orbit_camera
from .config import AppConfig, CodecConfig, DatasetConfig, RenderConfig
from .ops.sampling import sample_trilinear, as_normalized_volume
from .ops.raycast import composite_march, render_compositing
from .ops.isosurface import render_isosurface

__version__ = "0.1.0"

__all__ = [
    "AppConfig",
    "CodecConfig",
    "DatasetConfig",
    "RenderConfig",
    "Camera",
    "RayBundle",
    "generate_rays",
    "orbit_camera",
    "sample_trilinear",
    "as_normalized_volume",
    "composite_march",
    "render_compositing",
    "render_isosurface",
]
