"""Renderer: wavefront path tracing.

Replaces the reference's L4b layer (``include/fluid/renderer/``,
``src/renderer/``). The ``std::variant`` primitive/material dispatch becomes
flat SoA tensors with integer kind ids; the recursive/loop tracers become
wavefront loops over masked ray batches; the per-thread pcg32 RNG becomes
counter-based ``jax.random`` streams.
"""

from libfluid_tpu.renderer.camera import Camera
from libfluid_tpu.renderer.scene import Scene, SceneBuilder
from libfluid_tpu.renderer import materials, scenes
from libfluid_tpu.renderer.pathtrace import trace_rays
from libfluid_tpu.renderer.render import render, render_image

__all__ = [
    "Camera",
    "Scene",
    "SceneBuilder",
    "materials",
    "scenes",
    "trace_rays",
    "render",
    "render_image",
]
