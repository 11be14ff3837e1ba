"""The reference's offline-render metric: 800x800 @ 400 spp BDPT wall-clock.

Mirrors the testbed's F5 export (``testbed/main.cpp:429-453``): the Cornell
box rendered with the bidirectional integrator at the reference's offline
resolution/sample count, wall-clock printed and the image saved. The
reference never recorded a number for this (BASELINE.md); this script
measures it.

Run on the GPU: ``python benchmarks/offline_render.py [width] [spp]
[camera_bounces] [light_bounces]``.
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import jax
import numpy as np

from libfluid_tpu.config import RenderConfig
from libfluid_tpu.io.ppm import save_ppm
from libfluid_tpu.renderer import scenes
from libfluid_tpu.renderer.render import render

W = int(sys.argv[1]) if len(sys.argv) > 1 else 800
SPP = int(sys.argv[2]) if len(sys.argv) > 2 else 400
TB = int(sys.argv[3]) if len(sys.argv) > 3 else 6
SB = int(sys.argv[4]) if len(sys.argv) > 4 else 6


def main():
    builder, cam = scenes.cornell_box_one_light(1.0)
    scene = builder.finish()
    cfg = RenderConfig(
        width=W, height=W, samples_per_pixel=SPP, max_bounces=5,
        algorithm="bdpt", differentiable=False,
        max_camera_bounces=TB, max_light_bounces=SB,
    )
    fn = jax.jit(render, static_argnums=(2,))
    t0 = time.time()
    img = np.asarray(fn(scene, cam, cfg, jax.random.PRNGKey(0)))
    wall = time.time() - t0
    rays = W * W * SPP * (TB + SB)
    print(
        f"offline BDPT {W}x{W} @ {SPP}spp ({TB}+{SB} bounces): "
        f"{wall:.1f}s wall (incl. compile) = {rays/wall/1e6:.1f} Mrays/s "
        f"mean={img.mean():.4f}",
        flush=True,
    )
    out = os.path.join(_ROOT, "renders", "cornell_offline.ppm")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_ppm(out, img, gamma=2.2)
    print("wrote", out, flush=True)


if __name__ == "__main__":
    main()
