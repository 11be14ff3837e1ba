"""Math substrate: interpolation, transforms, sample warping, intersection tests.

Replaces the reference's L1 math layer (``include/fluid/math/``). There is no
vector class: everything is plain ``jnp`` arrays with a trailing axis of size 3,
batched over leading axes — the replacement for ``vec3d`` loops and the AVX
``vec_simd.h`` utilities (XLA vectorizes them).
"""

from libfluid_tpu.math.interp import lerp, bilerp, trilerp
from libfluid_tpu.math import transforms, warping, intersection

__all__ = ["lerp", "bilerp", "trilerp", "transforms", "warping", "intersection"]
