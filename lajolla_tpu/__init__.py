"""lajolla_tpu — a wavefront physically-based renderer in JAX.

A from-scratch JAX/XLA re-design of the lajolla CPU path tracer
(UCSD CSE 272; reference layout documented in SURVEY.md).
The recursive CPU megakernel becomes a SoA wavefront pipeline under
`lax.while_loop`; Embree becomes a host-built BVH traversed by a
branch-free threaded traversal on device; `std::variant` polymorphism
becomes integer tags + flat parameter tables.

Public entry points:
    parse_scene(path)            -> Scene (device pytree) + RenderOptions
    render(scene, options)       -> film (H, W, 3) float32
    imwrite(path, img)           -> .pfm / .exr output
"""

from lajolla_tpu.dtypes import Real

__version__ = "0.1.0"


def parse_scene(path):
    from lajolla_tpu.scene.parser import parse_scene as _p
    return _p(path)


def render(scene, options=None):
    from lajolla_tpu.render import render as _r
    return _r(scene, options)


def imwrite(path, img):
    from lajolla_tpu.io.image import imwrite as _w
    return _w(path, img)
