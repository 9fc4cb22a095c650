"""Vector math over trailing-axis-3 arrays.

The reference's TVector3/Frame classes (src/vector.h, src/frame.h) become
free functions over `(..., 3)` jnp arrays: the natural SoA/wavefront layout
for the VPU. Everything broadcasts, everything vmaps.
"""

import jax.numpy as jnp

from lajolla_tpu.dtypes import Real


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def dotk(a, b):
    """dot with keepdims — convenient for throughput-style broadcasting."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    return jnp.cross(a, b)


def length_squared(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_squared(v))


def normalize(v, eps=0.0):
    l2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jax_rsqrt(jnp.maximum(l2, jnp.asarray(eps * eps + 1e-38, v.dtype)))


def jax_rsqrt(x):
    import jax.lax
    return jax.lax.rsqrt(x)


def _make_safe_sqrt():
    import jax

    @jax.custom_jvp
    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 0.0))

    @safe_sqrt.defjvp
    def _safe_sqrt_jvp(primals, tangents):
        (x,), (t,) = primals, tangents
        y = jnp.sqrt(jnp.maximum(x, 0.0))
        return y, t * 0.5 / jnp.sqrt(jnp.maximum(x, 1e-12))

    return safe_sqrt


safe_sqrt = _make_safe_sqrt()
safe_sqrt.__doc__ = """sqrt(max(x, 0)) with a CLAMPED derivative.

Primal is bit-identical to jnp.sqrt(jnp.maximum(x, 0)); the tangent
uses 1/(2*sqrt(max(x, 1e-12))). At clip-to-zero sites (VNDF disk rim,
Fresnel/refraction cosines) the true derivative is inf, and reverse
mode turns the ZERO cotangent of a masked lane into 0/0 = NaN, which
the film-gradient reduction then spreads everywhere — the dominant
source of NaN gradients in the detached estimators
(integrators/diffpath.py). Use for every sqrt whose argument is
clamped at 0 on a parameter-tangent path."""


def distance(a, b):
    return length(a - b)


def distance_squared(a, b):
    return length_squared(a - b)


def lerp(a, b, t):
    return a + (b - a) * t


def vec3(x, y, z):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, Real), jnp.asarray(y, Real), jnp.asarray(z, Real)), axis=-1)


def xcomp(v):
    return v[..., 0]


def ycomp(v):
    return v[..., 1]


def zcomp(v):
    return v[..., 2]


# ---------------------------------------------------------------------------
# Orthonormal frames (reference: src/frame.h)
# ---------------------------------------------------------------------------

def coordinate_system(n):
    """Branch-free Frisvad/Duff ONB from a unit normal.

    Matches the construction in the reference's Frame (src/frame.h:12-22) up
    to sign conventions; any valid ONB is acceptable since downstream BSDF
    sampling is rotationally symmetric around n (or uses both tangents
    consistently).

    Returns (t, b): tangent and bitangent, each shaped like n.
    """
    z = n[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0).astype(n.dtype)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack([1.0 + sign * n[..., 0] * n[..., 0] * a,
                   sign * b,
                   -sign * n[..., 0]], axis=-1)
    bt = jnp.stack([b,
                    sign + n[..., 1] * n[..., 1] * a,
                    -n[..., 1]], axis=-1)
    return t, bt


def make_frame(n):
    """Frame as a (..., 3, 3) matrix with rows (t, b, n)."""
    t, b = coordinate_system(n)
    return jnp.stack([t, b, n], axis=-2)


def to_local(frame, v):
    """World → frame-local. frame: (..., 3, 3) rows (t,b,n); v: (..., 3).

    Elementwise mul+sum, NOT einsum/dot: a dot_general at DEFAULT
    precision may run with a reduced-precision mantissa on an
    accelerator (bf16 passes, or TF32 on a GPU), which quantizes every
    shading-frame transform — once seen as a depth-compounding
    brightness bias on near-specular glass chains (matpreview teapot +4%
    film mean at 64x64) because Fresnel near the TIR boundary is blown
    across the critical angle. The elementwise form is exact fp32, and a
    3-wide contraction gains nothing from a matrix unit."""
    return (frame * v[..., None, :]).sum(-1)


def to_world(frame, v):
    """Frame-local → world. Elementwise for exact fp32 (see to_local)."""
    return (frame * v[..., :, None]).sum(-2)


def frame_n(frame):
    return frame[..., 2, :]


# ---------------------------------------------------------------------------
# Reflection / refraction
# ---------------------------------------------------------------------------

def reflect(w, n):
    """Mirror w about n (both pointing away from surface)."""
    return 2.0 * dotk(w, n) * n - w


def refract(w, n, eta):
    """Refract w about n with relative IOR eta = n_inside / n_outside.

    w points away from the surface on the n side. Returns (wt, valid) where
    valid=False marks total internal reflection.
    """
    cos_i = dot(w, n)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = sin2_i / (eta * eta)
    valid = sin2_t < 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    wt = -w / eta[..., None] + (cos_i / eta - cos_t)[..., None] * n
    return wt, valid


def luminance(rgb):
    """Rec. 709 luminance (reference: src/spectrum.h:32)."""
    return (rgb[..., 0] * 0.212671 +
            rgb[..., 1] * 0.715160 +
            rgb[..., 2] * 0.072169)


def max_component(v):
    return jnp.max(v, axis=-1)


def avg_component(v):
    return jnp.mean(v, axis=-1)
