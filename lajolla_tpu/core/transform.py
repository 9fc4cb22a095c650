"""4x4 homogeneous transforms.

Host-side builders (numpy, parse time) mirror the reference's
translate/scale/rotate/look_at/perspective constructors
(src/transform.cpp:5-80); device-side application functions are jnp and
operate on batched points/vectors/normals. Normals transform by the
inverse-transpose (src/transform.cpp:101-105).
"""

import numpy as np
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Host-side builders (float64 numpy — precision is free at parse time)
# ---------------------------------------------------------------------------

def identity():
    return np.eye(4)


def translate(delta):
    m = np.eye(4)
    m[:3, 3] = np.asarray(delta, np.float64)
    return m


def scale(s):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = np.broadcast_to(np.asarray(s, np.float64), (3,))
    return m


def rotate(angle_deg, axis):
    """Rotation about an arbitrary axis, angle in degrees (Rodrigues)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    x, y, z = a
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    R = np.eye(3) * c + (1 - c) * np.outer(a, a) + s * K
    m = np.eye(4)
    m[:3, :3] = R
    return m


def look_at(origin, target, up):
    """Camera-to-world: +z toward target, x = up × z, y = z × x
    (matches src/transform.cpp:40-59)."""
    origin = np.asarray(origin, np.float64)
    d = np.asarray(target, np.float64) - origin
    d = d / np.linalg.norm(d)
    right = np.cross(np.asarray(up, np.float64) / np.linalg.norm(up), d)
    right = right / np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


def perspective(fov_deg):
    """Projective transform used by the pinhole camera chain; matches the
    reference's perspective() (src/transform.cpp:71-78) so that
    sample→camera ray directions agree numerically."""
    cot = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    return np.array([
        [cot, 0.0, 0.0, 0.0],
        [0.0, cot, 0.0, 0.0],
        [0.0, 0.0, 1.0, -1.0],
        [0.0, 0.0, 1.0, 0.0],
    ])


def inverse(m):
    return np.linalg.inv(m)


def parse_matrix_string(s):
    vals = [float(v) for v in s.replace(",", " ").split()]
    if len(vals) == 16:
        return np.asarray(vals, np.float64).reshape(4, 4)
    if len(vals) == 9:
        m = np.eye(4)
        m[:3, :3] = np.asarray(vals, np.float64).reshape(3, 3)
        return m
    raise ValueError(f"matrix string must have 9 or 16 entries, got {len(vals)}")


# ---------------------------------------------------------------------------
# Device-side application (jnp, batched)
# ---------------------------------------------------------------------------

def xform_point(m, p):
    """m: (4,4), p: (..., 3). Elementwise mul+sum, not einsum: dot_general
    at DEFAULT precision may drop mantissa bits on an accelerator — see
    core/math.to_local for the bias this caused."""
    r = (m[:3, :3] * p[..., None, :]).sum(-1) + m[:3, 3]
    w = (m[3, :3] * p).sum(-1) + m[3, 3]
    return r / w[..., None]


def xform_vector(m, v):
    return (m[:3, :3] * v[..., None, :]).sum(-1)


def xform_normal(m_inv, n):
    """Transform a normal by M: multiply by (M^-1)^T. Pass the *inverse*
    matrix. Result is not normalized."""
    return (m_inv[:3, :3] * n[..., :, None]).sum(-2)
