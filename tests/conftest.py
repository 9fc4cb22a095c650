"""Test configuration. JAX runs on the CPU with 8 virtual devices unless
JAX_PLATFORMS says otherwise, so the sharding tests run anywhere; tests
marked `chip` need the GPU and skip without it:

    JAX_PLATFORMS=cuda python -m pytest -m chip
"""

import os

import pytest

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
if os.environ['JAX_PLATFORMS'] == 'cpu':
    os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                               ' --xla_force_host_platform_device_count=8')

import jax  # noqa: E402

# No jax_default_matmul_precision override here: tests run production
# numerics. Device code either uses explicit HIGHEST-precision dots or
# elementwise vec3 contractions (core/math.py, core/transform.py), and
# tests/test_casters.py checks the wavefront step's dots.
from lajolla_tpu.testing import (MATERIAL_XML_TYPES, make_single_material_scene,
                                 quad_mesh)  # noqa: F401,E402


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided per test, never at import:
    every xdist worker must collect the same tests)."""
    if jax.default_backend() != 'gpu':
        pytest.skip("needs the GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m chip")
