"""Multi-device sharded rendering consistency. Adapts to however many
devices the current backend exposes (8 virtual CPU devices under
tests/conftest.py)."""

import jax
import numpy as np
import pytest

from lajolla_tpu.integrators.path import render_path
from lajolla_tpu.parallel.mesh import default_mesh, render_path_sharded
from lajolla_tpu.scene.types import RenderOptions
from lajolla_tpu.testing import make_single_material_scene
from scene_fixtures import CBOX


def test_sharded_matches_single():
    ndev = len(jax.devices())
    mesh = default_mesh(jax.devices())
    scene = make_single_material_scene('diffuse')
    opts = RenderOptions(integrator='path', samples_per_pixel=2 * ndev,
                         max_depth=3)
    img_sh = np.asarray(render_path_sharded(scene, opts, mesh=mesh))
    assert np.isfinite(img_sh).all()
    img_1 = np.asarray(render_path(scene, opts))
    # different RNG partitioning → statistical agreement only
    assert abs(img_sh.mean() - img_1.mean()) < 0.05 * max(img_1.mean(), 1e-3)


def test_dryrun_entry():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()
    mod.dryrun_multichip(min(len(jax.devices()), 8))


def test_sharded_real_scene_cbox():
    """Shard a PARSED reference scene (not a synthetic fixture) across
    the mesh: full compiled-scene pytree (SoA tables, BVH/cluster
    arrays, CDFs, textures) replicated through shard_map, film psum'd.
    Gate: agrees with the single-device render of the same scene
    (different RNG partitioning -> statistical agreement)."""
    import dataclasses
    from test_golden import load_lowres, rel_rmse
    ndev = len(jax.devices())
    mesh = default_mesh(jax.devices())
    scene, opts = load_lowres(CBOX, 64)
    opts = dataclasses.replace(opts, samples_per_pixel=4 * ndev)
    img_sh = np.asarray(render_path_sharded(scene, opts, mesh=mesh))
    assert np.isfinite(img_sh).all()
    img_1 = np.asarray(render_path(scene, opts))
    assert abs(img_sh.mean() - img_1.mean()) < 0.05 * img_1.mean()
    assert rel_rmse(img_sh, img_1) < 0.25


def test_sharded_real_scene_vol_cbox():
    """Same gate for the volumetric engine on a parsed medium scene."""
    import dataclasses
    from test_golden import load_lowres, rel_rmse
    from lajolla_tpu.integrators.volpath import render_volpath
    from lajolla_tpu.parallel.mesh import render_sharded
    ndev = len(jax.devices())
    mesh = default_mesh(jax.devices())
    scene, opts = load_lowres(
        "/root/reference/scenes/volpath_test/vol_cbox.xml", 48)
    opts = dataclasses.replace(opts, samples_per_pixel=2 * ndev)
    img_sh = np.asarray(render_sharded(scene, opts, mesh=mesh))
    assert np.isfinite(img_sh).all()
    img_1 = np.asarray(render_volpath(scene, opts))
    assert abs(img_sh.mean() - img_1.mean()) < 0.07 * img_1.mean()
    assert rel_rmse(img_sh, img_1) < 0.35


def test_volpath_sharded_matches_single():
    from lajolla_tpu.integrators.volpath import render_volpath
    from lajolla_tpu.parallel.mesh import render_volpath_sharded
    from lajolla_tpu.testing import make_volume_scene
    ndev = len(jax.devices())
    mesh = default_mesh(jax.devices())
    scene = make_volume_scene()
    opts = RenderOptions(integrator='volpath',
                         samples_per_pixel=2 * ndev, max_depth=4)
    img_sh = np.asarray(render_volpath_sharded(scene, opts, mesh=mesh))
    assert np.isfinite(img_sh).all()
    img_1 = np.asarray(render_volpath(scene, opts))
    assert abs(img_sh.mean() - img_1.mean()) < 0.07 * max(img_1.mean(),
                                                          1e-3)


def test_aux_sharded_matches_single():
    """Aux integrators distribute by pixel ROWS (no sample axis): the
    sharded image must equal the single-device one EXACTLY — same
    deterministic pixel-center rays, just partitioned."""
    import dataclasses
    from test_golden import load_lowres
    from lajolla_tpu.parallel.mesh import render_sharded
    from lajolla_tpu.render import render
    mesh = default_mesh(jax.devices())
    scene, opts = load_lowres(CBOX, 48)
    for mode in ('depth', 'shadingNormal'):
        o = dataclasses.replace(opts, integrator=mode)
        img_sh = np.asarray(render_sharded(scene, o, mesh=mesh))
        img_1 = render(scene, o)
        np.testing.assert_allclose(img_sh, img_1, rtol=2e-5, atol=2e-5)


def test_volpath_simple_sharded_matches_single():
    """vol_path_version 1/2 (pedagogical ladder) through the sharded
    dispatch — previously raised NotImplementedError."""
    import dataclasses
    from test_golden import load_lowres
    from lajolla_tpu.integrators.volpath import render_volpath
    from lajolla_tpu.parallel.mesh import render_sharded
    ndev = len(jax.devices())
    mesh = default_mesh(jax.devices())
    scene, opts = load_lowres(
        "/root/reference/scenes/volpath_test/volpath_test2.xml", 48)
    opts = dataclasses.replace(opts, samples_per_pixel=2 * ndev)
    assert opts.vol_path_version == 2
    img_sh = np.asarray(render_sharded(scene, opts, mesh=mesh))
    assert np.isfinite(img_sh).all()
    img_1 = np.asarray(render_volpath(scene, opts))
    assert abs(img_sh.mean() - img_1.mean()) < 0.07 * img_1.mean()


def test_sharded_real_scene_matpreview():
    """Shard a BINNED (large-mesh class) parsed scene through
    shard_map: the cluster tables and worklist culling must behave
    identically replicated across chips."""
    import dataclasses
    from test_golden import load_lowres, rel_rmse
    ndev = len(jax.devices())
    mesh = default_mesh(jax.devices())
    scene, opts = load_lowres(
        "/root/reference/scenes/matpreview/matpreview.xml", 48)
    assert scene.meta.use_binned
    opts = dataclasses.replace(opts, samples_per_pixel=2 * ndev)
    img_sh = np.asarray(render_path_sharded(scene, opts, mesh=mesh))
    assert np.isfinite(img_sh).all()
    img_1 = np.asarray(render_path(scene, opts))
    assert abs(img_sh.mean() - img_1.mean()) < 0.07 * img_1.mean()
    assert rel_rmse(img_sh, img_1) < 0.35
