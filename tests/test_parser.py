"""Scene parser validation against known reference scene facts."""

import numpy as np
import pytest

from lajolla_tpu.scene.parser import parse_scene
from lajolla_tpu.scene import types as T

from scene_fixtures import CBOX

REF = "/root/reference/scenes"


def test_cbox_stats():
    sc, opts = parse_scene(CBOX)
    m = sc.meta
    assert m.num_shapes == 8
    assert m.num_materials == 5
    assert m.num_lights == 1
    assert (m.width, m.height) == (512, 512)
    assert opts.integrator == 'path'
    assert opts.max_depth == -1
    assert opts.samples_per_pixel == 4
    assert opts.filter_type == T.FILTER_GAUSSIAN
    # warm emitter spectrum integrates to R > G > B
    inten = np.asarray(sc.light_intensity[0])
    assert inten[0] > inten[1] > inten[2] > 0
    # camera position from lookAt
    assert np.allclose(np.asarray(sc.cam_to_world)[:3, 3],
                       [278, 273, -800])


def test_veach_mi_stats():
    sc, opts = parse_scene(f"{REF}/veach_mi/mi.xml")
    assert sc.meta.num_lights == 5
    assert sc.meta.num_spheres == 5
    assert opts.max_depth == 2  # 'direct' integrator


def test_volpath_scene():
    sc, opts = parse_scene(f"{REF}/volpath_test/volpath_test1.xml")
    assert opts.integrator == 'volpath'
    assert opts.vol_path_version == 1
    assert sc.meta.num_media == 1


def test_hetvol_scene():
    sc, opts = parse_scene(f"{REF}/volpath_test/hetvol.xml")
    m = sc.meta
    assert T.MED_HETEROGENEOUS in m.med_types_present
    # smoke.vol grid loaded with a nonzero majorant
    assert float(np.asarray(sc.vol_maxval).max()) > 0


def test_matpreview_envmap():
    sc, opts = parse_scene(f"{REF}/matpreview/matpreview.xml")
    assert sc.meta.has_envmap
    h, w = sc.meta.env_res
    assert (h, w) == (256, 512)
    # 2D CDF rows normalized
    assert np.allclose(np.asarray(sc.env_cond_cdf)[:, -1], 1.0, atol=1e-5)
    assert np.isclose(float(np.asarray(sc.env_marg_cdf)[-1]), 1.0)


def test_sponza_scale():
    sc, opts = parse_scene(f"{REF}/sponza/sponza.xml")
    assert sc.meta.use_bvh
    assert sc.meta.num_triangles > 60000
    assert sc.meta.num_images == 10
