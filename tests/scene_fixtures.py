import os

from lajolla_tpu.testing import (MATERIAL_XML_TYPES, make_single_material_scene,
                                 quad_mesh)  # noqa: F401

# scenes shipped with the repository (the others of the reference corpus
# are not in the repository; tests that need them fail to find them)
SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
CBOX = os.path.join(SCENES, "cbox", "cbox.xml")
