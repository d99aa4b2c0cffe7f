"""The tile geometry of K2's sweep kernel as the Python side mirrors it from
``csrc/fdal_sweep.cuh`` (the modes ``smooth``, ``pre``, ``post`` and the
no-patch ``op``; the patched ``op`` has a kernel of its own, whose mirror
``tests/test_torch_apply.py`` holds): the tests on the card and
``chip_smoke.py`` place lattices and patch boxes on its output-tile edges, so
the mirror must match the header."""

import os
import re

import pytest

from fictitious_domain_al_preconditioners_torch.ops import kernels as K

HEADER = K.HEADERS[0]


def _constant(name):
    text = open(HEADER).read()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, f"{name} not found in {HEADER}"
    return int(m.group(1))


def test_sweep_tile_mirrors_header():
    ey = _constant("TROWS") * _constant("RUN")
    assert K.SWEEP_TILE == (ey, _constant("EX"))
    assert K._MAX_DEGREE == _constant("MAX_DEG")


@pytest.mark.parametrize("mode", K.MODES)
@pytest.mark.parametrize("degree", [2, 3, 4, 5, 6])
def test_output_tile_is_the_tile_less_one_point_per_application(mode,
                                                                degree):
    apps = {"op": 1, "smooth": degree - 1, "pre": degree,
            "post": degree}[mode]
    ty, tx = K.sweep_output_tile(mode, degree)
    assert (ty, tx) == (K.SWEEP_TILE[0] - 2 * apps,
                        K.SWEEP_TILE[1] - 2 * apps)
    assert ty > 0 and tx > 0


def test_k2_sources_share_the_header_and_are_built():
    names = {os.path.basename(s) for s in K.SOURCES}
    assert {"fdal_kernels.cu", "fdal_pre.cu", "fdal_post.cu"} <= names
    for src in K.SOURCES:
        if os.path.basename(src) not in ("fdal_stencil.cu", "fdal_masked.cu",
                                         "fdal_augmented.cu"):
            assert '#include "fdal_sweep.cuh"' in open(src).read(), src
    assert all(os.path.exists(p) for p in K.SOURCES + K.HEADERS)
