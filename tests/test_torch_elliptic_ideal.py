"""The elliptic interface problem with the ideal AL preconditioner (the
coupled 2x2 inverse, golden 6) in both packages: see
``test_torch_elliptic.py``."""

import pytest

from test_torch_elliptic import check_variant


@pytest.mark.parametrize("name", ["ideal"])
def test_variant_matches_reference(name):
    check_variant(name)
