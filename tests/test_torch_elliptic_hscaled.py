"""The elliptic interface problem with the h-scaled mass W = M/h² in both
packages: see ``test_torch_elliptic.py``."""

import pytest

from test_torch_elliptic import check_variant


@pytest.mark.parametrize("name", ["h_scaled"])
def test_variant_matches_reference(name):
    check_variant(name)
