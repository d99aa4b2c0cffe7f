"""The elliptic interface problem, modified AL with the default W = M², at
cycle 1 in both packages (golden 10): see ``test_torch_elliptic.py``."""

import pytest

from test_torch_elliptic import check_variant


@pytest.mark.parametrize("name", ["default_cycle1"])
def test_variant_matches_reference(name):
    check_variant(name)
