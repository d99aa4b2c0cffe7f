"""The elliptic interface problem with W = diag(M·M) (the diagonal inverse,
golden 14) in both packages: see ``test_torch_elliptic.py``."""

import pytest

from test_torch_elliptic import check_variant


@pytest.mark.parametrize("name", ["diagonal"])
def test_variant_matches_reference(name):
    check_variant(name)
