"""The elliptic interface problem with the operator-form AL term (the
9-point particle patch on every GMG level) in both packages: see
``test_torch_elliptic.py``."""

import pytest

from test_torch_elliptic import check_variant


@pytest.mark.parametrize("name", ["operator_form"])
def test_variant_matches_reference(name):
    check_variant(name)
