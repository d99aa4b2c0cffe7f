"""The results table's rational row at refinement 8 in both packages on the
CPU, in float64 and float32: see ``test_torch_rational_table.py``."""

import pytest

from test_torch_rational_table import check_row


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_rational_table_row_8(precision):
    check_row(8, precision)
