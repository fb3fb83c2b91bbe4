"""The roofline counts against the bound column of PERF.md's kernel table."""

import pytest

from perfbench import roofline as R

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("work, ms", [
    (R.he_assemble(8192, 7, 4, 12, 8, True), 0.0117),  # A narrow, weighted entry
    (R.hvp(8192, 12, 6, 2, 961, 96, 8), 0.0030),  # fused hvp, m=961, table width 96
    (R.he_assemble(64, 64, 5, 128, 8, True), 0.0104),  # A-wide, fem3d L=3 k=3
    (R.segment_sum(883512, 1, 883512, 481636, 8, True, False), 0.0049),  # C at L=7
], ids=["A_narrow", "hvp", "A_wide", "segment_sum"])
def test_bound_column(work, ms):
    assert round(R.bound(*work, H100) * 1e3, 4) == ms


def test_bound_by():
    # A-wide is bound by its operations, the others by their bytes
    nbytes, flops = R.he_assemble(64, 64, 5, 128, 8, True)
    assert flops / R.PEAKS[H100][1] > nbytes / R.PEAKS[H100][0]
    nbytes, flops = R.he_assemble(8192, 7, 4, 12, 8, True)
    assert flops / R.PEAKS[H100][1] < nbytes / R.PEAKS[H100][0]


def test_unknown_card_has_no_bound():
    assert R.bound(1.0, 1.0, "cpu") is None


def test_gather_counts_touched_rows():
    # a gather of 10 rows from 1,000 reads 10 rows, not 1,000
    assert R.row_gather(10, 1000, 2, 8) == (4 * 10 + 8 * 2 * (10 + 10), 0)
    assert R.take_along_rows(10, 2, 1000, 8) == (4 * 20 + 8 * 2 * (10 + 10), 0)
