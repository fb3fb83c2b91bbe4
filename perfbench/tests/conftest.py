"""Shared fixtures of the benchmark's own tests (CPU unless marked cuda)."""

import copy

import pytest

from perfbench import run, spec


@pytest.fixture
def device(request):
    """The device a test runs on; a cuda case skips without a card, decided here."""
    import torch

    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


def small_cell(L=4, dense_threshold=256):
    """The fem2d cell at a size a test holds: fem2d L=4 with ND on its fine
    levels, the cell's traffic and limits."""
    cell = copy.deepcopy(spec.load_cell(run.ROOT, "fem2d_L7.nd"))
    cell.config.update(L=L, backend={"dense_threshold": dense_threshold})
    return cell
