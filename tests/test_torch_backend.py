"""Backend's device: a Backend built without one is a CUDA backend.

On a machine without a GPU, Backend() raises as backend_cuda() does instead
of yielding a CPU backend; backend_cpu() is how the CPU is asked for, and
dataclasses.replace keeps the device of the backend it copies.
"""

import dataclasses

import pytest
import torch

import multigridbarrier_tpu_torch as mt


@pytest.mark.parametrize("kw", [{}, {"dense_threshold": 64}, {"dtype": torch.float32}])
def test_backend_without_device_raises_without_gpu(monkeypatch, kw):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.Backend(**kw)


def test_backend_without_device_resolves_to_the_current_card(monkeypatch):
    """With a card present, the default device is the current CUDA device,
    index included (checked here without touching a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    b = mt.Backend(dense_threshold=64)
    assert b.device == torch.device("cuda", 3) and b.dense_threshold == 64


@pytest.mark.parametrize("change", [{"dense_threshold": 1 << 30}, {"dtype": torch.float32},
                                    {"itype": torch.int64}])
def test_replace_keeps_the_cpu_device(monkeypatch, change):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = dataclasses.replace(mt.backend_cpu(), **change)
    assert b.device == torch.device("cpu")
    for key, value in change.items():
        assert getattr(b, key) == value
    assert mt.Backend(device="cpu").device == torch.device("cpu")
