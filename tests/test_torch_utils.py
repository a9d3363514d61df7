"""The port's timing and profiling helpers (`cffm_tpu_torch.utils`) on the
CPU: device_time refusing to run without a card, and the profiler trace."""

import pytest
import torch

from cffm_tpu_torch.utils import profiling, timing


def test_device_time_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.device_time(lambda: None, n=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.time_per_call(lambda: None, n=2)   # no device: the card is meant


def test_time_per_call_on_the_cpu():
    calls = []
    dt = timing.time_per_call(lambda x: calls.append(x), 7, n=4, device="cpu")
    assert dt >= 0 and calls == [7] * 5  # one warm call, then n timed


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "t" / "trace.json").exists()
    assert any("mm" in e.key for e in prof.key_averages())

