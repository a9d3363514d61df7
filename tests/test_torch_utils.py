"""The port's timing and profiling helpers (`cffm_tpu_torch.utils`) on the
CPU: StepTimer windows, JsonlLogger, device_time refusing to run without a
card, and the profiler trace."""

import json

import pytest
import torch

from cffm_tpu_torch.utils import profiling, timing


def test_step_timer_windows():
    t = profiling.StepTimer(sync_every=3, device="cpu")
    rates = [t.step(10) for _ in range(2)]
    assert all(r != r for r in rates)  # nan before the first window ends
    r = t.step(10)
    assert r > 0 and r == t.examples_per_s
    assert t.step(5) == r  # unchanged inside the next window
    with pytest.raises(ValueError):
        profiling.StepTimer(sync_every=0)


def test_jsonl_logger(tmp_path, capsys):
    path = tmp_path / "log.jsonl"
    with profiling.JsonlLogger(str(path)) as log:
        log.log({"step": 1, "loss": 0.5})
        log.log({"step": 2, "loss": 0.25})
    assert [json.loads(x) for x in path.read_text().splitlines()] == [
        {"step": 1, "loss": 0.5}, {"step": 2, "loss": 0.25}]
    assert capsys.readouterr().out.count("\n") == 2
    quiet = profiling.JsonlLogger(str(path), also_stdout=False)
    quiet.log({"step": 3})
    quiet.close()
    quiet.close()
    assert capsys.readouterr().out == ""
    assert len(path.read_text().splitlines()) == 3


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


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}
