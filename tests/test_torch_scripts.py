"""The port's measurement scripts (`cffm_tpu_torch.scripts`) driven on the
CPU at tiny shapes, where every kernel wrapper takes its plain version: the
same code paths the card runs, minus the kernels. Nothing here is a time
of the card."""

import pytest
import torch

from cffm_tpu_torch import config
from cffm_tpu_torch.ops import bwd_variants as bv
from cffm_tpu_torch.scripts import bench_bwd_variants, bench_kernel, profile_step, trace_step

MIXED = (32, 64, 128) + (1000,) * 12          # F=15: fused column, 3 small fields


def _tiny(batch=32):
    return config.TrainConfig(
        name="t", model=config.ModelConfig(
            num_fields=15, vocab_sizes=MIXED, embed_dim=16, conv_channels=(8,),
            tower_hidden=(16,), num_dense=3, compute_dtype="float32"),
        data=config.DataConfig(batch_size=batch))


def test_bench_kernel_runs():
    r = bench_kernel.run(_tiny().model, 8, torch.float32, device="cpu", n_fwd=1, n_bwd=1)
    assert r["fwd_s"] > 0 and r["fwd_bwd_s"] > 0


def test_bench_bwd_variants_check_passes():
    bv.reset_launches()
    times = bench_bwd_variants.run(_tiny().model, 8, device="cpu", check=True, n=1)
    assert sorted(times) == ["v0", "v1", "v2"] and min(times.values()) > 0
    assert all(fn.launches == 0 for fn in bv.VARIANTS.values())


def test_bench_bwd_variants_inputs():
    x = bench_bwd_variants.make_inputs(_tiny().model, 8, device="cpu")
    assert tuple(x["emb3"].shape) == (15, 8, 256) and x["emb3"].dtype == torch.bfloat16
    assert tuple(x["g"].shape) == (8, 8 * 16) and x["glin"].dtype == torch.float32
    assert tuple(x["wrs"].shape) == (3 * 8, 112)
    torch.testing.assert_close(x["wr"], x["wrs"].t(), rtol=0, atol=0)


@pytest.mark.parametrize("stage", profile_step.STAGES)
def test_profile_step_stage_runs(stage):
    assert profile_step.run(stage, _tiny(), device="cpu", n=1) > 0


def test_trace_step_reports_no_device_time_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prof = trace_step.capture(_tiny(), 1, str(tmp_path), device="cpu")
    assert trace_step.report(prof, 1) == 0.0
    assert "no device time" in capsys.readouterr().out
    assert (tmp_path / "trace.json").exists()
