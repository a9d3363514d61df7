"""The port's measurement scripts (`cffm_tpu_torch.scripts`) driven on the
CPU at tiny shapes, where every kernel wrapper takes its plain version: the
same code paths the card runs, minus the kernels. Nothing here is a time
of the card."""

import pytest
import torch

from cffm_tpu_torch import config
from cffm_tpu_torch.ops import bwd_variants as bv
from cffm_tpu_torch.ops import _build
from cffm_tpu_torch.scripts import (ablate_bwd, bench_apply, bench_bwd_variants, bench_kernel,
                                    profile_step, sweep_bwd_seeds, trace_step)

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


ABLATIONS = [(kernel, name) for kernel, (_, variants, _) in ablate_bwd.KERNELS.items()
             for name in sorted(variants)]


@pytest.mark.parametrize("kernel,name", ABLATIONS, ids=[f"{k}-{n}" for k, n in ABLATIONS])
def test_ablate_bwd_variants_match_the_kernel_source(kernel, name):
    """Each ablation variant's replaced text occurs once in its kernel's source."""
    source, variants, _ = ablate_bwd.KERNELS[kernel]
    text = (_build._CSRC / f"{source}.cu").read_text()
    out = ablate_bwd.variant_source(text, name, variants)
    assert out != text and all(new in out for _, new in variants[name])


@pytest.mark.parametrize("kernel", sorted(ablate_bwd.KERNELS))
def test_ablate_bwd_needs_a_card(kernel, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    assert ablate_bwd.main([f"--kernel={kernel}"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        ablate_bwd.main([f"--kernel={kernel}", "no_such_variant"])


def test_ablate_kernel6_streams_are_the_steps_segment_streams():
    """Kernel 6's ablation inputs at a small batch on the CPU: the flat
    stream is a segment index (from 0, steps of 0 or 1) within its m_pad;
    the stage-2 stream is each distinct id once, then one sentinel segment
    over the rest of the stage-1 slots, within its m_pad."""
    streams = ablate_bwd.segment_streams(512, device="cpu")
    seg, m_pad = streams["t1"]
    steps = seg[1:] - seg[:-1]
    assert seg[0] == 0 and ((steps == 0) | (steps == 1)).all()
    live = int(seg[-1]) + 1
    assert live <= m_pad
    seg2, m_pad2 = streams["stage2"]
    assert seg2.dtype == torch.int32 and seg2.numel() > live
    assert torch.equal(seg2[:live], torch.arange(live, dtype=torch.int32))
    assert (seg2[live:] == live).all() and live + 1 <= m_pad2


def test_sweep_bwd_seeds_reports_on_the_cpu():
    """The sweep's draw, backward and report at a tiny batch, where the
    wrappers take their plain versions: nothing apart, no launch."""
    cfg = sweep_bwd_seeds.model("hadamard", 3, 16)
    r = sweep_bwd_seeds.backward(cfg, *sweep_bwd_seeds.draw(cfg, 4, torch.Generator().manual_seed(0)))
    m = sweep_bwd_seeds.report(r)
    assert r["launches"] == 0 and r["de"].shape == (4, cfg.num_fields, 16)
    assert m["de_err"] == 0 and m["outside_2e-2"] == 0 and m["ulp_ratio"] == 0


def test_de_limit_ratio_counts_ulps():
    """An error of one bf16 ulp of |ref| where |ref| is the whole product
    sits at a third of the limit; of 6 ulps, at twice it."""
    ref = torch.tensor([[1.5, -3.0]])
    ulp = sweep_bwd_seeds.bf16_ulp(ref)
    assert torch.equal(ulp, torch.tensor([[2.0**-7, 2.0**-6]]))
    ratio = sweep_bwd_seeds.de_limit_ratio
    assert ratio(ref + ulp, ref, ref.abs()) == pytest.approx(1 / 3)
    assert ratio(ref + 6 * ulp, ref, ref.abs()) == pytest.approx(2.0)


def test_sweep_bwd_seeds_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_bwd_seeds.main(["--seeds=1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("shape", ["zipf", "bench"])
def test_bench_apply_inputs_keep_the_flat_contract(shape):
    """The apply's inputs at a tiny batch on the CPU: the unique ascending
    live prefix, the sentinel V after it, the padded slot count."""
    x = bench_apply.apply_inputs(shape, device="cpu", batch=64)
    u, n = x["uids"], x["rows"]
    assert u.dtype == torch.int32 and x["gsum"].shape == (u.numel(), x["w"]) == (u.numel(), 640)
    assert 0 < n <= 64 * 26 and bool((u[1:n] > u[:n - 1]).all()) and int(u[0]) >= 0
    assert bool((u[n:] == x["v"]).all()) and int(u[n - 1]) < x["v"]
    assert bench_apply.apply_bytes(u.numel(), n, 640, 4, "adagrad") == (
        u.numel() * 4 + n * 640 * (2 + 8) + n * 8)


def test_bench_apply_bound_and_bytes():
    """The bench twin's bound: 1,250,387 rows of 640 lanes, bf16 gradient and
    table read and written, accum read and written, 1.7M uids: ~1.44 ms."""
    nbytes = bench_apply.apply_bytes(1_703_936, 1_250_387, 640, 2, "adagrad")
    ms, by = bench_apply.bound_ms(nbytes, 1_250_387 * 640 * 6)
    assert by == "bytes" and 1.43 < ms < 1.45
    assert bench_apply.apply_bytes(10, 3, 128, 4, "sgd") == 40 + 3 * 128 * 10
    assert bench_apply.apply_bytes(10, 3, 128, 4, "rowwise_adam") == 40 + 3 * 128 * 18 + 24


def test_bench_apply_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_apply.main(["--shape=zipf"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
