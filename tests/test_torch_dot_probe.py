"""The port's orientation probe (`ops.dot_probe`, plain version on the CPU)
against the TPU probe's kernel `_mk(mode)` (scripts/probe_dot_orient.py) in
Pallas interpret mode, with the script's module constants set small at run
time (BT=16, P=24, KC=16, D=3, STEPS=2). The same numpy bf16 operands go to
both sides. Tolerance rtol 1e-5, atol 1e-4: both sum exact bf16 products in
f32, only in another order (outputs are O(10)).
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cffm_tpu_torch.ops import dot_probe as dp
from cffm_tpu_torch.scripts import probe_dot_orient as port_probe

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))
import probe_dot_orient as jprobe  # noqa: E402

SMALL = dict(BT=16, P=24, KC=16, D=3, STEPS=2)


@pytest.fixture
def small(monkeypatch):
    for name, v in SMALL.items():
        monkeypatch.setattr(jprobe, name, v)
    dp.dot_probe.launches = 0
    yield
    assert dp.dot_probe.launches == 0  # CPU tensors: the plain version


def _jax_probe(mode, a, b):
    _, _, out_shape = dp.operand_shapes(mode, SMALL["BT"], SMALL["P"], SMALL["KC"])
    fn = pl.pallas_call(
        jprobe._mk(mode), grid=(SMALL["STEPS"],),
        in_specs=[pl.BlockSpec(a.shape, lambda i: (0, 0)),
                  pl.BlockSpec(b.shape, lambda i: (0, 0))],
        out_specs=pl.BlockSpec(out_shape, lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32), interpret=True)
    return np.asarray(fn(a, b))


@pytest.mark.parametrize("mode", dp.MODES)
def test_probe_matches_jax_kernel(small, mode):
    a_shape, b_shape, out_shape = dp.operand_shapes(mode, SMALL["BT"], SMALL["P"],
                                                    SMALL["KC"])
    rng = np.random.default_rng(7)
    a32 = rng.normal(size=a_shape).astype(np.float32)
    b32 = rng.normal(size=b_shape).astype(np.float32)
    want = _jax_probe(mode, jnp.asarray(a32, jnp.bfloat16), jnp.asarray(b32, jnp.bfloat16))
    a = torch.from_numpy(a32).to(torch.bfloat16)
    b = torch.from_numpy(b32).to(torch.bfloat16)
    got = dp.dot_probe(a, b, mode, SMALL["STEPS"], SMALL["D"])
    assert got.dtype == torch.float32 and tuple(got.shape) == out_shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # each output is D times one product
    left, right = dp.operands(mode, a.float(), b.float())
    torch.testing.assert_close(got, SMALL["D"] * (left @ right), rtol=1e-5, atol=1e-4)
    assert dp.macs(mode, a, b, SMALL["STEPS"], SMALL["D"]) == (
        SMALL["STEPS"] * SMALL["D"] * SMALL["BT"] * SMALL["P"] * SMALL["KC"])


def test_probe_shapes_are_the_tpu_probes():
    """The script's constants and the MAC count of one call: 1.498e11."""
    assert (port_probe.BT, port_probe.P, port_probe.KC, port_probe.D, port_probe.STEPS) == (
        jprobe.BT, jprobe.P, jprobe.KC, jprobe.D, jprobe.STEPS)
    for mode in dp.MODES:
        a_shape, b_shape, _ = dp.operand_shapes(mode, jprobe.BT, jprobe.P, jprobe.KC)
        a, b = torch.empty(a_shape, device="meta"), torch.empty(b_shape, device="meta")
        assert dp.macs(mode, a, b, jprobe.STEPS, jprobe.D) == 149_786_984_448


def test_probe_rejects_bad_inputs():
    a = torch.zeros((24, 16), dtype=torch.bfloat16)
    b = torch.zeros((16, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mode lane"):
        dp.dot_probe(a, torch.zeros((16, 8), dtype=torch.bfloat16), "lane", 1, 1)
    with pytest.raises(TypeError, match="bfloat16"):
        dp.dot_probe(a.float(), b.float(), "lane", 1, 1)
    with pytest.raises(ValueError, match="mode must be"):
        dp.dot_probe(a, b, "diag", 1, 1)
    with pytest.raises(ValueError, match="positive"):
        dp.dot_probe(a, b, "lane", 0, 1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dp.dot_probe(a.to("meta"), b.to("meta"), "lane", 1, 1)


def test_probe_script_runs_on_the_cpu():
    r = port_probe.run("sub", device="cpu", bt=16, p=24, kc=16, d=2, steps=2, n=1)
    assert r["s"] > 0 and r["macs"] == 2 * 2 * 16 * 24 * 16


# ---------------------------------------------------------------------------
# The wgmma kernel's formulation (csrc/dot_orient_probe.cu) on the CPU: its
# (tile, step range) grid, and its shared-memory staging read back through
# its descriptors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("shape", [(128, 744, 192, 512), (64, 700, 200, 7), (16, 24, 16, 2),
                                   (100, 300, 48, 1), (32, 64, 64, 300)])
@pytest.mark.parametrize("mode", dp.MODES)
def test_schedule_covers_every_step_once_with_one_writer(mode, shape, sms):
    bt, p, kc, steps = shape
    sched = dp.schedule(mode, bt, p, kc, steps, sms)
    m, n, k = dp.gemm_dims(mode, bt, p, kc)
    assert sched["mtiles"] * 64 >= m > (sched["mtiles"] - 1) * 64
    assert sched["ntiles"] * sched["nw"] >= n > (sched["ntiles"] - 1) * sched["nw"]
    assert 1 <= sched["splits"] <= steps
    # the splits partition [0, steps), none empty; each split's two
    # warpgroups take alternate steps: every step of every tile runs once
    covered = []
    for lo, hi in sched["ranges"]:
        assert lo < hi
        for wg in range(2):
            covered += list(range(lo + wg, hi, 2))
    assert sorted(covered) == list(range(steps))
    split, wg = dp.writer(sched["ranges"], steps)
    lo, hi = sched["ranges"][split]
    assert hi == steps and (steps - 1) in range(lo + wg, hi, 2)
    assert sum(hi == steps for _, hi in sched["ranges"]) == 1
    # the grid fills the card (about two blocks per SM) when the steps allow
    tiles = sched["mtiles"] * sched["ntiles"]
    assert tiles * sched["splits"] >= min(2 * sms, tiles * steps)
    assert sched["smem"] == (64 + sched["nw"]) * k * 2 <= dp.SMEM_MAX


def test_schedule_at_the_probes_shapes():
    got = {mode: dp.schedule(mode, 128, 744, 192, 512, 132) for mode in dp.MODES}
    assert [(g["mtiles"], g["ntiles"], g["splits"]) for g in got.values()] == [
        (12, 1, 22), (12, 1, 22), (2, 3, 44)]
    assert got["rhs"]["nw"] == 248 and got["lane"]["smem"] == 65536


def _core_off(r, c, cgs):
    """The kernel's core_off: byte offset of (r, c) in 8x8 core matrices."""
    return ((r // 8) * cgs + c // 8) * 128 + (r % 8) * 16 + (c % 8) * 2


def _stage(x, cgs, nbytes):
    """A stored matrix x (rows, cols) staged as the kernel stages it."""
    smem = np.zeros(nbytes // 2, np.float32)
    r, c = np.meshgrid(np.arange(x.shape[0]), np.arange(x.shape[1]), indexing="ij")
    smem[_core_off(r, c, cgs) // 2] = x
    return smem


def _read(smem, start, lbo, sbo, mn_major, rows):
    """What wgmma reads for one k-step (rows x 16) from a no-swizzle
    descriptor: core matrix (i/8, kk/8) at start + (i/8)*sbo + (kk/8)*lbo,
    its 16-byte rows along MN (K-major) or along K (MN-major)."""
    i, kk = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    inner = (kk % 8) * 16 + (i % 8) * 2 if mn_major else (i % 8) * 16 + (kk % 8) * 2
    return smem[(start + (i // 8) * sbo + (kk // 8) * lbo + inner) // 2]


@pytest.mark.parametrize("mode", dp.MODES)
def test_wgmma_staging_and_descriptors_give_the_product(mode):
    """One product (D=1) at a ragged shape, tile by tile, with the kernel's
    staging (core_off, zeros past M and N) and its descriptors (lbo, sbo,
    the start advanced two core matrices along K per k-step)."""
    bt, p, kc = (48, 70, 200) if mode != "rhs" else (70, 300, 48)
    a_shape, b_shape, out_shape = dp.operand_shapes(mode, bt, p, kc)
    rng = np.random.default_rng(11)
    a = rng.integers(-3, 4, size=a_shape).astype(np.float32)
    b = rng.integers(-3, 4, size=b_shape).astype(np.float32)
    left, right = dp.operands(mode, torch.from_numpy(a), torch.from_numpy(b))
    want = (left @ right).numpy()
    m, n, k = dp.gemm_dims(mode, bt, p, kc)
    sched = dp.schedule(mode, bt, p, kc, 1, 132)
    nw, kg = sched["nw"], k // 8
    ta, tb = {"lane": (0, 0), "sub": (1, 1), "rhs": (0, 1)}[mode]
    l_st, r_st = (a, b) if mode != "rhs" else (b, a)   # stored L and R
    got = np.zeros(out_shape, np.float32)
    for mt in range(sched["mtiles"]):
        for nt in range(sched["ntiles"]):
            m0, n0 = 64 * mt, nw * nt
            if ta == 0:   # [m][k]
                lt = np.zeros((64, k), np.float32)
                lt[:min(64, m - m0)] = l_st[m0:m0 + 64]
                sa = _stage(lt, kg, 64 * k * 2)
            else:         # [k][m]
                lt = np.zeros((k, 64), np.float32)
                lt[:, :min(64, m - m0)] = l_st[:, m0:m0 + 64]
                sa = _stage(lt, 8, 64 * k * 2)
            if tb == 0:   # [n][k]
                rt = np.zeros((nw, k), np.float32)
                rt[:min(nw, n - n0)] = r_st[n0:n0 + nw]
                sb = _stage(rt, kg, nw * k * 2)
            else:         # [k][n]
                rt = np.zeros((k, nw), np.float32)
                rt[:, :min(nw, n - n0)] = r_st[:, n0:n0 + nw]
                sb = _stage(rt, nw // 8, nw * k * 2)
            a_lbo, a_sbo = (128, kg * 128) if ta == 0 else (8 * 128, 128)
            b_lbo, b_sbo = (128, kg * 128) if tb == 0 else (nw // 8 * 128, 128)
            acc = np.zeros((64, nw), np.float32)
            for ks in range(k // 16):
                at = _read(sa, ks * 2 * a_lbo, a_lbo, a_sbo, ta, 64)      # (64, 16)
                bt_ = _read(sb, ks * 2 * b_lbo, b_lbo, b_sbo, tb, nw)     # (N, 16)
                acc += at @ bt_.T
            rows, cols = min(64, m - m0), min(nw, n - n0)
            got[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    np.testing.assert_array_equal(got, want)
