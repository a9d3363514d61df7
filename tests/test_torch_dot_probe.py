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
