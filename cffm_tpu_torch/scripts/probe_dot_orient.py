"""Probe the tensor cores' rate in three operand orientations on the card.

    python -m cffm_tpu_torch.scripts.probe_dot_orient

The port's counterpart of `scripts/probe_dot_orient.py`: per mode, D=16
accumulated bf16 products per step over 512 steps (kernel 9,
`ops.dot_probe`), at the TPU probe's shapes BT=128, P=744, KC=192:

  lane  (P, BT) . (KC, BT)^T   both operands K-major
  sub   (BT, P)^T . (BT, KC)   both MN-major (wgmma's transpose bits)
  rhs   (BT, KC) . (KC, P)     A K-major, B MN-major

Prints ms per call (CUDA events) and TMAC/s for each mode, then the
MN-major modes' time against lane's: what reading an operand MN-major
costs wgmma.
"""

from __future__ import annotations

import argparse

import torch

BT, P, KC, D, STEPS = 128, 744, 192, 16, 512


def make_operands(mode: str, device="cuda", bt: int = BT, p: int = P, kc: int = KC):
    """bf16 normal operands in the mode's layout (seeds 0 and 1)."""
    from cffm_tpu_torch.ops.dot_probe import operand_shapes

    device = torch.device(device)
    a_shape, b_shape, _ = operand_shapes(mode, bt, p, kc)
    a = torch.randn(a_shape, generator=torch.Generator(device=device).manual_seed(0),
                    device=device).to(torch.bfloat16)
    b = torch.randn(b_shape, generator=torch.Generator(device=device).manual_seed(1),
                    device=device).to(torch.bfloat16)
    return a, b


def run(mode: str, device="cuda", bt: int = BT, p: int = P, kc: int = KC, d: int = D,
        steps: int = STEPS, n: int = 20) -> dict:
    """Seconds per call and MACs per call of one mode."""
    from cffm_tpu_torch.ops.dot_probe import dot_probe, macs
    from cffm_tpu_torch.utils.timing import time_per_call

    a, b = make_operands(mode, device, bt, p, kc)
    dt = time_per_call(lambda: dot_probe(a, b, mode, steps, d), n=n, device=device)
    return {"s": dt, "macs": macs(mode, a, b, steps, d)}


def main(argv=None) -> int:
    from cffm_tpu_torch.ops.dot_probe import MODES

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    secs = {}
    for mode in MODES:
        r = run(mode)
        secs[mode] = r["s"]
        print(f"{mode}: {r['s'] * 1e3:.3f} ms  {r['macs'] / r['s'] / 1e12:.1f} TMAC/s",
              flush=True)
    print(f"sub/lane {secs['sub'] / secs['lane']:.4f}  rhs/lane {secs['rhs'] / secs['lane']:.4f}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
