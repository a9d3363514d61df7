"""Probe of the tensor cores' operand orientations (kernel 9).

The port's counterpart of the Pallas kernel in `scripts/probe_dot_orient.py`.
Per step the kernel sums D bf16 products into f32 and writes the last
step's sum: out = sum over D of L . R, with the operands in the script's
layouts (`csrc/dot_orient_probe.cu` says which loads each mode takes):

  lane  a (P, BT), b (KC, BT) -> a @ b.T   (P, KC)
  sub   a (BT, P), b (BT, KC) -> a.T @ b   (P, KC)
  rhs   a (KC, P), b (BT, KC) -> b @ a     (BT, P)

`dot_probe` launches the kernel for CUDA tensors and takes the plain
version (`dot_probe_reference`: the D products looped in f32) for CPU
tensors; any other device raises. Its launches are counted in
`dot_probe.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from cffm_tpu_torch.ops import _build

_SOURCE = "dot_orient_probe"
MODES = ("lane", "sub", "rhs")


def operand_shapes(mode: str, bt: int, p: int, kc: int):
    """(a shape, b shape, out shape) of a mode."""
    if mode == "lane":
        return (p, bt), (kc, bt), (p, kc)
    if mode == "sub":
        return (bt, p), (bt, kc), (p, kc)
    if mode == "rhs":
        return (kc, p), (bt, kc), (bt, p)
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def operands(mode: str, a: torch.Tensor, b: torch.Tensor):
    """The (left, right) matrices of a mode's product, as views."""
    if mode == "lane":
        return a, b.t()
    if mode == "sub":
        return a.t(), b
    if mode == "rhs":
        return b, a
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def macs(mode: str, a: torch.Tensor, b: torch.Tensor, steps: int, d: int) -> int:
    """Multiply-adds of one call: steps * d * M * N * K."""
    left, right = operands(mode, a, b)
    return steps * d * left.shape[0] * right.shape[1] * left.shape[1]


def _dims(mode: str, a: torch.Tensor, b: torch.Tensor):
    """(bt, p, kc) from the operands, checked against the mode's layout."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("a and b must be matrices")
    if mode == "lane":
        (p, bt), kc = a.shape, b.shape[0]
    elif mode == "sub":
        (bt, p), kc = a.shape, b.shape[1]
    else:
        (kc, p), bt = a.shape, b.shape[0]
    want_a, want_b, _ = operand_shapes(mode, bt, p, kc)
    if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
        raise ValueError(f"mode {mode}: a must be {want_a} and b {want_b}, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return bt, p, kc


def dot_probe_reference(a: torch.Tensor, b: torch.Tensor, mode: str, steps: int,
                        d: int) -> torch.Tensor:
    """Plain version: per step, the D products summed in f32; the last
    step's sum is returned."""
    left, right = operands(mode, a.float(), b.float())
    out = None
    for _ in range(steps):
        out = torch.zeros((left.shape[0], right.shape[1]), dtype=torch.float32,
                          device=a.device)
        for _ in range(d):
            out = out + left @ right
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.cffm_dot_orient_probe
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def dot_probe(a: torch.Tensor, b: torch.Tensor, mode: str, steps: int, d: int
              ) -> torch.Tensor:
    """out (f32) = the last step's sum of d products of the mode's operands
    (bf16). Kernel 9 on CUDA tensors; the contraction must be a multiple of
    16 there."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if steps < 1 or d < 1:
        raise ValueError(f"steps and d must be positive, got {steps} and {d}")
    bt, p, kc = _dims(mode, a, b)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"the probe takes bfloat16 operands, got {a.dtype} and {b.dtype}")
    kinds = {a.device.type, b.device.type}
    if kinds == {"cpu"}:
        return dot_probe_reference(a, b, mode, steps, d)
    if kinds != {"cuda"} or a.device != b.device:
        raise ValueError(f"the probe takes CPU or CUDA tensors on one device, got "
                         f"{a.device} and {b.device}")
    if (kc if mode == "rhs" else bt) % 16:
        raise ValueError("the kernel needs a contraction that is a multiple of 16")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(operand_shapes(mode, bt, p, kc)[2], dtype=torch.float32,
                      device=a.device)
    with torch.cuda.device(a.device):
        err = _library().cffm_dot_orient_probe(
            MODES.index(mode), a.data_ptr(), b.data_ptr(), out.data_ptr(), bt, p, kc,
            steps, d, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dot_orient_probe kernel launch failed: CUDA error {err}")
    dot_probe.launches += 1
    return out


dot_probe.launches = 0
