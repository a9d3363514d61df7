"""Probe of the tensor cores' operand orientations (kernel 9).

The port's counterpart of the Pallas kernel in `scripts/probe_dot_orient.py`.
Per step the kernel sums D bf16 products into f32 and writes the last
step's sum: out = sum over D of L . R, with the operands in the script's
layouts, each read by wgmma from shared memory in its stored orientation
(`csrc/dot_orient_probe.cu`):

  lane  a (P, BT), b (KC, BT) -> a @ b.T   (P, KC)   L K-major, R K-major
  sub   a (BT, P), b (BT, KC) -> a.T @ b   (P, KC)   L MN-major, R MN-major
  rhs   a (KC, P), b (BT, KC) -> b @ a     (BT, P)   L K-major, R MN-major

The kernel's grid is (m64 x N output tile, range of steps): `schedule`
is the library's rule in plain Python, so that a CPU test sees it.

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
# the kernel's output tiles: 64 rows by a mode's N-tile width
TILE_M = 64
TILE_N = {"lane": 192, "sub": 192, "rhs": 248}
BLOCKS_PER_SM = 2                  # blocks per SM the step split aims at
SMEM_MAX = 232448                  # shared memory a block may use on the H100


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


def gemm_dims(mode: str, bt: int, p: int, kc: int):
    """(M, N, K) of a mode's product."""
    return (bt, p, kc) if mode == "rhs" else (p, kc, bt)


def schedule(mode: str, bt: int, p: int, kc: int, steps: int, sms: int) -> dict:
    """The kernel's launch at these shapes on a card of `sms` SMs (the
    library's probe_grid): the N-tile width, m- and n-tiles, the number of
    step splits (about BLOCKS_PER_SM blocks per SM, at most one step
    each), each split's step range [s*steps//splits, (s+1)*steps//splits),
    and the dynamic shared memory of one block (its L and R tiles)."""
    m, n, k = gemm_dims(mode, bt, p, kc)
    nw = TILE_N[mode]
    mtiles, ntiles = -(-m // TILE_M), -(-n // nw)
    splits = max(1, min(steps, -(-(BLOCKS_PER_SM * sms) // (mtiles * ntiles))))
    ranges = [(s * steps // splits, (s + 1) * steps // splits) for s in range(splits)]
    return {"nw": nw, "mtiles": mtiles, "ntiles": ntiles, "splits": splits,
            "ranges": ranges, "smem": (TILE_M + nw) * k * 2}


def writer(ranges, steps: int):
    """(split, warpgroup) that writes a tile: the split that owns step
    steps-1, and of its two warpgroups (alternate steps of its range) the
    one that takes that step."""
    for s, (lo, hi) in enumerate(ranges):
        if lo <= steps - 1 < hi:
            return s, (steps - 1 - lo) % 2
    raise ValueError("no split owns the last step")


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
        lib.cffm_dot_orient_probe_grid.argtypes = [i, i, i, i, i, i, p]
        lib.cffm_dot_orient_probe_grid.restype = ctypes.c_longlong
    return lib


def library_schedule(mode: str, bt: int, p: int, kc: int, steps: int, sms: int):
    """The library's (N-tile width, m-tiles, n-tiles, splits) and shared
    memory at these shapes, for holding `schedule` against it."""
    grid = (ctypes.c_int * 4)()
    smem = _library().cffm_dot_orient_probe_grid(MODES.index(mode), bt, p, kc, steps, sms,
                                                 grid)
    return tuple(grid), smem


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
    if schedule(mode, bt, p, kc, steps, 1)["smem"] > SMEM_MAX:
        raise ValueError(f"mode {mode}: the contraction is too deep for one block's "
                         f"shared memory")
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
