"""Host-to-device copies on the card: their rate, and whether they overlap
compute.

    python -m cffm_tpu_torch.scripts.probe_h2d

The port's counterpart of `scripts/probe_h2d.py`, at its batch: B = 49152,
ids (B, 26) int32, dense (B, 13) f32, labels (B,) f32 (7,864,320 bytes).
Host clock around work that ends in a synchronize; no round-trip
correction is made (`utils/timing` says why). It prints:

  1. copy and synchronize of the three arrays, three times from pageable
     memory and three times from pinned memory (ms and MB/s);
  2. how long four `non_blocking` copies of the pinned ids hold the
     caller, and how long the synchronize after them waits;
  3. eight `tanh(x @ x) * 1e-4` on an 8192 x 8192 bf16 tensor alone, the
     pinned ids and dense copied alone, and the burn with those copies
     issued on a side stream while it runs: the copies overlap the burn
     when the two together take about the burn's time;
  4. one packed copy (the three arrays' bytes side by side, pinned)
     against the three copies from pinned memory;

then the card. It needs a CUDA card and exits nonzero without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

BATCH = 49152


def host_batch(b: int = BATCH) -> dict:
    """The JAX probe's arrays: ids (b, 26) int32, dense (b, 13) f32, labels (b,)."""
    return {"ids": np.random.default_rng(0).integers(0, 2**31 - 1, size=(b, 26)
                                                     ).astype(np.int32),
            "dense": np.random.default_rng(1).normal(size=(b, 13)).astype(np.float32),
            "labels": np.zeros((b,), np.float32)}


def packed(arrays: dict) -> np.ndarray:
    """The arrays' bytes side by side, one row per example."""
    b = arrays["labels"].shape[0]
    return np.concatenate([a.view(np.uint8).reshape(b, -1) for a in arrays.values()], axis=1)


def _ms(fn) -> float:
    """Host ms of fn() through a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def run(device="cuda", log=print) -> dict:
    """The four probes; returns their ms by name."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"probe_h2d measures copies to a CUDA card, not {device}")
    arrays = host_batch()
    pageable = {k: torch.from_numpy(a) for k, a in arrays.items()}
    pinned = {k: t.pin_memory() for k, t in pageable.items()}
    nbytes = sum(a.nbytes for a in arrays.values())
    log(f"batch bytes: {nbytes} ({nbytes / 1e6:.3f} MB)", flush=True)
    out = {}

    def copy_all(src, non_blocking):
        return [t.to(device, non_blocking=non_blocking) for t in src.values()]

    for name, src, nb in (("pageable", pageable, False), ("pinned", pinned, True)):
        copy_all(src, nb)  # warm
        out[f"h2d_{name}_ms"] = ms = [_ms(lambda: copy_all(src, nb)) for _ in range(3)]
        log(f"h2d {name} copy+sync: " + ", ".join(
            f"{t:.4f} ms ({nbytes / t / 1e3:.0f} MB/s)" for t in ms), flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    copies = [pinned["ids"].to(device, non_blocking=True) for _ in range(4)]
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out["dispatch4_ms"], out["drain4_ms"] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    log(f"4x non_blocking copy: the caller held {out['dispatch4_ms']:.4f} ms, the "
        f"synchronize after them {out['drain4_ms']:.4f} ms", flush=True)
    del copies

    x = torch.ones((8192, 8192), dtype=torch.bfloat16, device=device)

    def burn():
        y = x
        for _ in range(8):
            y = torch.tanh(y @ y) * 1e-4
        return y

    side = torch.cuda.Stream(device)

    def side_copies():
        with torch.cuda.stream(side):
            return [pinned[k].to(device, non_blocking=True) for k in ("ids", "dense")]

    burn()
    side_copies()
    out["burn_ms"] = _ms(burn)
    out["copies_alone_ms"] = _ms(side_copies)

    def both():
        burn()
        side_copies()

    out["burn_and_copies_ms"] = _ms(both)
    log(f"burn alone: {out['burn_ms']:.4f} ms; ids+dense copies alone on the side stream: "
        f"{out['copies_alone_ms']:.4f} ms; burn with the copies issued on the side stream "
        f"while it runs: {out['burn_and_copies_ms']:.4f} ms (overlap if ~= burn alone)",
        flush=True)

    one = torch.from_numpy(packed(arrays)).pin_memory()
    one.to(device, non_blocking=True)
    out["packed_ms"] = _ms(lambda: one.to(device, non_blocking=True))
    out["three_ms"] = _ms(lambda: copy_all(pinned, True))
    log(f"one packed copy: {out['packed_ms']:.4f} ms ({one.numel() / out['packed_ms'] / 1e3:.0f}"
        f" MB/s); three copies: {out['three_ms']:.4f} ms", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_h2d: no CUDA device", file=sys.stderr)
        return 1
    from cffm_tpu_torch.bench import card_line

    run("cuda")
    print(f"card: {card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
