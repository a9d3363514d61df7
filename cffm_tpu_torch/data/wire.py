"""Packed host-to-device wire format for training batches.

The port's counterpart of `cffm_tpu/data/wire.py`: `pack` is the same
numpy code and gives the same bytes; `unpack` runs as tensor ops on the
batch's device. The raw feed ships (B, F) int32 ids, f32 dense and f32
labels (212 bytes a row on criteo_kaggle); this format ships 96:

  - fields with vocab <= 256        -> one uint8 column each
  - fields with vocab <= 65536      -> one uint16 column each
  - bigger fields                   -> uint16 low half + their high
    bits (ceil(log2(vocab)) - 16 per field) bit-packed little-endian
    into shared uint32 words
  - dense                           -> float16 (the range after Criteo's
    log transform is small; f16's 10-bit mantissa beats bf16's 7)
  - labels                          -> uint8 (0/1)

ids and labels are bit-exact through the wire; dense rounds to float16.

torch has no shifts for its unsigned 16- and 32-bit types, and CUDA's
coverage of them is thin. So the unsigned columns travel as signed views
of the same bits (`host_tensor`), and `unpack` widens them to int32 and
masks: a uint16 column is sign-extended and then masked to 16 bits, and
a hi word is shifted arithmetically and masked to the field's own bits
after the shift, so no sign bit leaks into a field.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Static wire layout derived from the model config."""

    vocab_sizes: Tuple[int, ...]
    num_dense: int
    u8_fields: Tuple[int, ...]      # field indices, vocab <= 2**8
    u16_fields: Tuple[int, ...]     # field indices, 2**8 < vocab <= 2**16
    big_fields: Tuple[int, ...]     # field indices, vocab > 2**16
    big_hi_bits: Tuple[int, ...]    # per big field: bits above the low 16
    big_hi_offset: Tuple[int, ...]  # per big field: LSB offset in the
    # concatenated hi bitstream (word = offset // 32, shift = offset % 32;
    # a field's hi bits never straddle a word boundary, see from_vocabs)
    hi_words: int                   # number of uint32 hi words per row

    @property
    def num_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def has_dense(self) -> bool:
        return self.num_dense > 0

    def bytes_per_row(self) -> int:
        return (len(self.u8_fields) + 2 * len(self.u16_fields)
                + 2 * len(self.big_fields) + 4 * self.hi_words + 1
                + 2 * self.num_dense)


def from_vocabs(vocab_sizes, num_dense: int = 0) -> WireSpec:
    u8, u16, big, hi_bits, hi_off = [], [], [], [], []
    off = 0
    for f, v in enumerate(vocab_sizes):
        if v <= 1 << 8:
            u8.append(f)
        elif v <= 1 << 16:
            u16.append(f)
        else:
            b = max(1, math.ceil(math.log2(v)) - 16)
            # 15, not 16: ids are int32 downstream, so a vocab must stay
            # <= 2^31; at 16 hi bits (h << 16) | lo would wrap negative
            if b > 15:
                raise ValueError(f"field {f} vocab {v} too large for the wire format")
            # keep each field's hi bits inside one uint32 word, so that its
            # unpack is one shift and one mask (pad to the next word if a
            # straddle would occur)
            if off // 32 != (off + b - 1) // 32:
                off = ((off // 32) + 1) * 32
            big.append(f)
            hi_bits.append(b)
            hi_off.append(off)
            off += b
    return WireSpec(
        vocab_sizes=tuple(int(v) for v in vocab_sizes),
        num_dense=int(num_dense),
        u8_fields=tuple(u8), u16_fields=tuple(u16), big_fields=tuple(big),
        big_hi_bits=tuple(hi_bits), big_hi_offset=tuple(hi_off),
        hi_words=(off + 31) // 32,
    )


def spec_for_model(mcfg) -> WireSpec:
    return from_vocabs(mcfg.vocab_sizes, num_dense=mcfg.num_dense)


def _columns(ids: np.ndarray, fields: Tuple[int, ...]) -> np.ndarray:
    """ids[:, fields], as a slice when the fields are a run (Criteo's are):
    the same values, without the gather of an index array."""
    lo = fields[0]
    if fields == tuple(range(lo, lo + len(fields))):
        return ids[:, lo:lo + len(fields)]
    return ids[:, fields]


def pack(ids_local: np.ndarray, dense: Optional[np.ndarray],
         labels: np.ndarray, spec: WireSpec) -> dict:
    """Host side: LOCAL (per-field) ids (B, F) -> wire dict of numpy arrays
    (keys u8, u16, big_lo, hi, dense, labels as the spec has them)."""
    ids_local = np.asarray(ids_local)
    b = ids_local.shape[0]
    out = {}
    if spec.u8_fields:
        out["u8"] = _columns(ids_local, spec.u8_fields).astype(np.uint8)
    if spec.u16_fields:
        out["u16"] = _columns(ids_local, spec.u16_fields).astype(np.uint16)
    if spec.big_fields:
        bigs = _columns(ids_local, spec.big_fields).astype(np.uint32)
        out["big_lo"] = (bigs & 0xFFFF).astype(np.uint16)
        hi = np.zeros((b, spec.hi_words), np.uint32)
        for i in range(len(spec.big_fields)):
            word = spec.big_hi_offset[i] // 32
            shift = spec.big_hi_offset[i] % 32
            # mask to the field's own hi width: an out-of-range id (a .cfb
            # written with a larger-vocab config) must not OR stray bits
            # into its neighbours' words
            mask = np.uint32((1 << spec.big_hi_bits[i]) - 1)
            hi[:, word] |= ((bigs[:, i] >> 16) & mask) << np.uint32(shift)
        out["hi"] = hi
    if spec.has_dense and dense is not None:
        out["dense"] = np.asarray(dense).astype(np.float16)
    labels = np.asarray(labels)
    # uint8 would floor soft labels silently: the wire carries binary only
    if labels.size and not ((labels == 0) | (labels == 1)).all():
        raise ValueError("the packed wire format carries binary labels only")
    out["labels"] = labels.astype(np.uint8)
    return out


_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of a host array; unsigned 16-, 32- and 64-bit arrays
    become signed views of the same bits (uint8 stays uint8)."""
    a = np.ascontiguousarray(a)
    signed = _SIGNED.get(a.dtype)
    return torch.from_numpy(a if signed is None else a.view(signed))


def _signed(t: torch.Tensor) -> torch.Tensor:
    """t as its signed type of the same width (a view of the same bits)."""
    for u, s in ((torch.uint16, torch.int16), (torch.uint32, torch.int32)):
        if t.dtype == u:
            return t.view(s)
    return t


@functools.lru_cache(maxsize=16)
def _layout(spec: WireSpec, device: torch.device) -> dict:
    """The spec's field indices, hi words, shifts and masks as int64/int32
    tensors on device, made once per (spec, device)."""
    def t(values, dtype=torch.int64):
        return torch.tensor(values, dtype=dtype, device=device)

    return {"u8": t(spec.u8_fields), "u16": t(spec.u16_fields), "big": t(spec.big_fields),
            "word": t([o // 32 for o in spec.big_hi_offset]),
            "shift": t([o % 32 for o in spec.big_hi_offset], torch.int32),
            "mask": t([(1 << b) - 1 for b in spec.big_hi_bits], torch.int32)}


def unpack(wire: dict, spec: WireSpec):
    """Device side: wire dict of tensors (or numpy arrays) -> (ids_local
    int32 (B, F), dense f32 | None, labels f32), on the wire's device.
    Field order is restored exactly. Each column class is one set of
    whole-array ops, whatever the number of fields."""
    wire = {k: host_tensor(v) if isinstance(v, np.ndarray) else v for k, v in wire.items()}
    labels = wire["labels"]
    lay = _layout(spec, labels.device)
    ids = torch.empty((labels.shape[0], spec.num_fields), dtype=torch.int32,
                      device=labels.device)
    if spec.u8_fields:
        ids.index_copy_(1, lay["u8"], wire["u8"].to(torch.int32))
    if spec.u16_fields:
        ids.index_copy_(1, lay["u16"], _signed(wire["u16"]).to(torch.int32) & 0xFFFF)
    if spec.big_fields:
        lo = _signed(wire["big_lo"]).to(torch.int32) & 0xFFFF
        hi = _signed(wire["hi"]).to(torch.int32)
        # shift each field's word arithmetically, then mask to its own bits
        h = (hi.index_select(1, lay["word"]) >> lay["shift"]) & lay["mask"]
        ids.index_copy_(1, lay["big"], (h << 16) | lo)
    dense = None
    if spec.has_dense and "dense" in wire:
        dense = wire["dense"].to(torch.float32)
    return ids, dense, labels.to(torch.float32)
