"""ctypes bindings for the repo's native C++ parser and hasher
(`native/cffm_native.cpp`).

The port's counterpart of `cffm_tpu/data/native.py`. The library is
built at first use with one g++ call and the flags of `native/Makefile`:

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared
        -o build/cffm_tpu_torch/native/libcffm_native-<hash>.so
        native/cffm_native.cpp

named by a hash of the source and the flags, so an edited source is
rebuilt and nothing is written under `native/`. The build runs under a
lock (a thread lock and a file lock, since several processes may build
at once) and writes a temporary file that is renamed into place.

Unlike the JAX package, a build that was attempted and failed raises
with the compiler's output: the readers do not fall back to Python then.
Only where no g++ exists at all does `available()` say False, and the
readers take their Python versions, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "cffm_native.cpp"
BUILD_DIR = _REPO / "build" / "cffm_tpu_torch" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_libs: dict = {}   # (source, build dir) -> loaded CDLL

_LONG_P = ctypes.POINTER(ctypes.c_long)
_I32_P = ctypes.POINTER(ctypes.c_int32)
_F32_P = ctypes.POINTER(ctypes.c_float)


def lib_path() -> pathlib.Path:
    """Where the library of the current source and flags lives."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcffm_native-{tag}.so"


def _build(out: pathlib.Path) -> None:
    """Compile SOURCE into out under a file lock; raise with g++'s output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed (exit {proc.returncode}):\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fnv_hash_batch.argtypes = [ctypes.c_char_p, _LONG_P, _LONG_P, ctypes.c_long,
                                   ctypes.c_long, _I32_P]
    lib.fnv_hash_batch.restype = None
    lib.parse_criteo.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, _LONG_P,
                                 _I32_P, _F32_P, _F32_P, _LONG_P]
    lib.parse_criteo.restype = ctypes.c_long
    lib.parse_avazu.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, _LONG_P,
                                _I32_P, _F32_P, _LONG_P]
    lib.parse_avazu.restype = ctypes.c_long
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None only when there is
    no library and no compiler to build one."""
    key = (SOURCE, BUILD_DIR)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = lib_path()
            if not path.exists():
                if shutil.which(CXX) is None:
                    return None
                _build(path)
            lib = _libs[key] = _declare(ctypes.CDLL(str(path)))
        return lib


def available() -> bool:
    """Whether the native parser can run here (building it if needed)."""
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native parser needs {CXX} to build {SOURCE.name}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _vocab(vocab_sizes, fields: int) -> np.ndarray:
    if len(vocab_sizes) != fields:
        raise ValueError(f"want {fields} vocab sizes, got {len(vocab_sizes)}")
    return np.asarray(vocab_sizes, dtype=np.int64)


def parse_criteo_buffer(buf: bytes, batch_cap: int, vocab_sizes, want_dense: bool = True
                        ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, int]:
    """Parse raw Criteo TSV bytes (newline-terminated rows; at most
    batch_cap of them). Returns (ids, dense | None, labels, consumed), ids
    local per field; malformed rows are skipped and an incomplete last row
    is left unconsumed."""
    lib = _lib()
    vocab = _vocab(vocab_sizes, 39)
    ids = np.empty((batch_cap, 39), dtype=np.int32)
    dense = np.empty((batch_cap, 13), dtype=np.float32) if want_dense else None
    labels = np.empty((batch_cap,), dtype=np.float32)
    consumed = ctypes.c_long(0)
    n = lib.parse_criteo(buf, len(buf), batch_cap, _ptr(vocab, ctypes.c_long),
                         _ptr(ids, ctypes.c_int32),
                         None if dense is None else _ptr(dense, ctypes.c_float),
                         _ptr(labels, ctypes.c_float), ctypes.byref(consumed))
    return ids[:n], None if dense is None else dense[:n], labels[:n], consumed.value


def parse_avazu_buffer(buf: bytes, batch_cap: int, vocab_sizes
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Parse raw Avazu CSV bytes (no header). Returns (ids, labels, consumed)."""
    lib = _lib()
    vocab = _vocab(vocab_sizes, 23)
    ids = np.empty((batch_cap, 23), dtype=np.int32)
    labels = np.empty((batch_cap,), dtype=np.float32)
    consumed = ctypes.c_long(0)
    n = lib.parse_avazu(buf, len(buf), batch_cap, _ptr(vocab, ctypes.c_long),
                        _ptr(ids, ctypes.c_int32), _ptr(labels, ctypes.c_float),
                        ctypes.byref(consumed))
    return ids[:n], labels[:n], consumed.value


def hash_strings_native(values: np.ndarray, num_buckets: int) -> np.ndarray:
    """Native FNV-1a over an array of byte-strings, bit-equal to
    hashing.hash_strings."""
    lib = _lib()
    if values.dtype.kind != "S":
        values = values.astype("S")
    w = values.dtype.itemsize
    raw = values.tobytes()
    n = len(values)
    starts = np.arange(n, dtype=np.int64) * w
    mat = np.frombuffer(raw, dtype=np.uint8).reshape(n, w)
    lengths = (mat != 0).cumprod(axis=1).sum(axis=1).astype(np.int64)
    ends = starts + lengths
    out = np.empty((n,), dtype=np.int32)
    lib.fnv_hash_batch(raw, _ptr(starts, ctypes.c_long), _ptr(ends, ctypes.c_long), n,
                       num_buckets, _ptr(out, ctypes.c_int32))
    return out
