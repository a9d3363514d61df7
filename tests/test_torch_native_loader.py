"""The port's native parser: built from the repo's own source into
build/cffm_tpu_torch/native, bit-equal to the JAX package's parser and
hasher, raising with the compiler's output when a build fails, and left
for the Python readers only where no compiler exists."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import torch_data_files as files
from cffm_tpu.data import native as jax_native
from cffm_tpu.data.hashing import bucketize_log2, hash_strings
from cffm_tpu.data.loader import make_dataset as jax_make_dataset
from cffm_tpu.data.readers import day_of_week_yymmdd
from cffm_tpu_torch.config import get_config
from cffm_tpu_torch.data import native, readers
from cffm_tpu_torch.data.loader import make_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _criteo_lines(n, rng):
    lines = []
    for _ in range(n):
        label = rng.integers(0, 2)
        ints = [("" if rng.random() < 0.2 else str(rng.integers(-1, 10000))) for _ in range(13)]
        cats = [("" if rng.random() < 0.1 else f"{rng.integers(0, 2**32):08x}")
                for _ in range(26)]
        lines.append("\t".join([str(label)] + ints + cats))
    return ("\n".join(lines) + "\n").encode()


def test_library_is_built_into_the_port_tree():
    assert native.available()
    path = native.lib_path()
    assert path.exists() and path.parent == ROOT / "build" / "cffm_tpu_torch" / "native"
    assert not list(path.parent.glob("*.tmp"))


@pytest.mark.parametrize("want_dense", [True, False])
def test_parse_criteo_bit_equal_jax_and_python(want_dense):
    vocab = get_config("criteo_kaggle").model.vocab_sizes
    buf = _criteo_lines(200, np.random.default_rng(1))
    ids, dense, labels, consumed = native.parse_criteo_buffer(buf, 200, vocab, want_dense)
    j_ids, j_dense, j_labels, j_consumed = jax_native.parse_criteo_buffer(
        buf, 200, vocab, want_dense)
    assert consumed == j_consumed == len(buf) and ids.shape == (200, 39)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(labels, j_labels)
    if want_dense:
        np.testing.assert_array_equal(dense, j_dense)
    else:
        assert dense is None and j_dense is None
    # the Python hashing on the same rows
    rows = [ln.split(b"\t") for ln in buf.rstrip(b"\n").split(b"\n")]
    ints = np.array([[int(x) if x else -1 for x in r[1:14]] for r in rows], np.int64)
    for f in range(13):
        np.testing.assert_array_equal(ids[:, f], bucketize_log2(ints[:, f], vocab[f]))
    for f in range(26):
        col = np.array([r[14 + f] for r in rows], dtype="S16")
        np.testing.assert_array_equal(ids[:, 13 + f], hash_strings(col, vocab[13 + f]))


def test_parse_criteo_partial_row():
    vocab = get_config("criteo_kaggle").model.vocab_sizes
    truncated = _criteo_lines(10, np.random.default_rng(2))[:-5]
    ids, dense, labels, consumed = native.parse_criteo_buffer(truncated, 10, vocab)
    assert len(ids) == len(dense) == len(labels) == 9  # the incomplete row is left
    assert consumed < len(truncated)
    assert consumed == jax_native.parse_criteo_buffer(truncated, 10, vocab)[3]


def test_parse_avazu_bit_equal_jax_and_python():
    vocab = get_config("avazu").model.vocab_sizes
    rng = np.random.default_rng(3)
    lines = [",".join([f"{rng.integers(0, 2**40):x}", str(rng.integers(0, 2)),
                       f"1410{rng.integers(21, 31):02d}{rng.integers(0, 24):02d}"]
                      + [f"{rng.integers(0, 2**24):06x}" for _ in range(21)])
             for _ in range(100)]
    buf = ("\n".join(lines) + "\n").encode()
    ids, labels, consumed = native.parse_avazu_buffer(buf, 100, vocab)
    j_ids, j_labels, j_consumed = jax_native.parse_avazu_buffer(buf, 100, vocab)
    assert consumed == j_consumed == len(buf)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(labels, j_labels)
    rows = [ln.split(b",") for ln in buf.rstrip(b"\n").split(b"\n")]
    np.testing.assert_array_equal(ids[:, 1], day_of_week_yymmdd(
        np.array([int(r[2][:6]) for r in rows])))
    for f in range(21):
        col = np.array([r[3 + f] for r in rows], dtype="S24")
        np.testing.assert_array_equal(ids[:, 2 + f], hash_strings(col, vocab[2 + f]))


def test_parsers_refuse_a_wrong_vocab_count():
    with pytest.raises(ValueError, match="39 vocab sizes"):
        native.parse_criteo_buffer(b"", 1, (10,) * 23)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A build that was attempted and failed raises; it does not hand the
    stream to the Python readers."""
    broken = tmp_path / "broken.cpp"
    broken.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.available()
    assert not list((tmp_path / "build").glob("*.so")) + list((tmp_path / "build").glob("*.tmp"))


def test_no_compiler_takes_the_python_readers(tmp_path, monkeypatch):
    """Only where no library exists and no g++ can build one does the
    stream fall to the Python readers, bit-equal to JAX's Python route."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    assert not native.available()
    assert readers.reader_route(4) == "python"
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.parse_avazu_buffer(b"", 1, (10,) * 23)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    p = tmp_path / "messy.tsv"
    files.write_criteo_messy(str(p))
    jcfg, cfg = files.cfg_pair("criteo_kaggle", path=str(p), dataset="criteo",
                               batch_size=64, val_every=3)
    files.assert_streams_equal(jax_make_dataset(jcfg, prefetch=0, repeat=False),
                               make_dataset(cfg, prefetch=0, repeat=False), min_batches=2)


def test_concurrent_builds_make_one_library(tmp_path):
    """Several processes building at once (as test workers do) leave one
    library, no temporary file, and each loads it."""
    code = "\n".join([
        "import pathlib, sys",
        "from cffm_tpu_torch.data import native",
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])",
        "assert native.available()",
        "print(native.lib_path())",
    ])
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONPATH=str(ROOT)))
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    assert len({out.strip() for out, _ in outs}) == 1
    assert [p.name for p in tmp_path.glob("*.so")] == [pathlib.Path(outs[0][0].strip()).name]
    assert not list(tmp_path.glob("*.tmp"))



def test_first_loads_from_many_threads_all_see_the_library(tmp_path, monkeypatch):
    """The first load from several threads at once (the parse workers of
    the multi-threaded reader) builds once and every thread gets the
    library; none sees it as unavailable."""
    import threading

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    seen, barrier = [], threading.Barrier(8)

    def first_use():
        barrier.wait()
        seen.append(native.available())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads)
    assert seen == [True] * 8
    assert len(list(tmp_path.glob("*.so"))) == 1
