"""The port's pre-hashed .cfb files are byte-equal to the JAX package's,
and its .cfb reader gives the JAX reader's batches: splits, shards,
per-epoch shuffles, repeat and one-pass tails, multi-file directories,
and the loader's detection of .cfb paths."""

import itertools
import os

import numpy as np
import pytest

import torch_data_files as files
from cffm_tpu.config import get_config as jax_get_config
from cffm_tpu.data.loader import make_dataset as jax_make_dataset
from cffm_tpu.data.prehash import convert as jax_convert
from cffm_tpu.data.prehashed import prehashed_batches as jax_prehashed_batches
from cffm_tpu_torch.config import get_config
from cffm_tpu_torch.data.loader import make_dataset
from cffm_tpu_torch.data.prehash import convert, main as prehash_main
from cffm_tpu_torch.data.prehashed import (is_prehashed, prehashed_batches, read_header,
                                           write_prehashed)
from cffm_tpu_torch.data.readers import criteo_batches
from cffm_tpu_torch.scripts.bench_input import _write_avazu, _write_criteo


@pytest.fixture(scope="module")
def criteo_cfb(tmp_path_factory):
    """A 4096-row Criteo TSV and its .cfb conversion by the port."""
    d = tmp_path_factory.mktemp("cfb")
    tsv, cfb = str(d / "criteo.tsv"), str(d / "criteo.cfb")
    _write_criteo(tsv, 4096)
    n = convert(tsv, cfb, get_config("criteo_kaggle").model, "criteo", chunk=512,
                reader_threads=1)
    return tsv, cfb, n


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("dataset", ["criteo", "avazu", "movielens"])
def test_cfb_bytes_equal_jax(tmp_path, dataset, threads):
    if dataset == "criteo":
        src, name = str(tmp_path / "c.tsv"), "criteo_kaggle"
        _write_criteo(src, 3000)
    elif dataset == "avazu":
        src, name = str(tmp_path / "a.csv"), "avazu"
        _write_avazu(src, 3000)
    else:
        src, name = str(tmp_path / "ml"), "movielens"
        os.mkdir(src)
        files.write_movielens(tmp_path / "ml")
    mine, theirs = str(tmp_path / "mine.cfb"), str(tmp_path / "theirs.cfb")
    chunk = 48 if dataset == "movielens" else 500  # movielens drops its partial batch
    n = convert(src, mine, get_config(name).model, dataset, chunk=chunk, reader_threads=threads)
    assert n == jax_convert(src, theirs, jax_get_config(name).model, dataset, chunk=chunk,
                            reader_threads=threads) > 0
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_prehash_cli_writes_the_same_bytes(criteo_cfb, tmp_path, capsys):
    tsv, cfb, n = criteo_cfb
    out = str(tmp_path / "cli.cfb")
    assert prehash_main([tsv, out, "--config=criteo_kaggle", "--chunk=512",
                         "--threads=1"]) == 0
    assert f"wrote {n} rows" in capsys.readouterr().out
    with open(out, "rb") as a, open(cfb, "rb") as b:
        assert a.read() == b.read()


def test_header_and_magic(criteo_cfb):
    tsv, cfb, n = criteo_cfb
    cfg = get_config("criteo_kaggle").model
    assert read_header(cfb) == (cfg.num_fields, cfg.num_dense, n) and n == 4096
    assert is_prehashed(cfb) and not is_prehashed(tsv)
    assert not is_prehashed(cfb + ".missing")
    with pytest.raises(ValueError, match="not a CFB file"):
        read_header(tsv)


def test_roundtrip_bit_equal_to_tsv_reader(criteo_cfb):
    tsv, cfb, _ = criteo_cfb
    cfg = get_config("criteo_kaggle").model
    files.assert_streams_equal(criteo_batches(tsv, cfg, 256, repeat=False),
                               prehashed_batches(cfb, cfg, 256, repeat=False), min_batches=16)


@pytest.mark.parametrize("repeat", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("shard", range(3))
@pytest.mark.parametrize("split", ["train", "val"])
def test_prehashed_batches_bit_equal_jax(criteo_cfb, split, shard, shuffle, repeat):
    _, cfb, _ = criteo_cfb
    kw = dict(repeat=repeat, split=split, val_every=3, shuffle=shuffle, seed=7)
    want = jax_prehashed_batches(cfb, jax_get_config("criteo_kaggle").model, 300, shard, 3,
                                 **kw)
    got = prehashed_batches(cfb, get_config("criteo_kaggle").model, 300, shard, 3, **kw)
    n = 12 if repeat else None  # past the end of the first epoch
    files.assert_streams_equal(itertools.islice(want, n), itertools.islice(got, n))


def test_shuffle_covers_every_row_and_changes_per_epoch(criteo_cfb):
    _, cfb, n = criteo_cfb
    cfg = get_config("criteo_kaggle").model
    two = list(itertools.islice(prehashed_batches(cfb, cfg, 256, shuffle=True, seed=7),
                                2 * (n // 256)))
    plain = list(prehashed_batches(cfb, cfg, 256, repeat=False))

    def rowset(batches):
        return sorted(tuple(r) for ids, _, _ in batches for r in ids)

    e1, e2 = two[: n // 256], two[n // 256:]
    assert rowset(e1) == rowset(e2) == rowset(plain)
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(e1, plain))
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(e1, e2))


@pytest.mark.parametrize("repeat", [False, True])
def test_multifile_cfb_directory_bit_equal_jax(tmp_path, repeat):
    """A directory of .cfb day files (tails of 44, 1 and 0 rows at
    batches of 128): one block sequence across files, each file's tail a
    partial batch in a one-pass read and dropped when repeating."""
    cfg = get_config("criteo_kaggle").model
    d = tmp_path / "shards"
    d.mkdir()
    for i, n in enumerate([300, 257, 128]):
        tsv = str(tmp_path / f"s{i}.tsv")
        _write_criteo(tsv, n)
        convert(tsv, str(d / f"day_{i}.cfb"), cfg, "criteo", chunk=64, reader_threads=1)
    assert is_prehashed(str(d))
    kw = dict(repeat=repeat, split="val", val_every=2)
    want = jax_prehashed_batches(str(d), jax_get_config("criteo_kaggle").model, 128, **kw)
    got = prehashed_batches(str(d), cfg, 128, **kw)
    n = 6 if repeat else None
    files.assert_streams_equal(itertools.islice(want, n), itertools.islice(got, n),
                               min_batches=2)
    full = list(prehashed_batches(str(d), cfg, 128, repeat=False))
    assert sorted(len(ids) for ids, _, _ in full) == [1, 44] + [128] * 5


def test_write_prehashed_no_dense(tmp_path):
    ids = np.arange(12, dtype=np.int32).reshape(6, 2)
    lab = np.array([0, 1, 0, 1, 1, 0], np.float32)
    p = str(tmp_path / "x.cfb")
    assert write_prehashed(p, [(ids, None, lab)], 2, 0) == 6
    from cffm_tpu_torch.config import ModelConfig

    cfg = ModelConfig(num_fields=2, vocab_sizes=(16, 16), num_dense=0)
    (gi, gd, gl), = list(prehashed_batches(p, cfg, 6, repeat=False))
    np.testing.assert_array_equal(gi, ids)
    assert gd is None
    np.testing.assert_array_equal(gl, lab)
    with pytest.raises(ValueError, match="2 fields"):
        next(prehashed_batches(p, get_config("criteo_kaggle").model, 6))


@pytest.mark.parametrize("dataset", ["criteo", "prehashed"])
def test_loader_detects_cfb_bit_equal_jax(criteo_cfb, dataset):
    """make_dataset takes a .cfb path for any dataset name but movielens:
    offsets applied, the train stream shuffled, skip_batches exact."""
    _, cfb, _ = criteo_cfb
    jcfg, cfg = files.cfg_pair("criteo_kaggle", path=cfb, dataset=dataset, batch_size=256,
                               val_every=4, shuffle=True, seed=2)
    for split in ("train", "val"):
        want = jax_make_dataset(jcfg, prefetch=0, split=split, skip_batches=1)
        got = make_dataset(cfg, prefetch=2, split=split, skip_batches=1)
        files.assert_streams_equal(itertools.islice(want, 20), itertools.islice(got, 20), 20)
    b = next(make_dataset(cfg, prefetch=0))
    assert b.ids.dtype == np.int32 and b.dense.dtype == np.float32
    assert b.ids[:, 1].min() >= cfg.model.vocab_sizes[0]  # field offsets applied
