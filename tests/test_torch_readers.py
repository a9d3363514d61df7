"""The port's file streams are the JAX package's, batch for batch.

Criteo TSV and Avazu CSV files, written from a seed, go through
`cffm_tpu.data.loader.make_dataset` and `cffm_tpu_torch.data.loader.
make_dataset` on each reader route (Python, native, native multi-threaded),
for the train and val splits of shards 0..2 of 3, with shuffle and
negative downsampling, through .gz files, globs and directories of day
files, and on MovieLens directories. Every batch is bit-equal, dtypes
included. The route is forced as the JAX loader picks it: the Python
readers where the native parser is unavailable, the native reader for
reader_threads=1, the multi-threaded one above.
"""

import gzip
import itertools

import numpy as np
import pytest

import torch_data_files as files
from cffm_tpu.data import native as jax_native
from cffm_tpu.data import readers as jax_readers
from cffm_tpu.data.loader import make_dataset as jax_make_dataset
from cffm_tpu_torch.config import get_config
from cffm_tpu_torch.data import native, readers
from cffm_tpu_torch.data.loader import make_dataset
from cffm_tpu_torch.scripts.bench_input import _write_avazu, _write_criteo

ROUTES = {"python": 4, "native": 1, "native_mt": 4}     # route -> reader_threads
CONFIGS = {"criteo": "criteo_kaggle", "avazu": "avazu"}


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    """A 40,000-row Criteo TSV and an 80,000-row Avazu CSV: about 12 MB
    each, so the multi-threaded route's 1 MB chunks make a dozen chunks."""
    d = tmp_path_factory.mktemp("files")
    out = {"criteo": str(d / "criteo.tsv"), "avazu": str(d / "avazu.csv")}
    _write_criteo(out["criteo"], 40_000)
    _write_avazu(out["avazu"], 80_000)
    return out


def _route(monkeypatch, route: str) -> int:
    if route == "python":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    else:
        assert native.available() and jax_native.available()
    assert readers.reader_route(ROUTES[route]) == route
    return ROUTES[route]


def _both(jcfg, cfg, shard=0, shards=1, **kw):
    return (jax_make_dataset(jcfg, shard, shards, prefetch=0, **kw),
            make_dataset(cfg, shard, shards, prefetch=2, **kw))


@pytest.mark.parametrize("shard", range(3))
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("dataset", sorted(CONFIGS))
def test_file_stream_bit_equal_jax(data_files, monkeypatch, dataset, route, split, shard):
    """One pass (repeat=False, partial tail included) of one shard's split."""
    threads = _route(monkeypatch, route)
    jcfg, cfg = files.cfg_pair(CONFIGS[dataset], path=data_files[dataset], dataset=dataset,
                               batch_size=3 * 4096, val_every=3, reader_threads=threads)
    want, got = _both(jcfg, cfg, shard, 3, split=split, repeat=False)
    files.assert_streams_equal(want, got, min_batches=1)


@pytest.mark.parametrize("option", ["shuffle", "downsample", "both"])
@pytest.mark.parametrize("dataset", sorted(CONFIGS))
def test_train_stream_options_bit_equal_jax(data_files, dataset, option):
    """The repeat-mode train stream with the shuffle buffer and negative
    downsampling, past the end of the first epoch, and skip_batches."""
    data = dict(path=data_files[dataset], dataset=dataset, batch_size=4096, val_every=5)
    if option in ("shuffle", "both"):
        data.update(shuffle=True, shuffle_buffer=10_000, seed=3)
    if option in ("downsample", "both"):
        data.update(neg_downsample=0.4)
    jcfg, cfg = files.cfg_pair(CONFIGS[dataset], **data)
    want, got = _both(jcfg, cfg, skip_batches=2)
    files.assert_streams_equal(itertools.islice(want, 14), itertools.islice(got, 14), 14)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_gzip_glob_and_directory_bit_equal_jax(tmp_path, monkeypatch, route):
    """A .gz file, a glob over day files and a directory of day files read
    as the JAX package reads them, and the directory as the whole file."""
    threads = _route(monkeypatch, route)
    whole = tmp_path / "all.tsv"
    _write_criteo(str(whole), 600)
    text = whole.read_bytes().splitlines(keepends=True)
    days = tmp_path / "days"
    days.mkdir()
    for i, (lo, hi) in enumerate([(0, 250), (250, 400), (400, 600)]):
        with gzip.open(days / f"day_{i}.tsv.gz", "wb") as f:
            f.write(b"".join(text[lo:hi]))
    assert readers.resolve_paths(str(days / "day_*.gz")) == [
        str(days / f"day_{i}.tsv.gz") for i in range(3)]
    streams = {}
    for name, path in (("file", whole), ("glob", days / "day_*.gz"), ("dir", days)):
        jcfg, cfg = files.cfg_pair("criteo_kaggle", path=str(path), dataset="criteo",
                                   batch_size=128, val_every=0, reader_threads=threads)
        want, got = _both(jcfg, cfg, repeat=False)
        streams[name] = list(got)
        files.assert_streams_equal(want, streams[name], min_batches=4)
    files.assert_streams_equal(streams["file"], streams["dir"])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_messy_rows_and_no_trailing_newline_bit_equal_jax(tmp_path, monkeypatch, route):
    """Malformed rows are skipped, empty fields hashed, and a last row
    without its newline kept, on every route as in JAX."""
    threads = _route(monkeypatch, route)
    p = tmp_path / "messy.tsv"
    files.write_criteo_messy(str(p))
    p.write_bytes(p.read_bytes().rstrip(b"\n"))
    jcfg, cfg = files.cfg_pair("criteo_kaggle", path=str(p), dataset="criteo",
                               batch_size=128, val_every=0, reader_threads=threads)
    want, got = _both(jcfg, cfg, repeat=False)
    got = list(got)
    files.assert_streams_equal(want, got)
    assert sum(len(b["labels"]) for b in got) == 300


@pytest.mark.parametrize("repeat", [False, True])
@pytest.mark.parametrize("split", ["train", "val"])
def test_movielens_bit_equal_jax(tmp_path, split, repeat):
    files.write_movielens(tmp_path)
    model = dict(vocab_sizes=(64, 64, 2, 8, 22, 64, 19))
    jcfg, cfg = files.cfg_pair("movielens", model=model, path=str(tmp_path),
                               dataset="movielens", batch_size=20, val_every=10, seed=5)
    want, got = _both(jcfg, cfg, split=split, repeat=repeat)
    n = 30 if repeat else None
    files.assert_streams_equal(itertools.islice(want, n), itertools.islice(got, n),
                               min_batches=2)


def test_readers_equal_jax_readers_at_their_own_chunks(data_files):
    """The readers themselves (no loader) at another batch size, against
    JAX's, on both native routes and the Python one."""
    cfg = get_config("criteo_kaggle").model
    from cffm_tpu.config import get_config as jax_get_config

    jcfg = jax_get_config("criteo_kaggle").model
    for name in ("criteo_batches", "criteo_batches_native", "criteo_batches_native_mt"):
        kw = dict(repeat=False, split="val", val_every=4)
        want = getattr(jax_readers, name)(data_files["criteo"], jcfg, 1000, **kw)
        got = getattr(readers, name)(data_files["criteo"], cfg, 1000, **kw)
        files.assert_streams_equal(want, got, min_batches=2)


def test_day_of_week_real_calendar():
    """Known dates (0 = Sunday) across month, year and leap-day boundaries."""
    dates = np.array([141021, 141031, 141101, 141231, 150101, 160229, 160301])
    got = readers.day_of_week_yymmdd(dates)
    np.testing.assert_array_equal(got, [2, 5, 6, 3, 4, 1, 2])
    np.testing.assert_array_equal(got, jax_readers.day_of_week_yymmdd(dates))


def test_readers_refuse_a_config_of_another_shape(data_files):
    with pytest.raises(ValueError, match="39 fields"):
        readers.criteo_batches(data_files["criteo"], get_config("avazu").model, 64)


@pytest.mark.parametrize("source", ["python", "native", "native_mt", "cfb", "movielens"])
def test_repeating_stream_of_an_empty_split_raises(tmp_path, monkeypatch, source):
    """A file too small to hold a chunk of the val split: a one-pass read
    ends empty, and a repeating stream refuses instead of spinning."""
    if source == "movielens":
        files.write_movielens(tmp_path)
        _, cfg = files.cfg_pair("movielens", path=str(tmp_path), dataset="movielens",
                                batch_size=64, val_every=10)  # 40 val ratings
    else:
        path = str(tmp_path / "c.tsv")
        _write_criteo(path, 500)
        if source == "cfb":
            from cffm_tpu_torch.data.prehash import convert

            convert(path, path + ".cfb", get_config("criteo_kaggle").model, "criteo")
            path += ".cfb"
        else:
            _route(monkeypatch, source)
        _, cfg = files.cfg_pair("criteo_kaggle", path=path, dataset="criteo", batch_size=512,
                                val_every=10, reader_threads=ROUTES.get(source, 4))
    assert list(make_dataset(cfg, prefetch=0, split="val", repeat=False)) == []
    with pytest.raises(ValueError, match="never yield"):
        next(make_dataset(cfg, prefetch=2, split="val"))
