"""ordered_parallel_map keeps input order, surfaces an error in order and
bounds what it reads ahead; the multi-threaded reader on it gives the
same stream at any thread count, equal to the JAX package's."""

import sys
import time

import numpy as np
import pytest

from cffm_tpu.config import get_config as jax_get_config
from cffm_tpu.data import native as jax_native
from cffm_tpu.data.readers import criteo_batches_native_mt as jax_native_mt
from cffm_tpu_torch.config import get_config
from cffm_tpu_torch.data.parallel_reader import ordered_parallel_map
from cffm_tpu_torch.data.readers import criteo_batches, criteo_batches_native_mt
from cffm_tpu_torch.scripts.bench_input import _write_criteo


@pytest.mark.parametrize("threads,depth", [(1, 16), (3, 2), (7, 5), (16, 1)])
def test_ordered_parallel_map_preserves_order(threads, depth):
    items = list(range(257))
    out = list(ordered_parallel_map(iter(items), lambda x: x * x, num_threads=threads,
                                    depth=depth))
    assert out == [x * x for x in items]


def test_ordered_parallel_map_order_under_contention():
    """More threads than cores, a short switch interval and work of random
    length: results still come back in input order."""
    rng = np.random.default_rng(0)
    delays = rng.random(300) * 1e-3
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(i):
            time.sleep(delays[i])
            return i

        out = list(ordered_parallel_map(iter(range(300)), fn, num_threads=32, depth=4))
    finally:
        sys.setswitchinterval(old)
    assert out == list(range(300))


def test_ordered_parallel_map_propagates_exception_in_order():
    def fn(x):
        if x == 5:
            raise ValueError("boom")
        return x

    got = []
    with pytest.raises(ValueError, match="boom"):
        for v in ordered_parallel_map(iter(range(10)), fn, num_threads=3):
            got.append(v)
    assert got == [0, 1, 2, 3, 4]


def test_ordered_parallel_map_surfaces_an_error_of_its_items():
    """An error reading the items (a file that cannot be read) ends the
    stream with that error after the items before it, not silently."""
    def items():
        yield from range(4)
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for v in ordered_parallel_map(items(), lambda x: x, num_threads=2):
            got.append(v)
    assert got == [0, 1, 2, 3]


def test_ordered_parallel_map_refuses_no_threads():
    with pytest.raises(ValueError, match="num_threads"):
        ordered_parallel_map(iter([1]), lambda x: x, num_threads=0)


def test_feeder_bounded_when_consumer_stalls():
    """A stalled consumer does not let the pipeline read ahead without
    bound: unconsumed items are capped at depth + num_threads."""
    produced = []

    def src():
        for i in range(10000):
            produced.append(i)
            yield i

    g = ordered_parallel_map(src(), lambda x: x * 2, num_threads=4, depth=8)
    first = next(g)
    time.sleep(0.5)  # the feeder parks on the slot cap
    assert first == 0
    assert len(produced) <= 8 + 4 + 2, f"feeder ran ahead: {len(produced)}"
    assert [first] + [next(g) for _ in range(99)] == [2 * i for i in range(100)]


@pytest.fixture(scope="module")
def criteo_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("mt") / "criteo.tsv"
    _write_criteo(str(p), 12_000)
    return str(p)


def test_mt_reader_same_stream_at_every_thread_count_and_as_jax(criteo_file):
    # load the JAX package's parser on this thread first: its loader is not
    # thread-safe, and a first load from two parse threads at once can see
    # the library as unavailable (the port's loader takes a lock)
    assert jax_native.available()
    cfg = get_config("criteo_kaggle").model
    want = list(jax_native_mt(criteo_file, jax_get_config("criteo_kaggle").model, 1024,
                              repeat=False, num_threads=2))
    py = list(criteo_batches(criteo_file, cfg, 1024, repeat=False))
    assert len(want) == len(py) == 12 and len(want[-1][0]) == 12_000 - 11 * 1024
    for threads in (1, 3, 8):
        got = list(criteo_batches_native_mt(criteo_file, cfg, 1024, repeat=False,
                                            num_threads=threads))
        assert len(got) == len(want)
        for (a, b, c), (x, y, z), (pi, _, pl) in zip(want, got, py):
            np.testing.assert_array_equal(a, x)
            np.testing.assert_array_equal(b, y)
            np.testing.assert_array_equal(c, z)
            np.testing.assert_array_equal(pi, x)  # the Python reader's rows too
            np.testing.assert_array_equal(pl, z)
