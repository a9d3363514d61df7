"""The yardstick's counts: FLOPs and bytes as reckoned by hand in
PERF.md, and traffic that depends on the seed alone."""

import numpy as np
import pytest

from benchmark import spec, traffic, work
from benchmark.tests.conftest import ROOT

KAGGLE = spec.load_json(ROOT / "benchmark" / "configs" / "criteo_kaggle.json")["model"]


def test_criteo_kaggle_flops_by_hand():
    assert work.forward_flops(KAGGLE) == {"cross": 741 * 16, "conv1": 2 * 741 * 3 * 64 * 16,
                                          "conv2": 2 * 64 * 3 * 64 * 8,
                                          "tower": 2 * (269 * 256 + 256 * 128 + 128)}
    assert work.example_flops(KAGGLE, train=False) == 4_964_688
    assert work.example_flops(KAGGLE, train=True) == 14_894_064


def test_criteo_kaggle_kernel_bytes_by_hand():
    b = 65536
    assert work.table_width(KAGGLE) == 640 and work.small_prefix(KAGGLE) == 13
    k1 = work.k1(KAGGLE, b)
    assert k1["bytes"] == b * 39 * 640 * 2 + 64 * 741 * 3 * 4 + b * 64 * 16 * 2 + b * 4
    assert k1["ops"] == 2 * b * 64 * 16 * 741 * 3
    assert abs(work.bound_of(k1) - 1.0169e-3) < 2e-6     # chip_smoke's bound at B=65536
    k2 = work.k2(KAGGLE, b)
    assert k2["bytes"] == 2 * b * 39 * 640 * 2 + b * 64 * 16 * 2 + b * 4 + 64 * 741 * 3 * 6
    assert abs(work.bound_of(k2) - 1.9936e-3) < 2e-6
    k4 = work.k4(KAGGLE, 135_762, 4, "adagrad")
    assert k4["bytes"] == 135_762 * (4 + 640 * 2 + 640 * 4 * 2 + 8)


TRAIN_IDS = spec.load_json(ROOT / "benchmark" / "traffic" / "train_zipf.json")["ids"]


def test_traffic_follows_the_seed():
    def draw(seed):
        w = traffic.PlantedCTR(KAGGLE["vocab_sizes"], 13, seed, TRAIN_IDS)
        return w.batch(traffic.rng(seed, 1), 512)

    a, b, c = draw(2**31 + 7), draw(2**31 + 7), draw(2**31 + 8)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert (a[0] >= 0).all() and (a[0].max(axis=0) <= np.asarray(KAGGLE["vocab_sizes"]) - 1).all()


@pytest.mark.parametrize("n", [3, 1000, 300_000])
def test_zipf_values_follow_the_truncated_law(n):
    """Exact CDF over the head, its integral over the tail: the draws'
    frequencies and the tail's mass match the law's."""
    draws = 400_000
    k = traffic.TruncatedZipf(1.3, n).draw(traffic.rng(4, 1).random(draws))
    p = np.arange(1, n + 1, dtype=np.float64) ** -1.3
    p /= p.sum()
    assert k.min() >= 0 and k.max() <= n - 1
    for q in {0, 1, 2, n // 2, n - 1}:
        assert abs((k == q).mean() - p[q]) < 5 * np.sqrt(p[q] / draws) + 1e-5, q
    if n > traffic.HEAD:
        tail = p[traffic.HEAD:].sum()
        assert abs((k >= traffic.HEAD).mean() - tail) < 5 * np.sqrt(tail / draws)


def test_hashed_fields_use_their_published_cardinalities():
    """A batch of 65536 has the distinct rows PERF.md reports (about 68k
    over the 26 big fields); a field of cardinality c never shows more
    than c ids, and hashing is the same for every seed."""
    w = traffic.PlantedCTR(KAGGLE["vocab_sizes"], 13, 2**31 + 9, TRAIN_IDS)
    ids = w.batch(traffic.rng(2**31 + 9, 1), 65536)[0]
    distinct = [np.unique(ids[:, f]).size for f in range(13, 39)]
    assert 64_000 < sum(distinct) < 72_000, sum(distinct)
    assert all(d <= c for d, c in zip(distinct, TRAIN_IDS["cardinality"][13:]))
    v = np.arange(1000)
    assert np.array_equal(traffic.bucket(20, v, 100_000), traffic.bucket(20, v, 100_000))
    assert not np.array_equal(traffic.bucket(20, v, 100_000), traffic.bucket(21, v, 100_000))
