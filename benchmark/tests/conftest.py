"""Fixtures of the benchmark's own tests: tiny jobs of each driver on the
CPU, and the `card` marker (a test that needs a CUDA card decides so
inside, through the `card` fixture, and skips without one).

Run from the repository root: python -m pytest benchmark/tests -q
"""

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# the tiny config's 15 fields: 5 bucketized, 10 hashed from other cardinalities
TINY_IDS = {"kind": "zipf", "a": 1.3, "hashed_from": 5,
            "cardinality": [16] * 5 + [3, 40, 900, 2000, 5000, 100000, 10**7, 12, 250, 60000]}
TINY_TRAFFIC = {
    "train": {"driver": "train", "ids": TINY_IDS, "batch_size": 256, "pool_batches": 4,
              "trace_steps": 2},
    "score": {"driver": "score", "ids": TINY_IDS, "batch_size": 64, "pool_batches": 3,
              "trace_batches": 2},
}
CELLS = {"train": "kaggle-train-zipf", "score": "kaggle-score-offline"}


def tiny_config(compute_dtype: str = "bfloat16") -> dict:
    """criteo_kaggle's file with 15 fields (5 of 16 ids, 10 of 2000), d=16,
    conv (8, 8), tower (16, 8) and 3 dense inputs: the same paths, tiny."""
    from benchmark import spec

    c = copy.deepcopy(spec.load_json(ROOT / "benchmark" / "configs" / "criteo_kaggle.json"))
    c["model"].update(num_fields=15, vocab_sizes=[16] * 5 + [2000] * 10, conv_channels=[8, 8],
                      tower_hidden=[16, 8], num_dense=3, compute_dtype=compute_dtype)
    return c


@pytest.fixture
def tiny_job():
    """tiny_job(kind, seed=5, compute_dtype="bfloat16", **job fields): a
    Job of the train or score driver on the CPU, with the cell's limits."""
    import torch

    from benchmark import spec

    def make(kind, seed=5, compute_dtype="bfloat16", **kw):
        limits = spec.load_json(ROOT / "benchmark" / "checks" / f"{CELLS[kind]}.json")
        args = dict(workload=CELLS[kind], seed=seed, seconds=0.3, trace=False,
                    config=tiny_config(compute_dtype), traffic=dict(TINY_TRAFFIC[kind]),
                    limits=limits, device=torch.device("cpu"))
        args.update(kw)
        return spec.Job(**args)

    return make
