"""One-shot TSV -> .cfb converter (see prehashed.py for the format).

    python -m cffm_tpu_torch.data.prehash IN OUT --config=criteo_kaggle \
        [--dataset=criteo] [--chunk=65536] [--threads=4]

The port's copy of `cffm_tpu/data/prehash.py`; the files it writes are
byte-equal to the JAX package's. It runs the streaming reader (the
native multi-threaded parse when available) over the WHOLE file, with no
split and no sharding, and streams the hashed records out. Split, shard
and shuffle are read-time decisions of prehashed_batches, so one .cfb
serves every topology.
"""

from __future__ import annotations

import argparse
import sys
import time

from cffm_tpu_torch.config import get_config
from cffm_tpu_torch.data import readers
from cffm_tpu_torch.data.prehashed import write_prehashed


def convert(src: str, out: str, model_cfg, dataset: str,
            chunk: int = 65536, reader_threads: int = 4) -> int:
    """Parse and hash src with the `dataset` reader (on
    readers.reader_route(reader_threads)) and write a .cfb file. Returns
    the rows written: every valid Criteo or Avazu row (the one pass
    flushes its partial tail); MovieLens drops its partial last batch."""
    kw = dict(repeat=False, split="train", val_every=0)
    if dataset == "movielens":
        it = readers.movielens_batches(src, model_cfg, chunk, **kw)
    else:
        it = readers.file_batches(dataset, src, model_cfg, chunk,
                                  reader_threads=reader_threads, **kw)
    return write_prehashed(out, it, model_cfg.num_fields, model_cfg.num_dense)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src")
    ap.add_argument("out")
    ap.add_argument("--config", default="criteo_kaggle")
    ap.add_argument("--dataset", default=None,
                    help="criteo|avazu|movielens (default: config's)")
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    cfg = get_config(args.config)
    dataset = args.dataset or cfg.data.dataset
    t0 = time.time()
    n = convert(args.src, args.out, cfg.model, dataset,
                chunk=args.chunk, reader_threads=args.threads)
    dt = time.time() - t0
    print(f"wrote {n} rows to {args.out} in {dt:.1f}s "
          f"({n / max(dt, 1e-9):,.0f} rows/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
