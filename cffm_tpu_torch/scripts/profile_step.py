"""Decompose the criteo_kaggle train step's time on the card.

    python -m cffm_tpu_torch.scripts.profile_step [stage] [batch]

The port's counterpart of `scripts/profile_step.py`. Stages (default
full, batch 32768), each on the port's own functions and the synthetic
batch of `bench.py`:

  lookup  models.cffm.lookup on the route train.train_step takes
          (models.cffm.route; on criteo_kaggle the hybrid field-major
          route, one launch of ops/embed_lookup's kernel on the card)
  fwd     models.cffm.forward (no grad)
  fwdbwd  that lookup, then models.cffm.forward_from_rows and the loss's
          gradient with respect to the dense params and the looked-up
          rows, as train.train_step takes them
  sparse  optim.rowwise.rowwise_update (in place) with max_unique from
          unique_bound
  full    train.train_step

lookup, fwd and fwdbwd are timed with CUDA events; sparse and full, which
update state in place, by host clock over 10 calls ending in a
synchronize. Run each stage in a fresh process to compare them on a clean
card.
"""

from __future__ import annotations

import argparse
import time

import torch

STAGES = ("lookup", "fwd", "fwdbwd", "sparse", "full")


def _timed_steps(fn, device: torch.device, n: int) -> float:
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / n


def run(stage: str, cfg, device="cuda", n: int = 10) -> float:
    """Seconds per call of one stage at cfg's batch size."""
    from cffm_tpu_torch import metrics, train
    from cffm_tpu_torch.bench import staged_batch
    from cffm_tpu_torch.models import cffm as model_lib
    from cffm_tpu_torch.optim.rowwise import rowwise_init, rowwise_update, unique_bound
    from cffm_tpu_torch.utils.timing import time_per_call

    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; have {STAGES}")
    device = torch.device(device)
    mcfg = cfg.model
    batch = cfg.data.batch_size
    ids, dense, labels = train.batch_to_device(staged_batch(cfg), device)
    gen = torch.Generator(device=device).manual_seed(0)
    fn = train.default_interaction_fn(cfg)

    if stage == "full":
        box = [train.create_state(cfg, gen)]

        def step():
            box[0], m = train.train_step(box[0], ids, dense, labels, cfg, fn)
            return m

        return _timed_steps(step, device, n)
    if stage == "sparse":
        table = 0.01 * torch.randn((mcfg.total_vocab, mcfg.table_width), generator=gen,
                                   device=device)
        st = rowwise_init(table, cfg.optim)
        grads = (0.01 * torch.randn((batch * mcfg.num_fields, mcfg.table_width),
                                    generator=gen, device=device)
                 ).to(model_lib.torch_dtype(mcfg.compute_dtype))
        offs = tuple(int(o) for o in model_lib.field_offsets(mcfg))
        mu = unique_bound(mcfg.vocab_sizes, batch)
        flat_ids = ids.reshape(-1)
        return _timed_steps(lambda: rowwise_update(table, st, flat_ids, grads, cfg.optim,
                                                   max_unique=mu, field_offsets=offs),
                            device, n)
    params = model_lib.init_params(mcfg, gen)
    route = model_lib.route(params, mcfg, fn, train.has_dense_form(cfg.optim))
    if stage == "lookup":
        return time_per_call(model_lib.lookup, params, route, ids, mcfg, n=n, device=device)

    if stage == "fwd":
        @torch.no_grad()
        def fwd():
            return model_lib.forward(params, ids, dense, mcfg, interaction_fn=fn).sum()

        return time_per_call(fwd, n=n, device=device)

    cdt = model_lib.torch_dtype(mcfg.compute_dtype)

    def fwdbwd():
        _, leaves, full = train.dense_leaves(params)
        rows = list(model_lib.lookup(params, route, ids, mcfg))
        if not route.field_major:
            rows[0] = rows[0].to(cdt)
        rows = [r.requires_grad_() for r in rows]
        logits = model_lib.forward_from_rows(full, route, rows, dense, mcfg, interaction_fn=fn)
        loss = metrics.logloss(logits, labels)
        return torch.autograd.grad(loss, leaves + rows)

    return time_per_call(fwdbwd, n=n, device=device)


def main(argv=None) -> int:
    from cffm_tpu_torch.bench import bench_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", nargs="?", default="full", choices=STAGES)
    ap.add_argument("batch", nargs="?", type=int, default=32768)
    args = ap.parse_args(argv)
    cfg = bench_config("criteo_kaggle", args.batch, "float32")
    dt = run(args.stage, cfg)
    print(f"stage={args.stage} batch={args.batch} dt={dt * 1e3:.3f}ms "
          f"rate={args.batch / dt / 1e3:.1f}K ex/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
