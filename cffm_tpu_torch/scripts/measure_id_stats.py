"""Distinct-id and bucket-occupancy statistics of the synthetic stream.

    python -m cffm_tpu_torch.scripts.measure_id_stats [--config=criteo_full]
        [--batch=65536] [--steps=8] [--topologies=1x1,1x8,2x8,2x4] [--json=out.json]

The port's counterpart of `scripts/measure_id_stats.py`, in numpy on the
host (no card needed). For each (hosts x chips) topology that divides the
batch, over `steps` batches of the config's synthetic stream
(`data/synthetic.py`, zipf ids):

  - the distinct ids of each card's block (the flat dedup buffer) against
    the static bound `unique_bound`;
  - the fullest (card, owner) bucket of the flat exchange and the
    capacity factor that would have covered it;
  - with more than one host: the host-distinct ids (the hierarchical
    stage-2 dedup), the fullest stage-1 (card, gateway) bucket and the
    fullest stage-2 (gateway, owner host) bucket, the rows a host sends
    across per step; and, beside JAX's numbers, the capacities the config
    picks at that shape (`hier_embedding.pick_capacities_hier` with its
    cap_rows / cap_rows_host) and whether each stage's fullest bucket
    overflows them;
  - the share of one host's distinct rows that sit in the global top-K
    hottest rows (K = 2^14, 2^16, 2^18), on the first multi-host topology.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

TOPOLOGIES = ((1, 1), (1, 8), (2, 8), (2, 4))


def measure(cfg, batch: int, steps: int, topologies) -> dict:
    """The statistics as JAX's `measure` returns them (its keys, its
    values), with the hierarchical capacities of cfg added."""
    from cffm_tpu_torch.data.synthetic import SyntheticCTR
    from cffm_tpu_torch.models.cffm import field_offsets
    from cffm_tpu_torch.optim.rowwise import unique_bound
    from cffm_tpu_torch.parallel.hier_embedding import pick_capacities_hier

    mcfg = cfg.model
    f = mcfg.num_fields
    offs = field_offsets(mcfg)[None, :].astype(np.int64)
    gen = SyntheticCTR(mcfg, batch, seed=cfg.data.seed)
    out = {"config": cfg.name, "batch": batch, "steps": steps, "topologies": {}}
    batches = [np.asarray(gen.next_batch()[0], np.int64) + offs for _ in range(steps)]

    for h, c in topologies:
        t = h * c
        if batch % t:
            continue
        b_loc = batch // t
        n_local = b_loc * f
        ub_chip = unique_bound(mcfg.vocab_sizes, b_loc)
        ub_host = unique_bound(mcfg.vocab_sizes, b_loc * c)
        base_flat = -(-n_local // t)
        chip_uniq, bucket_max, bucket_mean = [], [], []
        host_uniq, hbucket_max, s1bucket_max = [], [], []
        for g in batches:
            per_chip = g.reshape(t, b_loc * f)
            uniq = [np.unique(per_chip[s]) for s in range(t)]
            for u in uniq:
                chip_uniq.append(len(u))
                counts = np.bincount(u % t, minlength=t)
                bucket_max.append(int(counts.max()))
                bucket_mean.append(float(counts.mean()))
            if h > 1:
                # stage 1: each card's distinct ids by owner chip index
                for u in uniq:
                    s1bucket_max.append(int(np.bincount((u % t) % c, minlength=c).max()))
                # stage 2: each host's distinct ids, per gateway, by owner host
                for uh in map(np.unique, g.reshape(h, b_loc * c * f)):
                    host_uniq.append(len(uh))
                    gw = (uh % t) % c
                    for cc in range(c):
                        sel = uh[gw == cc]
                        hbucket_max.append(int(np.bincount((sel % t) // c, minlength=h).max()))
        rec = {
            "b_loc": b_loc, "n_local": n_local,
            "unique_bound_chip": ub_chip,
            "chip_distinct_mean": float(np.mean(chip_uniq)),
            "chip_distinct_max": int(np.max(chip_uniq)),
            "distinct_over_bound": float(np.mean(chip_uniq) / min(ub_chip, n_local)),
            "flat_bucket_base": base_flat,
            "flat_bucket_max": int(np.max(bucket_max)),
            "flat_bucket_mean": float(np.mean(bucket_mean)),
            "flat_factor_needed": float(np.max(bucket_max) / base_flat),
        }
        if h > 1:
            s = cfg.sharding
            v_pad = -(-mcfg.total_vocab // t) * t
            cap1, cap2 = pick_capacities_hier(n_local, h, c, s.id_capacity_factor, v_pad // t,
                                              ub_chip, ub_host, cap_rows=s.cap_rows,
                                              cap_rows_host=s.cap_rows_host)
            rec.update({
                "unique_bound_host": ub_host,
                "host_distinct_mean": float(np.mean(host_uniq)),
                "host_distinct_max": int(np.max(host_uniq)),
                "host_distinct_over_bound": float(np.mean(host_uniq)
                                                  / min(ub_host, b_loc * c * f)),
                "hier_s1_bucket_max": int(np.max(s1bucket_max)),
                "hier_s2_bucket_max": int(np.max(hbucket_max)),
                "dcn_rows_per_host_step": float(np.mean(host_uniq) * (h - 1) / h),
                "hier_cap1": cap1, "hier_cap2": cap2,
                "hier_s1_overflows": int(np.max(s1bucket_max)) > cap1,
                "hier_s2_overflows": int(np.max(hbucket_max)) > cap2,
            })
        out["topologies"][f"{h}x{c}"] = rec

    multi = [(h, c) for h, c in topologies if h > 1 and batch % (h * c) == 0]
    out["head_overlap"] = {}
    if multi:
        h, c = multi[0]
        freq_ids, freq = np.unique(np.concatenate([g.reshape(-1) for g in batches]),
                                   return_counts=True)
        ranked = freq_ids[np.argsort(-freq)]
        host_u = np.unique(batches[0].reshape(h, (batch // (h * c)) * c * f)[0])
        pos = np.full(int(freq_ids.max()) + 1, -1, np.int64)
        pos[ranked] = np.arange(len(ranked))
        ranks = pos[host_u]
        out["head_overlap_topology"] = f"{h}x{c}"
        for k in (1 << 14, 1 << 16, 1 << 18):
            out["head_overlap"][str(k)] = float(np.mean((ranks >= 0) & (ranks < k)))
    return out


def report(out: dict, cfg) -> None:
    w = cfg.model.table_width
    nbytes = 2 if cfg.model.table_dtype == "bfloat16" else 4
    print(f"# id stats: {cfg.name} batch={out['batch']} steps={out['steps']} W={w} "
          f"dtype={cfg.model.table_dtype}")
    for topo, r in out["topologies"].items():
        print(f"\n== {topo} (b_loc={r['b_loc']}, n_local={r['n_local']}) ==")
        print(f"  chip distinct: mean {r['chip_distinct_mean']:.0f} / max "
              f"{r['chip_distinct_max']} (bound {r['unique_bound_chip']}, ratio "
              f"{r['distinct_over_bound']:.3f})")
        print(f"  flat owner-bucket: base {r['flat_bucket_base']} max-seen "
              f"{r['flat_bucket_max']} mean {r['flat_bucket_mean']:.0f} -> factor needed "
              f"{r['flat_factor_needed']:.3f}")
        if "host_distinct_mean" in r:
            print(f"  host distinct: mean {r['host_distinct_mean']:.0f} / max "
                  f"{r['host_distinct_max']} (bound {r['unique_bound_host']}, ratio "
                  f"{r['host_distinct_over_bound']:.3f})")
            print(f"  hier stage-1 (chip,gateway) bucket max: {r['hier_s1_bucket_max']} "
                  f"against cap1 {r['hier_cap1']}: "
                  f"{'OVERFLOWS' if r['hier_s1_overflows'] else 'fits'}")
            print(f"  hier stage-2 gateway->owner-host bucket max: {r['hier_s2_bucket_max']} "
                  f"against cap2 {r['hier_cap2']}: "
                  f"{'OVERFLOWS' if r['hier_s2_overflows'] else 'fits'}")
            gb = r["dcn_rows_per_host_step"] * w * nbytes / 1e9
            print(f"  rows across hosts per host and step (host dedup): "
                  f"{r['dcn_rows_per_host_step']:.0f} = {gb:.3f} GB one way")
    if out.get("head_overlap"):
        print(f"\n== fraction of {out['head_overlap_topology']} host-distinct rows in the "
              f"global top-K head ==")
        for k, frac in out["head_overlap"].items():
            print(f"  K={int(k):>7}: {frac:.3f}")


def main(argv=None) -> int:
    from cffm_tpu_torch.config import get_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="criteo_full")
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--topologies", default=",".join(f"{h}x{c}" for h, c in TOPOLOGIES),
                    help="comma-separated HxC (hosts x cards per host)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    cfg = get_config(args.config)
    topologies = [tuple(int(x) for x in t.lower().split("x"))
                  for t in args.topologies.split(",")]
    out = measure(cfg, args.batch, args.steps, topologies)
    report(out, cfg)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"\nwrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
