"""The port's command lines: dotted config overrides and the train CLI.

`data.batch_size=1024` (or `--data.batch_size=1024`) sets one field of
the frozen dataclass tree.
"""

from __future__ import annotations

import dataclasses


def _apply_override(cfg, dotted: str, raw: str):
    parts = dotted.split(".")

    def rec(obj, path):
        field = path[0]
        if not hasattr(obj, field):
            raise SystemExit(f"error: unknown config field {dotted!r}")
        if len(path) == 1:
            cur = getattr(obj, field)
            if isinstance(cur, bool):
                val = raw.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                val = int(raw)
            elif isinstance(cur, float):
                val = float(raw)
            elif isinstance(cur, tuple):
                val = tuple(int(x) for x in raw.split(","))
            elif cur is None or isinstance(cur, str):
                val = raw
            else:
                raise SystemExit(f"error: cannot override field {dotted!r} of type {type(cur)}")
            return dataclasses.replace(obj, **{field: val})
        return dataclasses.replace(obj, **{field: rec(getattr(obj, field), path[1:])})

    return rec(cfg, parts)


def main(argv=None) -> int:
    """`python -m cffm_tpu_torch.train --config=<name> [--device=cuda]
    [section.field=value | --section.field=value ...]`: train, evaluate,
    print JSON lines; exit 1 when the final AUC is NaN."""
    import argparse

    from cffm_tpu_torch.config import get_config, list_configs

    parser = argparse.ArgumentParser(prog="cffm_tpu_torch.train",
                                     description="CFFM CTR training on a CUDA card")
    parser.add_argument("--config", required=True, help=f"one of {list_configs()}")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: cuda)")
    args, rest = parser.parse_known_args(argv)
    try:
        cfg = get_config(args.config)
    except KeyError as e:
        raise SystemExit(f"error: {e.args[0]}")
    for item in rest:
        dotted, eq, raw = item.removeprefix("--").partition("=")
        if not eq:
            raise SystemExit(f"error: unrecognized argument {item!r} "
                             "(want section.field=value)")
        cfg = _apply_override(cfg, dotted, raw)

    from cffm_tpu_torch import train

    result = train.run(cfg, device=args.device)
    return 0 if result.get("auc") == result.get("auc") else 1
