"""Dotted config overrides for the port's command lines.

`--data.batch_size=1024` sets one field of the frozen dataclass tree.
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
