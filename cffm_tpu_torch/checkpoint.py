"""Checkpoint, resume and resharding of the train state.

The port's counterpart of `cffm_tpu/checkpoint.py`, without orbax. A
checkpoint is one directory per step:

    <directory>/<step>/meta.json       config_name, num_table_shards,
                                       total_vocab, table_width (JAX's keys)
    <directory>/<step>/dense.pt        rank 0: the step, the dense params
                                       and the dense optimizer's state, and
                                       the sparse state's counters
    <directory>/<step>/shard00000.pt   table shard s: the table, linear
    ...                                table and every per-row optimizer
                                       leaf (accum, m, v) of shard s

Every file is written with `torch.save`. A save writes under
`<step>.partial`; after a barrier on the group, rank 0 writes meta.json
and renames the directory to `<step>`, so `latest_step()` never sees a
partial write (orbax's commit, which JAX gets for free). `max_to_keep`
removes the oldest committed steps.

The mod-sharded layout of the tables depends on the shard count T
(`parallel/sharded_embedding.py`: global id g at shard g % T, local row
g // T). In the JAX package the sharded state is one global array in
that layout; in the port each rank holds its own (Vs, W) block. Either
way the saved rows are the same: shard s's file holds rows
[s*Vs, (s+1)*Vs) of JAX's global storage. Rank r holds table shard
r % num_shards: the rank itself on the flat and hierarchical engines,
its chip index on the intra-host engine (rank h*C + c of a group of H
hosts of C cards, the tables sharded over C and replicated over the
hosts). Only the ranks r < num_shards (host 0's) write shard files.
`restore_auto` onto another shard count reads every shard file,
rebuilds the natural row order and keeps this rank's shard of the new
layout, as JAX's `reshard_tables` does.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import torch
import torch.distributed as dist

from cffm_tpu_torch.config import TrainConfig
from cffm_tpu_torch.train import TrainState

_META = "meta.json"
_DENSE = "dense.pt"
_PARTIAL = ".partial"
_FIELDS = ("params", "dense_opt_state", "sparse_opt_state")


def _shard_file(rank: int) -> str:
    return f"shard{rank:05d}.pt"


def _meta(cfg: TrainConfig, num_shards: int) -> dict:
    return {
        "config_name": cfg.name,
        "num_table_shards": num_shards,
        "total_vocab": cfg.model.total_vocab,
        "table_width": cfg.model.table_width,
    }


def _flatten(tree, prefix: str, out: Dict) -> Dict:
    """Leaves of a tree of dicts and lists, keyed by their '/' path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = tree
    return out


def _rebuild(tree, prefix: str, leaf):
    """tree's structure with each leaf x at path p replaced by leaf(p, x)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{prefix}/{k}", leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, f"{prefix}/{i}", leaf) for i, v in enumerate(tree)]
    return leaf(prefix, tree)


def state_leaves(state: TrainState) -> Dict:
    """The step and every leaf of state, keyed by its '/' path
    ("params/embed/table", "dense_opt_state/count", ...)."""
    out = {"step": int(state.step)}
    for name in _FIELDS:
        _flatten(getattr(state, name), name, out)
    return out


def _is_table(path: str, leaf, rows: int) -> bool:
    """The leaves stored by rows of the table: the embedding and linear
    tables and every 2-d per-row leaf of the sparse state (a scalar such
    as Adam's t is not)."""
    if path in ("params/embed/table", "params/linear/table"):
        return True
    return (path.startswith("sparse_opt_state/") and isinstance(leaf, torch.Tensor)
            and leaf.dim() == 2 and leaf.shape[0] == rows)


def _group() -> tuple:
    """(rank, world) of the default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _table_shard(num_shards: int) -> int:
    """The table shard this rank holds under num_shards shards."""
    return _group()[0] % num_shards


def _barrier() -> None:
    if _group()[1] > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _write(path: str, obj) -> None:
    """torch.save, flushed to the disk before the commit can name it."""
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _load(path: str) -> Dict:
    # mapped, not read: the restore copies each leaf once, to its device
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


class CheckpointManager:
    """Saves and restores TrainStates under one directory.

    In a group every rank makes a manager on the same directory and calls
    save and restore at the same point: a save ends in barriers."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._pending = None  # (thread, errors, step, meta) of an unfinished save
        rank, _ = _group()
        if rank == 0:
            os.makedirs(self.directory, exist_ok=True)
        _barrier()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list:
        """The committed steps, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(self._step_dir(int(n))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, cfg: TrainConfig,
             num_shards: int = 1, wait: bool = False) -> bool:
        """Save state as step. num_shards: how many table shards the group
        holds (1 for a replicated table; ranks r and r + num_shards hold
        the same one). The tensors are copied to the
        host before this returns; with wait=False the files are written
        on a thread and committed by the next save, wait_until_finished()
        or close(). A step at or below the latest committed one is not
        saved (as orbax does); returns whether it was."""
        self.wait_until_finished()
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        rank, _ = _group()
        flat = state_leaves(state)
        rows = state.params["embed"]["table"].shape[0]
        tables = {p for p, x in flat.items() if _is_table(p, x, rows)}

        def host(x):
            # a copy: the train step updates the state's tensors in place
            return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x

        files = {}
        if rank == 0:
            files[_DENSE] = {p: host(x) for p, x in flat.items() if p not in tables}
        if rank < num_shards:  # one writer a shard: the first host's ranks
            files[_shard_file(rank)] = {p: host(flat[p]) for p in tables}
        partial = self._step_dir(step) + _PARTIAL
        if rank == 0:
            shutil.rmtree(partial, ignore_errors=True)  # a crashed run's leftovers
            os.makedirs(partial)
        _barrier()
        errors = []

        def write():
            try:
                for name, obj in files.items():
                    _write(os.path.join(partial, name), obj)
            except Exception as e:  # noqa: BLE001 -- re-raised by wait_until_finished
                errors.append(e)

        thread = threading.Thread(target=write, name=f"checkpoint-{step}")
        thread.start()
        self._pending = (thread, errors, step, _meta(cfg, num_shards))
        if wait:
            self.wait_until_finished()
        return True

    def wait_until_finished(self) -> None:
        """Finish and commit an unfinished save; raise what its writes raised."""
        if self._pending is None:
            return
        thread, errors, step, meta = self._pending
        self._pending = None
        thread.join()
        if errors:
            raise errors[0]
        _barrier()
        if _group()[0] == 0:
            partial = self._step_dir(step) + _PARTIAL
            with open(os.path.join(partial, _META), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(partial, self._step_dir(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old))
        _barrier()

    def _resolve(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return step

    def restore_meta(self, step: Optional[int] = None) -> dict:
        """The meta.json of a checkpoint (cheap)."""
        with open(os.path.join(self._step_dir(self._resolve(step)), _META)) as f:
            return json.load(f)

    def restore(self, state_like: TrainState, step: Optional[int] = None
                ) -> tuple[TrainState, dict]:
        """Restore into the structure, devices and dtypes of state_like,
        saved under the shard count this group restores with: rank r reads
        the file of its shard, r % num_table_shards."""
        step = self._resolve(step)
        d = self._step_dir(step)
        meta = self.restore_meta(step)
        flat = _load(os.path.join(d, _DENSE))
        shard = _table_shard(int(meta.get("num_table_shards", 1)))
        flat.update(_load(os.path.join(d, _shard_file(shard))))
        return _state_from_flat(state_like, flat), meta

    def restore_auto(self, state_like: TrainState, cfg: TrainConfig, num_shards: int,
                     step: Optional[int] = None) -> tuple[TrainState, dict]:
        """Restore, re-permuting the table storage when the checkpoint was
        saved under another shard count (the padded shapes may coincide,
        so a blind restore would load a wrong row order without error)."""
        step = self._resolve(step)
        meta = self.restore_meta(step)
        from_shards = int(meta.get("num_table_shards", 1))
        if meta.get("total_vocab") not in (None, cfg.model.total_vocab):
            raise ValueError(
                f"checkpoint total_vocab={meta['total_vocab']} != config "
                f"total_vocab={cfg.model.total_vocab} — wrong config?")
        if from_shards == num_shards:
            return self.restore(state_like, step)
        d = self._step_dir(step)
        flat = _load(os.path.join(d, _DENSE))
        shards = [_load(os.path.join(d, _shard_file(r))) for r in range(from_shards)]
        shard, v = _table_shard(num_shards), cfg.model.total_vocab
        for path in shards[0]:
            storage = torch.cat([s[path] for s in shards])
            new = _remap(storage, v, from_shards, num_shards)
            vs = new.shape[0] // num_shards
            flat[path] = new[shard * vs:(shard + 1) * vs]
        return _state_from_flat(state_like, flat), meta

    def close(self) -> None:
        self.wait_until_finished()


def _state_from_flat(state_like: TrainState, flat: Dict) -> TrainState:
    """state_like's tree with flat's leaves on its leaves' devices and dtypes."""
    def place(path, ref):
        return flat[path].to(device=ref.device, dtype=ref.dtype, copy=True)

    return TrainState(int(flat["step"]),
                      *(_rebuild(getattr(state_like, name), name, place) for name in _FIELDS))


def _remap(x: torch.Tensor, v: int, from_shards: int, to_shards: int) -> torch.Tensor:
    """Global table storage for from_shards -> the same rows for to_shards."""
    from cffm_tpu_torch.parallel.sharded_embedding import from_mod_sharded, to_mod_sharded

    nat = from_mod_sharded(x, from_shards, v) if from_shards > 1 else x[:v]
    return to_mod_sharded(nat, to_shards) if to_shards > 1 else nat


def reshard_tables(state: TrainState, cfg: TrainConfig, from_shards: int,
                   to_shards: int) -> TrainState:
    """Re-permute the global table storage of state (every shard's rows,
    in rank order) from from_shards to to_shards: the tables and every
    table-shaped leaf of the sparse state; scalars pass through."""
    if from_shards == to_shards:
        return state
    v = cfg.model.total_vocab
    from_pad = -(-v // from_shards) * from_shards
    flat = state_leaves(state)
    for path, x in flat.items():
        if _is_table(path, x, from_pad):
            flat[path] = _remap(x, v, from_shards, to_shards)
    return TrainState(state.step, *(_rebuild(getattr(state, name), name,
                                             lambda p, _: flat[p]) for name in _FIELDS))

