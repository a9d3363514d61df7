"""Parameters of the JAX package, as numpy, -> the port's parameters.

`params_from_jax(jax.tree.map(np.asarray, params), device)` takes the
params of `cffm_tpu.models.cffm.init_params` (or a restored
`TrainState.params`) after conversion to numpy, and returns the same
tree of torch tensors: dicts and lists kept, every array copied with its
dtype and layout. It takes numpy only; bfloat16 arrays (numpy's
ml_dtypes extension type) are carried over bit for bit.

`state_from_jax(np_state, device)` carries a whole JAX `TrainState`
across, given as numpy in plain containers (the caller flattens optax's
state, so the port imports no optax):

    {"step": int,
     "params": params tree,
     "dense_opt_state": {"count", "mu", "nu"} (adam) | {"sum"} (adagrad) | {},
     "sparse_opt_state": {"embed": {"accum"} | {"m", "v", "t"} | {},
                          ["linear": ...]}}

and returns the port's `train.TrainState`. The step counters ("count",
"t") stay on the CPU, as the port keeps them.

`sharded_state_from_jax(np_state, rank, world, device)` does the same
for a state of JAX's `create_sharded_state` (the same tree, tables and
per-row state in mod-sharded global storage) and returns rank's share
for the port's sharded step (the flat and the hierarchical engine:
shard h*C + c is rank h*C + c). `sharded_state_2d_from_jax` does it for
a state of JAX's `create_sharded_state_2d` (tables sharded over the C
chips of a host, the same rows on every host). `natural_from_shards`
puts the ranks' shards of one table back into the natural row order.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: the tensor owns its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params, device="cpu"):
    """Map a numpy params tree (dicts, lists, tuples) to torch tensors."""
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, device) for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return [params_from_jax(v, device) for v in np_params]
    return _tensor(np_params, device)


_CPU_SCALARS = ("count", "t")


def _state_tree(tree, device):
    if isinstance(tree, dict):
        return {k: (_tensor(v, "cpu").to(torch.int32) if k in _CPU_SCALARS
                    else _state_tree(v, device)) for k, v in tree.items()}
    return params_from_jax(tree, device)


def state_from_jax(np_state, device="cpu"):
    """A JAX TrainState as numpy (see the module note) -> train.TrainState."""
    from cffm_tpu_torch.train import TrainState

    return TrainState(
        step=int(np_state["step"]),
        params=params_from_jax(np_state["params"], device),
        dense_opt_state=_state_tree(np_state["dense_opt_state"], device),
        sparse_opt_state=_state_tree(np_state["sparse_opt_state"], device))


def _shard_rows(tree, rank: int, world: int):
    """Rows [rank*Vs, (rank+1)*Vs) of every 2-d array (the row-sharded
    leaves of the JAX sharded state); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _shard_rows(v, rank, world) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shard_rows(v, rank, world) for v in tree]
    a = np.asarray(tree)
    if a.ndim != 2:
        return a
    vs = a.shape[0] // world
    return a[rank * vs:(rank + 1) * vs]


def sharded_state_from_jax(np_state, rank: int, world: int, device="cpu"):
    """Rank's share of a JAX sharded TrainState given as numpy (see the
    module note): rows [rank*Vs, (rank+1)*Vs) of the mod-sharded global
    table, linear table, accum, m and v; dense params and their
    optimizer state replicated."""
    params = dict(np_state["params"])
    params["embed"] = _shard_rows(params["embed"], rank, world)
    if "table" in params.get("linear", {}):
        params["linear"] = dict(params["linear"],
                                table=_shard_rows(params["linear"]["table"], rank, world))
    return state_from_jax({
        "step": np_state["step"], "params": params,
        "dense_opt_state": np_state["dense_opt_state"],
        "sparse_opt_state": _shard_rows(np_state["sparse_opt_state"], rank, world)},
        device)


def sharded_state_2d_from_jax(np_state, rank: int, chips_per_host: int, device="cpu"):
    """Rank's share of a JAX intra-host (2D) sharded TrainState given as
    numpy: the rows of its chip index, rank % chips_per_host, of the
    global storage sharded over chips_per_host; the same on every host."""
    return sharded_state_from_jax(np_state, rank % chips_per_host, chips_per_host, device)


def natural_from_shards(shards, num_rows: int) -> torch.Tensor:
    """The ranks' (Vs, n) shards of one table, in rank order -> the
    (num_rows, n) table in natural row order (global id g at row g)."""
    from cffm_tpu_torch.parallel.sharded_embedding import from_mod_sharded

    return from_mod_sharded(torch.cat([s.cpu() for s in shards]), len(shards), num_rows)
