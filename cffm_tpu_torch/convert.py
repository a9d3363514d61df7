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
