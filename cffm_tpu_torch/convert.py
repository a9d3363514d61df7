"""Parameters of the JAX package, as numpy, -> the port's parameters.

`params_from_jax(jax.tree.map(np.asarray, params), device)` takes the
params of `cffm_tpu.models.cffm.init_params` (or a restored
`TrainState.params`) after conversion to numpy, and returns the same
tree of torch tensors: dicts and lists kept, every array copied with its
dtype and layout. It takes numpy only; bfloat16 arrays (numpy's
ml_dtypes extension type) are carried over bit for bit.
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
