"""cffm_tpu_torch: the CFFM click-through-rate engine in PyTorch for CUDA.

A port of the JAX package `cffm_tpu` to NVIDIA Hopper GPUs. The port
keeps the JAX package's configs, parameter layouts and function names;
its fused cross+conv kernel is CUDA C++ (`ops/csrc/`), built with nvcc
at first use. Entry points run on the CUDA device unless the caller
passes device="cpu", where every kernel wrapper takes its plain PyTorch
version.
"""

from __future__ import annotations

import torch

from cffm_tpu_torch.config import (DataConfig, ModelConfig, OptimizerConfig,
                                   ShardingConfig, TrainConfig, get_config,
                                   list_configs)

__all__ = [
    "DataConfig", "ModelConfig", "OptimizerConfig", "ShardingConfig",
    "TrainConfig", "get_config", "list_configs", "resolve_device",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA device by default.

    With no device given and no CUDA device present this raises: the
    port does not carry on on the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
