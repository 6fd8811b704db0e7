"""One-call environment setup (counterpart of ``iseg_tpu/core/env.py``).

:func:`common_env_setup` seeds the host RNGs, picks the device and the
compute dtype (bf16 under autocast with fp32 params, or fp32), and turns
TF32 off. cuDNN autotuning (``torch.backends.cudnn.benchmark``) is left
to the caller: it speeds up fixed shapes but makes bf16 sums vary from
run to run. It raises when CUDA is asked for and absent:
it never drops to the CPU quietly.
"""

from __future__ import annotations

import dataclasses
import os
import random as _py_random

import numpy as np
import torch


@dataclasses.dataclass
class EnvConfig:
    random_seed: int = 0
    mixed_precision: bool = True  # bf16 compute, fp32 params
    device: str = "cuda"


@dataclasses.dataclass
class Env:
    device: torch.device
    generator: torch.Generator  # CPU generator seeded with ``seed`` (for init)
    seed: int
    compute_dtype: torch.dtype
    param_dtype: torch.dtype

    def describe(self) -> str:
        return (f"device={self.device} compute_dtype={self.compute_dtype} "
                f"param_dtype={self.param_dtype} "
                f"tf32(matmul={torch.backends.cuda.matmul.allow_tf32}, "
                f"cudnn={torch.backends.cudnn.allow_tf32}) "
                f"cudnn.benchmark={torch.backends.cudnn.benchmark} seed={self.seed}")


def set_random_seed(seed: int) -> None:
    """Seed host-side RNGs; model randomness is drawn from explicit
    generators derived from the same seed."""
    _py_random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def common_env_setup(config: EnvConfig | None = None, **kwargs) -> Env:
    if config is None:
        config = EnvConfig(**kwargs)
    device = torch.device(config.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {config.device!r} requested but CUDA is not available")
    set_random_seed(config.random_seed)
    # TF32 off: fp32 work stays full fp32, as in the JAX package's fp32 runs
    # (bf16 autocast work is unaffected either way)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Env(
        device=device,
        generator=torch.Generator().manual_seed(config.random_seed),
        seed=config.random_seed,
        compute_dtype=torch.bfloat16 if config.mixed_precision else torch.float32,
        param_dtype=torch.float32,
    )
