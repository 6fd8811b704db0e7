"""One-call environment setup (counterpart of ``iseg_tpu/core/env.py``).

:func:`common_env_setup` seeds the host RNGs, picks the device and the
compute dtype (bf16 under autocast with fp32 params, or fp32), and turns
TF32 off. :func:`resolve_device` is the device rule alone, for modules
that allocate their parameters where they are built. cuDNN autotuning (``torch.backends.cudnn.benchmark``) is left
to the caller: it speeds up fixed shapes but makes bf16 sums vary from
run to run. It raises when CUDA is asked for and absent:
it never drops to the CPU quietly.

With ``initialize_distributed`` it starts the process group (one process a
card, as ``torchrun --nproc_per_node=N`` launches them): NCCL when the
device is a card, gloo on the CPU, or the ``backend`` named. The
coordinator, process count and id come from the config or else from the
environment ``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); ``init_method`` (a
``file://`` or ``tcp://`` URL) overrides the coordinator. The device
becomes ``cuda:{LOCAL_RANK}`` on a card, and the env carries the
``("data", "model")`` mesh over the ranks, ``model_parallelism`` ranks
along ``model`` (Gemma's tensor parallelism) and the rest along ``data``. :func:`common_env_clean`
destroys the group.
"""

from __future__ import annotations

import dataclasses
import os
import random as _py_random

import numpy as np
import torch
import torch.distributed as dist

from iseg_tpu_torch.parallel.mesh import MeshEnv, create_mesh


@dataclasses.dataclass
class EnvConfig:
    random_seed: int = 0
    mixed_precision: bool = True  # bf16 compute, fp32 params
    device: str = "cuda"
    # data parallelism: one process a card, started by torchrun or a spawner
    initialize_distributed: bool = False
    coordinator_address: str | None = None  # "host:port"; else MASTER_ADDR:MASTER_PORT
    num_processes: int | None = None  # else WORLD_SIZE
    process_id: int | None = None  # else RANK
    backend: str | None = None  # else nccl on a card, gloo on the CPU
    init_method: str | None = None  # e.g. "file:///path/store"; overrides the coordinator
    # the number of devices; None is every process (it must be)
    num_devices: int | None = None
    model_parallelism: int = 1  # ranks along the mesh's model axis


@dataclasses.dataclass
class Env(MeshEnv):
    device: torch.device = None
    generator: torch.Generator = None  # CPU generator seeded with ``seed`` (for init)
    rank: int = 0
    world_size: int = 1

    def describe(self) -> str:
        return (f"device={self.device} rank={self.rank}/{self.world_size} "
                f"compute_dtype={self.compute_dtype} "
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


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is there. The port's entry points default to ``"cuda"`` and take the
    CPU only when the caller names it."""
    resolved = torch.device(device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not available "
                           '(pass device="cpu" to run on the CPU)')
    return resolved


def init_distributed(config: EnvConfig, device: torch.device) -> torch.device:
    """Start the default process group from ``config`` and the torchrun
    environment; returns this rank's device (``cuda:LOCAL_RANK`` on a
    card)."""
    world = config.num_processes
    if world is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = config.process_id
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a world of {world} processes")
    if config.num_devices is not None and config.num_devices != world:
        raise ValueError(f"num_devices={config.num_devices} but {world} processes: the port "
                         "runs one process a device")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = config.backend or ("nccl" if device.type == "cuda" else "gloo")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if backend == "nccl" and local_world > torch.cuda.device_count():
        raise RuntimeError(f"{local_world} NCCL ranks on this host but "
                           f"{torch.cuda.device_count()} cards: NCCL takes one card a rank")
    init_method = config.init_method
    if init_method is None:
        if config.coordinator_address is not None:
            init_method = f"tcp://{config.coordinator_address}"
        else:
            init_method = "env://"
    if not dist.is_initialized():
        kwargs = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, world_size=world,
                                rank=rank, **kwargs)
    return device


def common_env_setup(config: EnvConfig | None = None, **kwargs) -> Env:
    if config is None:
        config = EnvConfig(**kwargs)
    device = resolve_device(config.device)
    mesh = None
    if config.initialize_distributed:
        device = init_distributed(config, device)
        mesh = create_mesh(model_parallelism=config.model_parallelism,
                           device_type="cuda" if dist.get_backend() == "nccl" else "cpu")
    elif config.model_parallelism != 1:
        raise ValueError(f"model_parallelism={config.model_parallelism} needs a process group "
                         "(initialize_distributed=True), one process a device")
    set_random_seed(config.random_seed)
    # TF32 off: fp32 work stays full fp32, as in the JAX package's fp32 runs
    # (bf16 autocast work is unaffected either way)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Env(
        mesh=mesh,
        rank=dist.get_rank() if mesh is not None else 0,
        world_size=dist.get_world_size() if mesh is not None else 1,
        device=device,
        generator=torch.Generator().manual_seed(config.random_seed),
        seed=config.random_seed,
        compute_dtype=torch.bfloat16 if config.mixed_precision else torch.float32,
        param_dtype=torch.float32,
    )


def common_env_clean(env: Env | None = None) -> None:
    """Destroy the process group started by :func:`common_env_setup`
    (nothing without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
