"""Process / parallel environment (counterpart of
paddle_tpu/distributed/parallel.py).

One process per rank under ``torch.distributed``, PyTorch's idiom (the
reference runs one process per host over a jax mesh). `ParallelEnv`
reads paddle's launcher contract (``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ENDPOINTS``) and, where
that is unset, torchrun's (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``).

`init_parallel_env` opens the default process group: NCCL when each
rank has a card of its own (``cuda:LOCAL_RANK``), gloo on the CPU. A
caller may ask for gloo on cards (several ranks sharing one card, where
NCCL refuses two ranks on one GPU). The backend is never switched
behind the caller's back: an NCCL init that fails raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank",
           "get_world_size", "device"]

# the device init_parallel_env gave this rank (None before it ran)
_env_device = None


def _env_int(*names, default):
    for name in names:
        val = os.environ.get(name)
        if val not in (None, ""):
            return int(val)
    return default


class ParallelEnv:
    """The rank's place in the job, read from the environment."""

    def __init__(self):
        self._rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
        self._world_size = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE",
                                    default=1)
        self._device_id = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK",
                                   default=0)
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT",
                                                "")

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    # legacy names
    local_rank = rank
    nranks = world_size


def _init_method(env):
    """The rendezvous: ``PADDLE_MASTER`` (host:port), the first trainer
    endpoint, else torchrun's ``env://`` (MASTER_ADDR / MASTER_PORT)."""
    master = os.environ.get("PADDLE_MASTER") or (
        env.trainer_endpoints[0] if env.trainer_endpoints else None)
    return f"tcp://{master}" if master else "env://"


def init_parallel_env(backend=None, device=None, init_method=None,
                      rank=None, world_size=None):
    """Open the default process group (once) and return `ParallelEnv`.

    `device`: this rank's device, by default ``cuda:LOCAL_RANK``
    (raises without a GPU); ``"cpu"`` runs the rank on the CPU.
    `backend`: by default "nccl" on a card, "gloo" on the CPU; "gloo"
    on a card stages each collective's tensors through host memory
    (`collective`). `init_method`, `rank` and `world_size` override
    the environment (a ``file://`` store suits processes of one host).
    With a world of one and no explicit `init_method` nothing is
    opened: every collective is then the identity, as in the
    reference."""
    global _env_device
    env = ParallelEnv()
    if rank is not None:
        env._rank = int(rank)
    if world_size is not None:
        env._world_size = int(world_size)
    if device is None:
        dev = resolve_device(torch.device("cuda", env.device_id))
    else:
        dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {env.rank} wants {dev} but only "
                f"{torch.cuda.device_count()} card(s) are visible: NCCL "
                "needs a card of its own for every rank (ask for "
                "backend='gloo' to share one)")
        torch.cuda.set_device(dev)
    if not dist.is_initialized() and (env.world_size > 1 or
                                      init_method is not None):
        dist.init_process_group(
            backend, init_method=init_method or _init_method(env),
            rank=env.rank, world_size=env.world_size)
    _env_device = dev
    return env


def device():
    """This rank's device as `init_parallel_env` chose it (None before
    it ran)."""
    return _env_device


def get_rank(group=None):
    if group is not None:
        return group.rank
    if dist.is_initialized():
        return dist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
