"""Multi-process initialization; port of ``mmtrl_tpu/core/distributed.py``.

The JAX package joins the hosts of a TPU pod into one runtime with
``jax.distributed.initialize``.  The port starts a ``torch.distributed``
process group instead, from the same environment variables:

- ``MMTRL_COORDINATOR`` (``host:port`` of rank 0), ``MMTRL_NUM_PROCESSES``
  and ``MMTRL_PROCESS_ID`` give a TCP rendezvous;
- otherwise a ``WORLD_SIZE`` above 1, as ``torchrun`` sets it, takes the
  ``env://`` rendezvous (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``), in
  place of JAX's TPU-pod auto-detection (``TPU_WORKER_HOSTNAMES``).

The backend is ``nccl`` when the run's device is CUDA and ``gloo`` on the
CPU.  With neither variable set the call does nothing and returns False,
so single-process runs are unaffected.  A failed start prints
``multi-host init skipped: <error>`` and returns False, as JAX's does.

The runners (``algos/ppo/runner.py``, ``algos/offpolicy/runner.py``) call
it when a run starts; JAX's call it when they are imported.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from mmtrl_tpu_torch import DeviceLike


def maybe_initialize_distributed(device: DeviceLike = None) -> bool:
    """Returns True if a process group is running after the call.
    ``device`` is the run's device: ``None`` or CUDA takes ``nccl`` and
    binds this process to ``LOCAL_RANK`` (else its rank) modulo the visible
    cards, the CPU takes ``gloo``."""
    if dist.is_initialized():
        return True
    coordinator = os.environ.get("MMTRL_COORDINATOR", "")
    num_processes = os.environ.get("MMTRL_NUM_PROCESSES", "")
    process_id = os.environ.get("MMTRL_PROCESS_ID", "")
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    try:
        if coordinator:
            rank, world = int(process_id), int(num_processes)
            init = dict(init_method=f"tcp://{coordinator}", rank=rank, world_size=world)
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            rank = int(os.environ["RANK"])
            init = dict(init_method="env://")
        else:
            return False
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                                  % torch.cuda.device_count())
        dist.init_process_group("nccl" if cuda else "gloo", **init)
        return True
    except Exception as exc:  # environment dependent, as in JAX
        print(f"multi-host init skipped: {exc}")
    return False
