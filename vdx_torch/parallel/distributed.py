"""Multi-process initialisation and the liveness probe (port of
vdx/parallel/distributed.py).

  * :func:`initialize` — ``torch.distributed`` bring-up from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    a no-op for a single process started without torchrun
  * :func:`health_check` — an all_reduce of ones across every rank under
    the group's timeout; returns the world size

Recovery is vdx's: a failed rank makes the collectives of the others
raise at the group's timeout, the job restarts, and completed experiments
are skipped by their config.json commit markers.

    # on a machine with N cards:
    #   torchrun --nproc-per-node N script.py
    from vdx_torch.parallel.distributed import initialize
    initialize()                 # NCCL, one card per rank
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               *, device: str = "cuda",
               timeout: Optional[datetime.timedelta] = None) -> bool:
    """Initialise the default process group; returns whether it did.

    Every argument defaults from torchrun's environment. Without an
    ``init_method``, a ``world_size`` above one or torchrun's MASTER_ADDR,
    this is a single process and nothing happens. The backend is NCCL,
    with this rank on card LOCAL_RANK, unless ``device`` is "cpu" (then
    gloo). ``timeout`` bounds every collective of the group (the
    backend's default when None)."""
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    world_size = world_size if world_size is not None else env_world
    if (init_method is None and world_size == 1
            and "MASTER_ADDR" not in os.environ):
        return False
    if dist.is_initialized():
        return False
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    backend = "gloo" if device == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    return True


def health_check() -> int:
    """All-rank liveness probe: the sum of one from every rank, on the
    backend's device; returns the world size (1 without a process group).
    A dead rank makes it raise at the group's timeout instead of hanging."""
    if not dist.is_initialized():
        return 1
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    ones = torch.ones(1, device=dev)
    dist.all_reduce(ones)
    total, n = int(ones.item()), dist.get_world_size()
    if total != n:
        raise RuntimeError(f"health_check: {total} of {n} ranks answered")
    return total
