"""The process group of a sharded solve — the counterpart of
`repro.launch.mesh` for `torch.distributed`.

Functions only: importing this module touches no device and no process
group.
"""
from __future__ import annotations

import os


def make_local_group(backend: str = "gloo"):
    """The default process group of this job, initialized from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``; ``LOCAL_RANK`` picks the card under NCCL) on
    `backend`: ``"nccl"`` where each rank has its own card, ``"gloo"``
    otherwise (the CPU, or several ranks on one card).  A group already
    initialized is returned as it is."""
    import torch
    import torch.distributed as dist
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend=backend, init_method="env://")
    return dist.group.WORLD
