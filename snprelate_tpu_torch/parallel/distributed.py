"""Multi-process start-up (the JAX package's parallel/distributed.py) on
``torch.distributed``.

Each process runs the same program. ``init_distributed`` joins them into
one process group, and ``global_mesh`` builds the (data, samp) mesh whose
data axis spans every process's devices, so the sharded engines
(``parallel/mesh.py``, sharded randomized PCA, the mesh loadings) sum
their per-process partials with one all-reduce per analysis.

The backend follows the device rule: NCCL for the card, gloo for
``device="cpu"``. NCCL refuses two ranks on one GPU; gloo does not (and
takes CUDA tensors), which is how one card runs a two-process mesh.
"""

from __future__ import annotations

from typing import Optional

import torch


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     backend: Optional[str] = None, store=None,
                     timeout_s: float = 1800.0) -> None:
    """Join this process to the default process group (a no-op at one
    process, as in the JAX package). coordinator_address: an init method
    ("tcp://host:port" or "file:///path"); or ``store``, a
    ``torch.distributed`` store (a ``FileStore`` in a shared directory
    needs no port). backend: default NCCL for a CUDA ``device`` (None =
    the card), gloo for "cpu"."""
    import datetime

    import torch.distributed as dist

    if num_processes is not None and num_processes <= 1:
        return
    if backend is None:
        dev = torch.device("cuda" if device is None else device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"backend": backend,
          "timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        kw["store"] = store
    elif coordinator_address is not None:
        kw["init_method"] = coordinator_address
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(**kw)


def global_mesh(n_samp_axis: int = 1, devices=None, group=None):
    """A (data, samp) mesh over every process's devices: this process's
    ``devices`` (default: its CUDA devices) as (len / n_samp_axis,
    n_samp_axis), its data axis extended over the ranks of ``group``
    (default: the default process group, when one is initialized). Every
    rank must pass the same number of devices."""
    import torch.distributed as dist

    from .mesh import make_mesh

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=['cpu', ...] for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) % n_samp_axis:
        raise ValueError(f"{len(devices)} devices not divisible by "
                         f"samp axis {n_samp_axis}")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return make_mesh(len(devices) // n_samp_axis, n_samp_axis,
                     devices=devices, group=group)
