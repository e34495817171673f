"""Multi-process plumbing: initialization, global meshes and the
replicated control plane.  The counterpart of
``titan_tpu/parallel/multihost.py``.

The deployment shape is the JAX module's: every process runs the same
control plane (scene construction, breakpoints, get / set), which must
stay deterministic; each process holds a contiguous run of the mesh's
shards, and the exchange layer (``comm.py``) moves halos, gathers and sums
between processes through ``torch.distributed``.  Consecutive blocks share
a process, so only the two blocks at each process boundary exchange their
halos across it.  The control plane's global state is every process's
own (each marshals the same scene); the chunks gather their results back
into it on every process.

Nothing on a machine tells a program of a cluster: ``initialize`` takes
the coordinator's address (``"localhost:<port>"``, or ``"tcp://..."``), the
process count and this process's rank.  Its default backend is gloo, whose
collectives carry CUDA tensors through host memory (``comm.py``); NCCL
cannot hold two ranks on one card.  In a single process every helper here
is a no-op.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..runtime.logging import get_logger
from .mesh import Mesh, make_mesh


def _dist():
    import torch.distributed as dist
    return dist


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, backend: str = "gloo") -> None:
    """Join (or bootstrap) a group of ``num_processes`` processes through
    ``torch.distributed.init_process_group`` (the JAX module's
    ``jax.distributed.initialize``).  ``coordinator_address`` is
    ``host:port`` of rank 0 (``tcp://`` may lead it).  A warning, and
    nothing else, where the group exists already.  ``local_device_ids``
    are the CUDA devices this process's shards default to in
    ``make_global_mesh``."""
    dist = _dist()
    global _LOCAL_DEVICE_IDS
    if dist.is_initialized():
        get_logger().warning(
            "titan_tpu_torch.parallel.multihost.initialize: process group "
            "already initialized (process %d of %d); ignoring",
            dist.get_rank(), dist.get_world_size())
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize: pass coordinator_address, "
                         "num_processes and process_id (nothing on the "
                         "machine names a cluster)")
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _LOCAL_DEVICE_IDS = (None if local_device_ids is None
                         else list(local_device_ids))
    get_logger().info("multihost: process %d/%d up (%s)", dist.get_rank(),
                      dist.get_world_size(), backend)


_LOCAL_DEVICE_IDS = None


def make_global_mesh(axis_names: Sequence[str] = ("shard",),
                     shape: Optional[Sequence[int]] = None,
                     devices=None) -> Mesh:
    """A mesh over every process's shards (``multihost.py:78-95``): this
    process's ``devices`` (default one shard on each CUDA device of
    ``initialize``'s ``local_device_ids``, else of every visible one) are
    contiguous along the axis, in rank order; every process must bring
    the same number.  In a single process, ``make_mesh``."""
    dist = _dist()
    if devices is None:
        ids = _LOCAL_DEVICE_IDS
        if ids is None:
            if not torch.cuda.is_available():
                raise RuntimeError("make_global_mesh: no CUDA device; pass "
                                   "devices=[torch.device('cpu')] * L")
            ids = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in ids]
    devices = list(devices)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return make_mesh(axis_names, shape, devices)
    world, rank = dist.get_world_size(), dist.get_rank()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([len(devices)], dtype=torch.int64))
    if len({int(c) for c in counts}) != 1:
        raise ValueError(f"make_global_mesh: processes bring "
                         f"{[int(c) for c in counts]} shards; every process "
                         "must bring the same number")
    n_all = world * len(devices)
    if shape is not None and int(np.prod(shape)) != n_all:
        raise ValueError(f"mesh shape {tuple(shape)} != {n_all} global "
                         "shards")
    return Mesh(devices, axis_names, n_shards=n_all,
                first=rank * len(devices), group=dist.group.WORLD)


def host_gather(x, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Every process's ``x`` concatenated along axis 0, as a host array
    (``process_allgather(..., tiled=True)``); in a single process ``x``
    itself."""
    t = torch.as_tensor(x)
    if process_count() == 1:
        return t.detach().cpu().numpy()
    dist = _dist()
    h = t.detach().cpu().contiguous()
    parts = [torch.empty_like(h) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, h, group=None if mesh is None else mesh.group)
    return torch.cat(parts, dim=0).numpy()


def assert_replicated_control_plane(value: float, name: str = "value"):
    """Raise where the processes' control planes disagree on ``value`` (a
    breakpoint time, an edit's payload): the replicated-host-code
    invariant (``multihost.py:112-123``).  A no-op in a single process."""
    if process_count() == 1:
        return
    vals = host_gather(np.asarray([value], dtype=np.float64))
    if not np.allclose(vals, vals[0]):
        raise RuntimeError(
            f"control-plane divergence: {name} differs across hosts: "
            f"{vals.ravel().tolist()}")
