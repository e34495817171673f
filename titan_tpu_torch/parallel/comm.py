"""The exchange layer between shards: the port's counterpart of
``jax.lax.ppermute``, ``all_gather`` and ``psum`` inside ``shard_map``.

The multi-device modules (``halo.py``, ``halo_tiled.py``,
``halo_adjoint.py``, ``sharded.py``) move data between shards through these
functions and nothing else.  Each takes the mesh and this process's shards'
tensors as a list, in axis order.

- Within one process each operation is a copy from one shard's tensor to
  another's device: nothing at all where both shards are on one device (a
  slice or a view), a peer copy between two cards, made under the
  destination's device on its current stream.  Every operation is then
  plain PyTorch, which autograd differentiates: the gather's transpose is
  the per-shard slice of the cotangent, by itself.
- Between processes (``mesh.group`` set, ``multihost.make_global_mesh``)
  each is a collective of ``torch.distributed`` over that group; the
  gather goes through ``torch.distributed.nn.functional.all_gather``, so
  autograd sees it.  A gloo group has no CUDA transport, so CUDA tensors
  are staged through host memory.  The ring's edges travel as one
  all-gather of each process's two outer edges (a few rows a shard),
  which a two-process ring needs anyway.

Only a shard on the ring's ends exchanges across the global wrap; what it
receives there is the other end of the scene, and the callers mask it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .mesh import Mesh


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: itself where it lives there, else a copy made
    under ``dev`` (a peer copy on ``dev``'s current stream between cards)."""
    if x.device == dev:
        return x
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return x.to(dev, non_blocking=True)
    return x.to(dev)


def _gather_processes(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``x`` (same shape everywhere), in rank order, on
    ``x``'s device, through ``torch.distributed.nn.functional.all_gather``
    (autograd's form: its backward sums each process's cotangent back to
    it), staged through host memory for gloo."""
    import warnings

    from torch.distributed.nn.functional import all_gather as ag
    staged = x.to("cpu") if x.device.type == "cuda" else x
    with warnings.catch_warnings():
        # newer releases announce a successor; this one is autograd's
        warnings.simplefilter("ignore", FutureWarning)
        parts = ag(staged.contiguous(), group=mesh.group)
    return [p.to(x.device) for p in parts]


def ring_edges(mesh: Mesh, blocks: Sequence[torch.Tensor], w: int):
    """(from_prev, from_next): for each local shard i, the last ``w``
    entries along the last axis of shard i - 1's block and the first ``w``
    of shard i + 1's, on shard i's device (the ring wraps).  Two
    ``ppermute``s of ``titan_tpu/parallel/halo.py:166-170``."""
    n = len(blocks)
    tails = [b[..., b.shape[-1] - w:] for b in blocks]
    heads = [b[..., :w] for b in blocks]
    if mesh.multiprocess:
        import torch.distributed as dist
        rank, world = dist.get_rank(mesh.group), dist.get_world_size(
            mesh.group)
        both = _gather_processes(mesh, torch.stack([heads[0], tails[-1]]))
        prev_tail = both[(rank - 1) % world][1]
        next_head = both[(rank + 1) % world][0]
    else:
        prev_tail, next_head = tails[-1], heads[0]
    from_prev = [_to(tails[i - 1] if i > 0 else prev_tail, blocks[i].device)
                 for i in range(n)]
    from_next = [_to(heads[i + 1] if i + 1 < n else next_head,
                     blocks[i].device) for i in range(n)]
    return from_prev, from_next


def halo_extend(mesh: Mesh, blocks: Sequence[torch.Tensor], w: int):
    """Each local block [..., B] as a window [..., w + B + w] with both ring
    neighbours' edges (``halo.py::halo_extend``)."""
    prev, nxt = ring_edges(mesh, blocks, w)
    return [torch.cat([p, b, q], dim=-1) for p, b, q in zip(prev, blocks,
                                                               nxt)]


def fill_halos(mesh: Mesh, windows: Sequence[torch.Tensor], hw: int,
               b: int) -> None:
    """In place: each window's halos [..., hw + b + hw] get the ring
    neighbours' ``hw`` centre edges, the window's centre [hw, hw + b)
    staying as it is.  The halo exchange of a state held in window layout;
    no centre is copied."""
    centres = [x[..., hw:hw + b] for x in windows]
    prev, nxt = ring_edges(mesh, centres, hw)
    for x, p, q in zip(windows, prev, nxt):
        x[..., :hw].copy_(p)
        x[..., hw + b:].copy_(q)


def all_gather(mesh: Mesh, blocks: Sequence[torch.Tensor],
               device: torch.device = None) -> torch.Tensor:
    """Every shard's block concatenated along the last axis in axis order
    (``jax.lax.all_gather(..., tiled=True)``), on ``device`` (default the
    mesh's home).  Differentiable: in one process autograd transposes it
    into per-shard slices; between processes through
    ``torch.distributed.nn.functional.all_gather``."""
    dev = mesh.home if device is None else device
    local = torch.cat([_to(b, dev) for b in blocks], dim=-1)
    if not mesh.multiprocess:
        return local
    return torch.cat(_gather_processes(mesh, local), dim=-1)


def local_rows(mesh: Mesh, full: torch.Tensor, b: int) -> List[torch.Tensor]:
    """Each local shard's rows [i b, (i + 1) b) of a gathered tensor
    [..., D b], on its device: the per-shard side of ``all_gather``."""
    return [_to(full[..., i * b:(i + 1) * b], dev)
            for i, dev in zip(mesh.local, mesh.local_devices)]


def psum(mesh: Mesh, values: Sequence[torch.Tensor],
         device: torch.device = None) -> torch.Tensor:
    """The sum over every shard of ``values`` (one per local shard), on
    ``device`` (default the home), summed in axis order
    (``jax.lax.psum``), so that the rounding is the same however the
    shards are split over processes."""
    dev = mesh.home if device is None else device
    vals = [_to(v, dev) for v in values]
    if mesh.multiprocess:
        vals = [v for p in _gather_processes(mesh, torch.stack(vals))
                for v in p]
    total = vals[0]
    for v in vals[1:]:
        total = total + v
    return total
