"""A scene's state split into shards along the mass axis, and the sharded
catch-all route: the counterpart of ``titan_tpu/parallel/sharded.py``.

Placement (``titan_tpu/parallel/halo.py::place``, by field role, not by
size): the mass-indexed arrays (``masses``, ``stencil``'s [F, N] planes,
``lcon``'s per-mass slots and ``topo``'s incidence rows) are cut into
contiguous blocks of B masses, shard i holding masses [i B, (i + 1) B);
everything else (the remainder springs, the global constraints, t, dt, g)
is replicated on every shard.  Where D does not divide the mass count, or a
route wants blocks of at least its halo, the mass axis is padded at its end
with inert rows (invalid, frozen, mass 1, no springs), so that every block
stays a contiguous global slice and stencil neighbours cross block
boundaries intact.

``DistributedChunk`` is what ``Simulation.distribute`` installs:
``chunk(state, n_steps)`` takes and returns the control plane's global
state.  It places the state into shards (reusing the shards of the state it
returned last, so that a run of chunks places once), runs the route's
sharded chunk, and gathers the result back: the readback of
``titan_tpu``'s sharded arrays, made once a chunk.  Only the fields a chunk
changes (pos, vel, acc, T, t, and the rests it advances) are gathered; the
rest of the returned state is the input's.

The catch-all route (``build_sharded_chunk``).  JAX jits the unmodified
step over the sharded state and lets XLA's SPMD partitioner place the work
and insert the collectives.  PyTorch has no such partitioner, so here the
route gathers the state onto the home device, runs the single-device chunk
(``ops/step.py::build_chunk_fn``, the route ``chunk_route`` picks there),
and scatters the result back: correct for every scene, and no faster than
one device.  ``Simulation._place_distributed`` warns when a scene lands
here, as the JAX package warns.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from ..state import SceneShape, SimState
from . import comm
from .mesh import Mesh

_TOPO_REPLICATED = ("seg_perm", "seg_ids")


def _mass_dim(group: str, name: str, x: torch.Tensor):
    """The mass axis of leaf ``group.name`` (``masses`` [3, N] or [N]: the
    last; ``stencil`` [F, N]; ``lcon`` [N, ...]; ``topo``'s incidence rows
    [N, D]), or None where it is replicated."""
    if group == "masses":
        return x.dim() - 1
    if group == "stencil":
        return 1
    if group == "lcon":
        return 0
    if group == "topo" and name not in _TOPO_REPLICATED:
        return 0
    return None


def map_state(state: SimState, mass_fn: Callable,
              rep_fn: Callable) -> SimState:
    """``state`` with ``mass_fn(x, dim)`` applied to each mass-indexed leaf
    (``dim`` its mass axis) and ``rep_fn(x)`` to every other leaf."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = rep_fn(v)
        else:
            sub = {}
            for g in dataclasses.fields(v):
                x = getattr(v, g.name)
                d = _mass_dim(f.name, g.name, x)
                sub[g.name] = rep_fn(x) if d is None else mass_fn(x, d)
            out[f.name] = dataclasses.replace(v, **sub)
    return dataclasses.replace(state, **out)


def block_size(n: int, n_shards: int, at_least: int = 1) -> int:
    """Masses a shard holds: ceil(n / D), and at least ``at_least``."""
    return max(-(-n // n_shards), at_least)


def pad_state(state: SimState, n_new: int) -> SimState:
    """``state`` with its mass axis padded to ``n_new`` by inert rows:
    invalid, frozen (so never moved), mass 1, no stencil spring, no local
    slot.  ``n_new`` equal to the mass count returns ``state``."""
    n = state.masses.valid.shape[-1]
    if n_new == n:
        return state

    def pad(x, d):
        shape = list(x.shape)
        shape[d] = n_new - n
        fill = torch.zeros(shape, dtype=x.dtype, device=x.device)
        return torch.cat([x, fill], dim=d)

    state = map_state(state, pad, lambda x: x)
    m = state.masses
    ones = torch.ones(n_new - n, dtype=m.m.dtype, device=m.m.device)
    fixed = m.fixed.clone()
    fixed[n:] = True
    return dataclasses.replace(state, masses=dataclasses.replace(
        m, m=torch.cat([m.m[:n], ones]), fixed=fixed))


def shard_state(state: SimState, mesh: Mesh, axis: str = "shard",
                b: int = None) -> List[SimState]:
    """This process's shards of ``state`` (mass count a multiple of the
    block ``b``, default N / D): block i's slice of every mass-indexed leaf
    and a copy of every other leaf, on shard i's device."""
    n = state.masses.valid.shape[-1]
    d_all = mesh.shape[axis]
    b = n // d_all if b is None else b
    if b * d_all != n:
        raise ValueError(f"shard_state: {n} masses are not {d_all} blocks "
                         f"of {b}; pad_state first")
    out = []
    for i, dev in zip(mesh.local, mesh.local_devices):
        out.append(map_state(
            state,
            lambda x, d, i=i, dev=dev: comm._to(
                x.narrow(d, i * b, b), dev),
            lambda x, dev=dev: comm._to(x, dev)))
    return out


def gather_leaf(mesh: Mesh, blocks, dim: int) -> torch.Tensor:
    """One mass-indexed leaf's shards, gathered along its mass axis onto
    the home device."""
    moved = [x.movedim(dim, -1) for x in blocks]
    return comm.all_gather(mesh, moved).movedim(-1, dim)


def gather_state(mesh: Mesh, shards: List[SimState],
                 like: SimState = None, fields=None) -> SimState:
    """The global state from this process's shards, on the home device.
    With ``like`` (the global state the shards were placed from) and
    ``fields`` (``(group, name)`` pairs, e.g. ``("masses", "pos")``), only
    those leaves are gathered and the rest are ``like``'s; t comes from
    shard 0 either way."""
    first = shards[0]
    if like is None:
        return _gather_all(mesh, shards)
    out = like
    by_group = {}
    for group, name in fields or ():
        by_group.setdefault(group, []).append(name)
    for group, names in by_group.items():
        src = getattr(like, group)
        upd = {}
        for name in names:
            x = getattr(src, name)
            d = _mass_dim(group, name, x)
            leaves = [getattr(getattr(s, group), name) for s in shards]
            upd[name] = (comm._to(leaves[0], mesh.home) if d is None
                         else gather_leaf(mesh, leaves, d))
        out = dataclasses.replace(out, **{
            group: dataclasses.replace(src, **upd)})
    return dataclasses.replace(out, t=comm._to(first.t, mesh.home))


def _gather_all(mesh: Mesh, shards: List[SimState]) -> SimState:
    """Every leaf of the global state from the shards."""
    first = shards[0]
    out = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = comm._to(v, mesh.home)
            continue
        sub = {}
        for g in dataclasses.fields(v):
            x = getattr(v, g.name)
            d = _mass_dim(f.name, g.name, x)
            sub[g.name] = (comm._to(x, mesh.home) if d is None else
                           gather_leaf(mesh, [getattr(getattr(s, f.name),
                                                      g.name)
                                              for s in shards], d))
        out[f.name] = dataclasses.replace(v, **sub)
    return dataclasses.replace(first, **out)


def unpad_state(state: SimState, n: int) -> SimState:
    """The first ``n`` masses of every mass-indexed leaf of a state, some
    of whose leaves may be padded (``pad_state``'s inverse)."""
    return map_state(state, lambda x, d: x if x.shape[d] == n
                     else x.narrow(d, 0, n), lambda x: x)


def chunk_fields(shape: SceneShape) -> tuple:
    """The leaves a chunk of ``shape`` changes, which ``DistributedChunk``
    gathers back: pos, vel, acc, T; the rests where springs breathe or
    actuate; the external force in strict per-step mode (it is zeroed
    after each step)."""
    out = [("masses", "pos"), ("masses", "vel"), ("masses", "acc"),
           ("masses", "T")]
    if shape.has_breathing:
        out.append(("stencil", "rest"))
        if shape.has_remainder:
            out.append(("springs", "rest"))
    if not shape.config.persistent_extern_force:
        out.append(("masses", "extern_force"))
    return tuple(out)


class DistributedChunk:
    """``chunk(state, n_steps)`` over a mesh for the control plane: the
    global state in, the global state out (module docstring); it keeps
    the shards of the state it returned last, for the next call.  ``run(shards,
    n_steps) -> shards`` is the route's chunk on this process's shards of
    the padded state (``n_dist`` masses, blocks of ``b``).  ``route`` names
    it: "halo_tiled", "halo" or "sharded"."""

    def __init__(self, route: str, shape: SceneShape, mesh: Mesh, axis: str,
                 b: int, run: Callable):
        self.route, self.mesh, self.axis, self.b = route, mesh, axis, b
        self.run = run
        self.fields = chunk_fields(shape)
        self._last = None        # (the global state returned, its shards)

    def __call__(self, state: SimState, n_steps) -> SimState:
        n_steps = int(n_steps)
        if n_steps <= 0:
            return state
        if self._last is not None and self._last[0] is state:
            shards = self._last[1]
        else:
            n_dist = self.b * self.mesh.shape[self.axis]
            shards = shard_state(pad_state(state, n_dist), self.mesh,
                                 self.axis, self.b)
        shards = self.run(shards, n_steps)
        out = unpad_state(gather_state(self.mesh, shards, like=state,
                                       fields=self.fields),
                          state.masses.valid.shape[-1])
        self._last = (out, shards)
        return out


def build_sharded_chunk(shape: SceneShape, mesh: Mesh, axis: str = "shard"):
    """``run(shards, n_steps) -> shards`` of the catch-all route (module
    docstring): gather, the single-device chunk on the home device,
    scatter."""
    from ..ops.step import build_chunk_fn
    chunk = build_chunk_fn(shape)

    def run(shards: List[SimState], n_steps: int) -> List[SimState]:
        full = _gather_all(mesh, shards)
        out = chunk(full, n_steps)
        b = shards[0].masses.valid.shape[-1]
        return shard_state(out, mesh, axis, b)
    return run
