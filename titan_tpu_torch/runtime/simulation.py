"""The simulation control plane: the reference's ``titan::Simulation`` API
(sim.h:38-122), ported from ``titan_tpu/runtime/simulation.py``.

- A single worker thread advances the scene in *chunks* of steps (one call
  of the chunk function from ``ops/step.py``: on the card, one host call
  that enqueues a kernel launch per step).  The host sleeps on condition
  variables, not busy-waits.
- State lives on the device as an immutable snapshot per chunk boundary:
  every chunk returns fresh tensors, so ``getAll()`` from any thread reads a
  consistent snapshot that no later step overwrites.
- Breakpoints are a heap of stop times; the worker sizes each chunk to land
  exactly on the next one, so ``wait/pause`` observe exact, reproducible
  times.  A breakpoint inserted while a chunk is in flight takes effect at
  the next chunk boundary.

- Structural edits made at a pause are journaled and applied at resume by
  row-level surgery on the device state where the JAX package applies them
  so, else by a full re-marshal (``runtime/incremental.py``).
- ``distribute(mesh)`` runs the scene block-sharded over the shards of a
  mesh (``parallel/``): the control plane keeps the global state it reads
  and writes, and each chunk places it into the shards, steps them on the
  route ``_place_distributed`` picks, and gathers the result back
  (``parallel/sharded.py::DistributedChunk``).  A feature flip, a
  uniform-breaking push or a topology edit re-picks the distributed chunk
  for the new shape, where the JAX package re-marshals and re-places its
  sharded state (its ``simulation.py:1159``, :1214, :1284,
  ``incremental.py:419-425``): here the state the pushes write is global,
  and the next chunk places it afresh.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import builders
from ..config import (ACTUATED_CONTRACT, ACTUATED_EXPAND, PASSIVE_SOFT,
                      PASSIVE_STIFF, ScatterMode, SimConfig, torch_device)
from ..containers import Beam, Container, Cube, Lattice, RobotLink
from ..entities import HandleSeq, Mass, Spring
from ..ops.step import build_chunk_fn
from ..state import (GlobalConstraints, LocalConstraints, MassState,
                     SceneShape, SimState, SpringState, StencilState,
                     Topology, pad_to)
from ..store import HostStore
from ..vec import Vec
from .incremental import EditJournal, apply_structural_edits
from .logging import get_logger

# chunk-function cache: one chunk fn per static scene shape
_CHUNK_CACHE: Dict[SceneShape, object] = {}
# distributed chunk cache: one per (shape, mesh, axis, route, env hook)
_DIST_CHUNK_CACHE: Dict[tuple, object] = {}

_UNIFORM_FIELDS = ("k", "rest", "damping", "type", "omega")


class SimulationDivergedError(RuntimeError):
    """Raised (check_finite=True) when the state contains NaN/Inf."""


def _chunk_for(shape: SceneShape):
    fn = _CHUNK_CACHE.get(shape)
    if fn is None:
        fn = build_chunk_fn(shape)
        _CHUNK_CACHE[shape] = fn
    return fn


def _dist_chunk_for(shape: SceneShape, mesh, axis: str, kind: str):
    """The distributed chunk of route ``kind`` ("halo_tiled", "halo" or
    "sharded") for ``shape`` over ``mesh``, one per (shape, mesh, axis,
    route, ``TITAN_DIST_MEGA``) (``simulation.py:120-145``), so that an
    edit that keeps the shape keeps the chunk.  Simulations may share one:
    the shards it keeps are reused only for the very state it returned."""
    import os

    from ..parallel import halo, halo_tiled, sharded
    key = (shape, mesh, axis, kind, os.environ.get("TITAN_DIST_MEGA", ""))
    chunk = _DIST_CHUNK_CACHE.get(key)
    if chunk is not None:
        return chunk
    n = shape.n_masses
    d_all = mesh.shape[axis]
    if kind == "halo_tiled":
        run = halo_tiled.build_halo_tiled_chunk(shape, mesh, axis)
        b = run.b
    elif kind == "halo":
        run, b = halo.build_halo_chunk(shape, mesh, axis), n // d_all
    else:
        run = sharded.build_sharded_chunk(shape, mesh, axis)
        b = sharded.block_size(n, d_all)
    chunk = sharded.DistributedChunk(kind, shape, mesh, axis, b, run)
    _DIST_CHUNK_CACHE[key] = chunk
    return chunk


class Simulation:
    """Mass-spring simulation with the reference's control API, on the
    device named by ``config.device`` (the card by default)."""

    def __init__(self, config: Optional[SimConfig] = None):
        self.config = config or SimConfig()
        self._device = torch_device(self.config.device)
        self._store = HostStore(dtype=self.config.host_store_dtype)
        self.containers = []
        self._planes = []  # (unit normal [3], offset, fk, fs)
        self._balls = []   # (center [3], radius)
        self._dt = 0.0001                       # reference default, sim.cu:78
        self._global_acc = np.array([0.0, 0.0, -9.81])  # sim.cu:86
        self._T = 0.0
        self._bpts = []
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._running = False
        self._started = False
        self._ended = False
        self._structure_dirty = False
        self._gen = 0        # compaction generation (see entities handles)
        self._remaps = []    # per generation: (mass old->new, spring old->new)
        self._state: Optional[SimState] = None
        self._diverged_at: Optional[float] = None
        self._shape: Optional[SceneShape] = None
        # incremental topology-edit bookkeeping (runtime/incremental.py):
        # the paused-time edit journal and marshal-time placement mirrors
        self._journal: Optional[EditJournal] = None
        self._n_marshaled = 0      # device-resident real mass rows
        self._s_marshaled = 0      # springs covered by _sp_family/_sp_slot
        self._rem_count = 0        # live remainder spring count
        self._rem_left = np.zeros(0, np.int64)   # remainder slot -> endpoint
        self._rem_right = np.zeros(0, np.int64)
        self._st_mask = np.zeros((0, 0), bool)   # host stencil-mask mirror
        self._fam_scalars = {}     # uniform-field family scalars (or None)
        # (state, CUDA event recorded at the end of the chunk that made it):
        # runtime/live.LiveViewer copies that state on a side stream
        self._state_ready = None
        self._chunk = None
        self._mesh = None                    # set by distribute()
        self._mesh_axis = "shard"
        self._rate: Optional[float] = None   # measured steps/s of _chunk
        self._timed_chunks = 0               # dispatches since _chunk built
        self._worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ guards
    def _check_not_ended(self, msg="Cannot modify simulation after the end of the simulation."):
        if self._ended:
            raise RuntimeError("The simulation has ended. " + msg)

    def _check_can_edit(self):
        self._check_not_ended()
        if self._started and self._running:
            raise RuntimeError("The simulation is running. Stop the simulation to make changes.")

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        """Host array -> device tensor (config dtype for floats)."""
        a = np.asarray(a)
        if dtype is None and a.dtype.kind == "f":
            a = a.astype(self.config.np_dtype)
        return torch.from_numpy(np.array(a, order="C")).to(self._device)

    # ------------------------------------------------------------ entity lists
    @property
    def masses(self):
        return HandleSeq(self, Mass, lambda: self._store.n_masses)

    @property
    def springs(self):
        return HandleSeq(self, Spring, lambda: self._store.n_springs)

    def getMassByIndex(self, i: int) -> Mass:
        assert 0 <= i < self._store.n_masses
        return Mass(self, i)

    def getSpringByIndex(self, i: int) -> Spring:
        assert 0 <= i < self._store.n_springs
        return Spring(self, i)

    def getContainerByIndex(self, i: int) -> Container:
        return self.containers[i]

    # ------------------------------------------------------------------ create
    def createMass(self, pos=None) -> Mass:
        """Reference sim.cu:274-290.  No-arg form uses the default Mass()
        (m = 1.0, origin, mass.cu:8-19); positional form Mass(pos) (m = 0.1,
        mass.h:18)."""
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        if pos is None:
            i = self._store.add_mass((0.0, 0.0, 0.0), m=1.0)
        else:
            i = self._store.add_mass(_np3(pos), m=0.1)
        self._mark_dirty()
        return Mass(self, i)

    def createSpring(self, m1: Optional[Mass] = None,
                     m2: Optional[Mass] = None) -> Spring:
        """Reference sim.cu:325-345; two-mass form sets rest = distance."""
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        if m1 is None or m2 is None:
            i = self._store.add_spring()
        else:
            # rest = CURRENT endpoint distance: refresh just those two rows
            # from the device (the store may be stale while paused)
            if self._started:
                self._refresh_mass_rows(
                    np.array([m1._i, m2._i]),
                    skip=self._journal.m_written if self._journal else None)
            d = self._store.pos[m2._i] - self._store.pos[m1._i]
            rest = math.sqrt(float(np.dot(d, d)))
            i = self._store.add_spring(m1._i, m2._i, k=10000.0, rest=rest)
        self._mark_dirty()
        return Spring(self, i)

    # ------------------------------------------------------------------ delete
    def deleteMass(self, m: Mass) -> None:
        """Soft delete (reference valid flag, mass.h:120); springs with an
        invalid endpoint exert no force (sim.cu:1163)."""
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        self._store.valid[m._i] = False
        self._touch_mass(m._i)
        self._mark_dirty()

    def deleteSpring(self, s: Spring) -> None:
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        self._store.s_valid[s._i] = False
        self._touch_spring(s._i)
        self._mark_dirty()

    def deleteContainer(self, c: Container) -> None:
        """Reference sim.cu:416-564 (bulk invalidate + compaction)."""
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        self._store.valid[c._mass_idx] = False
        self._store.s_valid[c._spring_idx] = False
        self._touch_mass(c._mass_idx)
        self._touch_spring(c._spring_idx)
        if c in self.containers:
            self.containers.remove(c)
        self._mark_dirty()

    # -------------------------------------------------------------- containers
    def createContainer(self) -> Container:
        self._check_not_ended("New objects cannot be created.")
        c = Container(self)
        self.containers.append(c)
        return c

    def _register_built(self, c: Container) -> Container:
        self._mark_dirty()
        # per-container default palette: host-side graphics data only
        if len(c._mass_idx):
            rows = c._mass_idx
            col = self._store.color[rows]
            untouched = np.all(col == np.asarray(HostStore.DEFAULT_COLOR),
                               axis=1)
            if untouched.any():
                self._store.color[rows[untouched]] = _CONTAINER_PALETTE[
                    len(self.containers) % len(_CONTAINER_PALETTE)]
        self.containers.append(c)
        return c

    def createCube(self, center, side_length: float = 1.0) -> Cube:
        self._check_not_ended("New objects cannot be created.")
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        return self._register_built(Cube(self, center, side_length))

    def createLattice(self, center, dims, nx: int = 10, ny: int = 10,
                      nz: int = 10) -> Lattice:
        self._check_not_ended("New objects cannot be created.")
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        return self._register_built(Lattice(self, center, dims, nx, ny, nz))

    def createBeam(self, center, dims, nx: int = 10, ny: int = 10,
                   nz: int = 10) -> Beam:
        self._check_not_ended("New objects cannot be created.")
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        return self._register_built(Beam(self, center, dims, nx, ny, nz))

    def createRobotLink(self, pos1, pos2, mass: float, max_exp_length: float,
                        min_exp_length: float, expansion_rate: float,
                        k: float, magnetic_force: float,
                        radius: float = 0.015) -> RobotLink:
        """A magnet truss actuator: two magnetic masses joined by one
        actuated spring (reference object.h:290-330)."""
        self._check_not_ended("New objects cannot be created.")
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        return self._register_built(RobotLink(
            self, pos1, pos2, mass, max_exp_length, min_exp_length,
            expansion_rate, k, magnetic_force, radius))

    def importFromSTL(self, path: str, density: float = 10.0,
                      num_rays: int = 5) -> Container:
        """Reference sim.cu:2085-2151; implementation in ``stl.py``."""
        self._check_not_ended("Cannot import new STL objects")
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        from ..stl import import_from_stl
        return self._register_built(import_from_stl(self, path, density,
                                                    num_rays))

    # ------------------------------------------------------- global constraints
    def createPlane(self, abc, d: float, friction_k: float = 0.0,
                    friction_s: float = 0.0) -> None:
        """Half-space constraint ax+by+cz < d (reference sim.cu:2251-2276);
        the friction overload's order is (K, S) (sim.h:64)."""
        self._check_not_ended("New objects cannot be created.")
        n = _np3(abc)
        n = n / math.sqrt(float(np.dot(n, n)))
        self._planes.append((n, float(d), float(friction_k), float(friction_s)))
        self._mark_dirty(gcon=True)

    def createBall(self, center, r: float) -> None:
        """Reference sim.cu:2278-2288."""
        self._check_not_ended("New constraints cannot be added.")
        self._balls.append((_np3(center), float(r)))
        self._mark_dirty(gcon=True)

    def clearConstraints(self) -> None:
        """Clears global constraints only (reference sim.cu:2290-2293)."""
        self._planes.clear()
        self._balls.clear()
        self._mark_dirty(gcon=True)

    # ------------------------------------------------------------- bulk setters
    def setAllSpringConstantValues(self, k: float) -> None:
        """Host-side only until set/setAll, like the reference (sim.cu:769-777)."""
        self._check_not_ended()
        self._store.k[: self._store.n_springs] = k
        self._journal_bulk()

    def defaultRestLengths(self) -> None:
        self._check_not_ended()
        st = self._store
        s = st.n_springs
        attached = (st.left[:s] >= 0) & (st.right[:s] >= 0)
        li = np.where(attached, st.left[:s], 0)
        ri = np.where(attached, st.right[:s], 0)
        st.rest[:s] = np.where(attached,
                               builders.rest_lengths(st.pos, li, ri),
                               st.rest[:s])
        self._journal_bulk("rest")

    def setAllMassValues(self, m: float) -> None:
        """NOTE: the reference *adds* m to every mass (sim.cu:789-796)."""
        self._check_not_ended()
        self._store.m[: self._store.n_masses] += m
        self._journal_bulk("m")

    def setTimeStep(self, delta_t: float) -> None:
        """Live: the reference reads dt from a member each step (sim.cu:798-808)."""
        self._check_not_ended()
        if delta_t <= 0:
            raise RuntimeError("Cannot set time step to negative or zero value.")
        with self._lock:
            self._dt = float(delta_t)
            if self._state is not None:
                self._state = dataclasses.replace(
                    self._state, dt=self._tensor(np.float64(delta_t)))

    def getTimeStep(self) -> float:
        return self._dt

    def setGlobalAcceleration(self, global_acc) -> None:
        """Reference sim.cu:2334-2340 (throws while running)."""
        if self._running:
            raise RuntimeError("The simulation is running. The global force "
                               "parameter cannot be changed during runtime")
        self._global_acc = _np3(global_acc)
        if self._state is not None:
            self._state = dataclasses.replace(
                self._state, g=self._tensor(self._global_acc))

    # ------------------------------------------------------------- marshalling
    def _marshal(self) -> None:
        """Build the device state from the host store (replaces the
        reference's toArray, sim.cu:940-1041).  Springs are split into
        stencil families and a remainder; ``_sp_family``/``_sp_slot`` record
        where each spring landed so readback and pushes can find it."""
        st, cfg = self._store, self.config
        if cfg.compact_threshold:
            n, s = st.n_masses, st.n_springs
            # structural holes are index geometry, not garbage
            dead_m = int(np.count_nonzero(~st.valid[:n] & ~st.hole[:n]))
            dead_s = s - int(np.count_nonzero(st.s_valid[:s]))
            if ((n and dead_m / n >= cfg.compact_threshold)
                    or (s and dead_s / s >= cfg.compact_threshold)):
                self._compact_store()
        dt = cfg.np_dtype
        n, s = st.n_masses, st.n_springs
        N = pad_to(n)

        # ---- spring partition: stencil families vs remainder
        attached_all = (st.left[:s] >= 0) & (st.right[:s] >= 0)
        placeable = st.s_valid[:s] & attached_all
        if cfg.use_stencil:
            families, rem_idx = builders.build_stencil_groups(
                st.left[:s], st.right[:s], placeable, n,
                max_families=cfg.stencil_max_families,
                min_count=cfg.stencil_min_count)
        else:
            families, rem_idx = [], np.flatnonzero(placeable)
        deltas = tuple(int(d) for d, _, _ in families)
        s_rem = int(rem_idx.shape[0])
        S = pad_to(max(s_rem, 1))

        self._sp_family = np.full(s, -1, dtype=np.int32)
        self._sp_slot = np.full(s, -1, dtype=np.int64)
        for fi, (_, sidx, lpos) in enumerate(families):
            self._sp_family[sidx] = fi
            self._sp_slot[sidx] = lpos
        self._sp_slot[rem_idx] = np.arange(s_rem)

        # ---- static shape; per-field "uniform within every family" flags
        # compared in the device dtype, as the JAX package computes them;
        # a push that breaks one clears it (_check_uniform_break)
        host_fields = {"k": st.k, "rest": st.rest, "damping": st.damping,
                       "type": st.s_type, "omega": st.omega,
                       "l_max": st.l_max, "l_min": st.l_min, "rate": st.rate}
        field_dt = {"type": np.int8}
        uniform = {f: all(np.all(host[sidx].astype(field_dt.get(f, dt))
                                 == host[sidx[0]].astype(field_dt.get(f, dt)))
                          for _, sidx, _ in families if len(sidx))
                   for f, host in host_fields.items()}
        caps = _local_caps(st)
        max_deg, rem_span = _remainder_degree_span(st, rem_idx, n)
        shape = SceneShape(
            n_masses=N, n_springs=S, max_degree=max_deg,
            stencil_deltas=deltas, has_remainder=s_rem > 0,
            n_planes=len(self._planes), n_balls=len(self._balls),
            plane_friction=tuple(bool(p[2] or p[3]) for p in self._planes),
            cap_cp=caps[0], cap_ball=caps[1], cap_pl=caps[2], cap_dir=caps[3],
            config=cfg, remainder_span=rem_span,
            stencil_uniform=tuple(uniform[f] for f in _UNIFORM_FIELDS),
            **_feature_flags(st, cfg))

        # ---- stencil families: [F, N] planes indexed by (family, left)
        F = len(families)
        mask_np = np.zeros((F, N), dtype=bool)
        for fi, (_, _, lpos) in enumerate(families):
            mask_np[fi, lpos] = True
        mask_dev = self._tensor(mask_np)
        stencil_arrays = {"mask": mask_dev}
        fam_scalars = {}
        for f, host in host_fields.items():
            fdt = field_dt.get(f, dt)
            if uniform[f]:
                # one value per family, expanded on the device
                scalars = np.array(
                    [host[sidx[0]] if len(sidx) else 0
                     for _, sidx, _ in families], dtype=fdt)
                fam_scalars[f] = scalars
                stencil_arrays[f] = torch.where(
                    mask_dev, self._tensor(scalars, fdt)[:, None],
                    torch.zeros((), dtype=getattr(torch, np.dtype(fdt).name),
                                device=self._device))
            else:
                arr = np.zeros((F, N), dtype=fdt)
                for fi, (_, sidx, lpos) in enumerate(families):
                    arr[fi, lpos] = host[sidx]
                stencil_arrays[f] = self._tensor(arr, fdt)
        stencil = StencilState(**stencil_arrays)

        def vec3(a):  # host [cap, 3] -> device [3, N]
            out = np.zeros((3, N), dtype=dt)
            out[:, :n] = a[:n].T
            return self._tensor(out)

        def sc(a, fill=0.0, dtype=None):
            out = np.full(N, fill, dtype=dtype or dt)
            out[:n] = a[:n]
            return self._tensor(out, dtype)

        masses = MassState(
            pos=vec3(st.pos), vel=vec3(st.vel), acc=vec3(st.acc),
            extern_force=vec3(st.extern_force),
            m=sc(st.m, fill=1.0), T=sc(st.T),
            fixed=sc(st.fixed, fill=False, dtype=bool),
            valid=sc(st.valid, fill=False, dtype=bool),
            drag=sc(st.drag),
            mag_rad=sc(st.mag_rad), mag_stiffness=sc(st.mag_stiffness),
            mag_maxf=sc(st.mag_maxf), mag_scale=sc(st.mag_scale))
        springs, topo, rem_left, rem_right = _build_remainder_states(
            st, rem_idx, N, S, max_deg, dt, cfg, self._tensor)
        self._shape = shape
        self._state = SimState(
            t=self._tensor(np.float64(self._T)),
            dt=self._tensor(np.float64(self._dt)),
            g=self._tensor(self._global_acc),
            masses=masses, springs=springs, stencil=stencil,
            gcon=_build_gcon(self._planes, self._balls, dt, self._tensor),
            lcon=_marshal_local(st, N, shape, dt, self._tensor), topo=topo)
        self._install_chunk(shape)
        self._rate = None
        self._timed_chunks = 0
        # mirrors and a fresh journal for the incremental edit path
        # (runtime/incremental.py)
        self._n_marshaled = n
        self._s_marshaled = s
        self._rem_count = s_rem
        self._rem_left, self._rem_right = rem_left, rem_right
        self._st_mask = mask_np
        self._fam_scalars = {f: fam_scalars.get(f) for f in _UNIFORM_FIELDS}
        self._journal = EditJournal()
        self._structure_dirty = False
        get_logger().debug("marshalled scene shape: %s", shape)

    def _install_chunk(self, shape: SceneShape) -> None:
        """The chunk for ``shape``: on the mesh ``distribute`` chose, else
        on one device."""
        if self._mesh is not None:
            self._place_distributed(shape, self._mesh)
        else:
            self._chunk = _chunk_for(shape)

    def _place_distributed(self, shape: SceneShape, mesh) -> None:
        """The distributed chunk for ``shape`` on ``mesh``
        (``titan_tpu/runtime/simulation.py:616-661``): the per-shard tiled
        kernels (``parallel/halo_tiled.py``) for a scene inside their
        envelope that one device would not step on the fused kernel
        (``ops/step.py::chunk_route``); else the halo-exchange route
        (``parallel/halo.py``); else, with a warning naming the failed
        condition, the sharded catch-all (``parallel/sharded.py``: the
        single-device chunk on the gathered state)."""
        from ..ops.step import chunk_route
        from ..parallel.halo import halo_reject_reason
        from ..parallel.halo_tiled import halo_tiled_reject_reason
        axis = self._mesh_axis
        d_all = mesh.shape[axis]
        ht_reason = halo_tiled_reject_reason(shape, d_all)
        if ht_reason is None and chunk_route(shape)[0] != "fused":
            kind = "halo_tiled"
        elif halo_reject_reason(shape, d_all) is None:
            kind = "halo"
        else:
            get_logger().warning(
                "scene is outside the halo-exchange envelope; stepping the "
                "gathered state on one device (the sharded catch-all, no "
                "faster than one device): %s",
                halo_reject_reason(shape, d_all))
            kind = "sharded"
        self._chunk = _dist_chunk_for(shape, mesh, axis, kind)
        get_logger().info("distributed over %d shards via the %s route",
                          d_all, kind)

    def distribute(self, mesh=None, axis: str = "shard") -> None:
        """Run this simulation block-sharded across the shards of a mesh
        (``titan_tpu/runtime/simulation.py:663-682``): the same control
        plane (start / wait / get / set / edits) drives the scene; each
        chunk steps the shards and gathers the state back for readback.
        Call before start(), or at a pause.  With no argument, a mesh of
        one shard on each visible CUDA device (``parallel.make_mesh``).
        The shards may share a device: ``make_mesh(devices=[dev] * 4)``."""
        self._check_not_ended()
        if mesh is None:
            from ..parallel.mesh import make_mesh
            mesh = make_mesh((axis,))
        self._mesh = mesh
        self._mesh_axis = axis
        if self._state is not None and self._shape is not None:
            self._place_distributed(self._shape, mesh)
            self._rate = None
            self._timed_chunks = 0

    # ----------------------------------------------------------------- control
    def start(self) -> None:
        """Marshal the scene and launch the worker (reference sim.cu:1547-1591)."""
        self._check_not_ended("Cannot call sim.start() after the end of the simulation.")
        if self._store.n_masses == 0:
            raise RuntimeError("No masses have been added. Please add masses "
                               "before starting the simulation.")
        if self._dt <= 0:
            raise RuntimeError("Simulation timestep is invalid. Please choose "
                               "a positive non-zero value.")
        self._T = 0.0
        self._marshal()
        get_logger().info(
            "start: %d masses, %d springs (%d stencil families, remainder=%s"
            "), %d planes, %d balls on %s",
            self._store.n_masses, self._store.n_springs,
            len(self._shape.stencil_deltas), self._shape.has_remainder,
            self._shape.n_planes, self._shape.n_balls, self._device)
        self._started = True
        self._running = True
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="titan-torch-worker")
        self._worker.start()

    def _run(self) -> None:
        """Worker loop: chunked stepping toward breakpoints.  The worker
        only steps toward *pending breakpoints*, so sim time advances
        exactly to what the host asked for (wait/pause/waitUntil all set
        breakpoints) and every observed time is exact and reproducible."""
        while True:
            with self._cv:
                while not self._ended and not (self._running and self._bpts):
                    self._cv.wait()
                if self._ended:
                    self._cv.notify_all()
                    return
                nxt = self._bpts[0]
                if nxt <= self._T + 1e-12:
                    heapq.heappop(self._bpts)
                    self._running = False
                    self._cv.notify_all()
                    continue
                dt = self._dt
                n = int(math.ceil((nxt - self._T) / dt - 1e-9))
                n = max(1, min(n, self.config.max_chunk_steps))
                # wall-time cap per chunk (config.max_chunk_seconds): a fresh
                # chunk fn runs probe-sized chunks until its rate is known.
                # A control plane replicated over processes sizes its
                # chunks by breakpoints alone, the same in every process,
                # so that each chunk's collectives pair up
                timed = self._mesh is None or not self._mesh.multiprocess
                if timed and self._rate is None:
                    n = min(n, self.config.probe_chunk_steps)
                elif timed:
                    n = min(n, max(1, int(self._rate
                                          * self.config.max_chunk_seconds)))
                state, chunk = self._state, self._chunk
            t0 = time.perf_counter()
            new_state = chunk(state, n)
            ready = None
            if new_state.t.is_cuda:
                ready = torch.cuda.Event()
                ready.record()
            # one chunk in flight: wait for it, so that the time the host
            # reports counts finished steps only, and time the chunk
            _sync(new_state)
            if self._timed_chunks:  # the first may include the kernel build
                r = n / max(time.perf_counter() - t0, 1e-6)
                self._rate = r if self._rate is None \
                    else 0.5 * self._rate + 0.5 * r
            self._timed_chunks += 1
            if self.config.check_finite:
                ok = bool(torch.isfinite(new_state.masses.pos).all()
                          & torch.isfinite(new_state.masses.vel).all())
                if not ok:
                    with self._cv:
                        self._running = False
                        self._diverged_at = self._T + n * dt
                        self._cv.notify_all()
                    return
            with self._cv:
                # setTimeStep may have fired while this chunk was in flight:
                # re-stamp dt so the writeback does not clobber it
                if self._dt != dt:
                    new_state = dataclasses.replace(
                        new_state, dt=self._tensor(np.float64(self._dt)))
                self._state = new_state
                self._state_ready = (new_state, ready)
                self._T += n * dt
                self._cv.notify_all()

    def setBreakpoint(self, time: float) -> None:
        """Reference sim.cu:814-820 (here with an actual mutex)."""
        self._check_not_ended("Cannot set breakpoints after the end of the simulation run.")
        with self._cv:
            heapq.heappush(self._bpts, float(time))
            self._cv.notify_all()

    def pause(self, t: float) -> None:
        """Pause at sim time t, blocking the caller (reference sim.cu:1843-1850)."""
        self._check_not_ended("Control functions cannot be called.")
        self.setBreakpoint(t)
        self.waitForEvent()

    def resume(self) -> None:
        """Reference sim.cu:1684-1702; re-marshals if the scene changed."""
        self._check_not_ended("Cannot resume the simulation.")
        if not self._started:
            raise RuntimeError("The simulation has not started. You cannot "
                               "resume a simulation before calling sim.start().")
        if self._diverged_at is not None:
            raise SimulationDivergedError(
                f"simulation state contains NaN/Inf at t <= {self._diverged_at}"
                "; cannot resume")
        if self._store.n_masses == 0:
            raise RuntimeError("No masses have been added.")
        if self._structure_dirty:
            # row-level surgery where possible, else a full re-marshal
            # (pulling everything first) -- runtime/incremental.py
            path = apply_structural_edits(self)
            get_logger().debug("resume: structural edits applied via %s "
                               "path", path)
        with self._cv:
            self._running = True
            self._cv.notify_all()

    def wait(self, t: float) -> None:
        """Park the simulation at exactly time()+t (reference
        sim.cu:1852-1861 spins the host while the GPU free-runs; here the
        stop is a breakpoint, so every get() after a wait() is
        deterministic).  Returns at once if already paused."""
        self._check_not_ended("Control functions cannot be called.")
        with self._cv:
            if not self._running:
                return
            target = self._T + t
        self.pause(target)

    def waitUntil(self, t: float) -> None:
        """Park at sim time t (same deterministic semantics as wait())."""
        self._check_not_ended("Control functions cannot be called.")
        with self._cv:
            if not self._running or self._T > t:
                return
        self.pause(t)

    def waitForEvent(self) -> None:
        self._check_not_ended("Control functions cannot be called.")
        with self._cv:
            self._cv.wait_for(lambda: not self._running)
        if self._diverged_at is not None:
            raise SimulationDivergedError(
                f"simulation state contains NaN/Inf at t <= {self._diverged_at}")

    def stop(self, t: Optional[float] = None) -> None:
        """Stop and free (reference sim.cu:1517-1545)."""
        if self._running:
            self.setBreakpoint(self.time() if t is None else t)
            self.waitForEvent()
        with self._cv:
            self._ended = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30)
        self._state = None
        self._chunk = None

    def reset(self) -> None:
        """Back to a fresh pre-start simulation (reference sim.cu:102-129):
        ends and joins the worker, then initialises anew."""
        with self._cv:
            self._ended = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30)
        self.__init__(self.config)

    def time(self) -> float:
        with self._lock:
            return self._T

    def running(self) -> bool:
        return self._running

    # ---- viewer camera (reference GRAPHICS-only API, sim.h:124-128), read
    # by runtime/viewer.Recorder.export_html and runtime/live.LiveViewer
    def setViewport(self, camera_position, target_location, up_vector) -> None:
        """Reference sim.cu:1636-1648 (GRAPHICS builds)."""
        if self._running:
            raise RuntimeError("The simulation is running. Cannot modify "
                               "viewport during simulation run.")
        self._camera = (_np3(camera_position), _np3(target_location),
                        _np3(up_vector))

    def getProjectionMatrix(self) -> np.ndarray:
        """The current model-view-projection matrix (reference sim.h:128,
        graphics.cpp::getProjection): perspective 45 deg FOV, 4:3 aspect,
        near 0.01 / far 200, looking from the setViewport camera.  A [4, 4]
        row-major numpy array (the reference's glm::mat4 is the same matrix,
        column-major)."""
        cam, look, up = getattr(self, "_camera", _DEFAULT_CAMERA)
        fovy, aspect, near, far = math.radians(45.0), 4.0 / 3.0, 0.01, 200.0
        f = 1.0 / math.tan(fovy / 2)
        proj = np.zeros((4, 4))
        proj[0, 0] = f / aspect
        proj[1, 1] = f
        proj[2, 2] = (far + near) / (near - far)
        proj[2, 3] = 2 * far * near / (near - far)
        proj[3, 2] = -1.0
        fwd = look - cam
        fwd = fwd / np.linalg.norm(fwd)
        s = np.cross(fwd, up / np.linalg.norm(up))
        s = s / np.linalg.norm(s)
        u = np.cross(s, fwd)
        view = np.eye(4)
        view[0, :3], view[0, 3] = s, -np.dot(s, cam)
        view[1, :3], view[1, 3] = u, -np.dot(u, cam)
        view[2, :3], view[2, 3] = -fwd, np.dot(fwd, cam)
        return proj @ view

    def moveViewport(self, displacement) -> None:
        """Reference sim.cu:1651-1661."""
        if self._running:
            raise RuntimeError("The simulation is running. Cannot modify "
                               "viewport during simulation run.")
        cam, look, up = getattr(self, "_camera", _DEFAULT_CAMERA)
        self._camera = (cam + _np3(displacement), look, up)

    def fps(self) -> float:
        """Render-rate counter (reference sim.cu:1201-1214): the capture
        rate of an attached runtime/viewer.Recorder, else -1.0 like the
        reference with no frames."""
        rec = getattr(self, "_recorder", None)
        return rec.fps() if rec is not None else -1.0

    def printPositions(self) -> None:
        self._check_not_ended("You cannot view parameters of the simulation "
                              "after it has been stopped.")
        st = self._store
        for i in range(st.n_masses):
            print(f"{i}: ({st.pos[i, 0]}, {st.pos[i, 1]}, {st.pos[i, 2]})")

    def printSprings(self) -> None:
        """Spring endpoints and rest lengths (reference printSprings,
        sim.cu:2317-2332, its device branch's printSpring kernel)."""
        self._check_not_ended("You cannot view parameters of the simulation "
                              "after it has been stopped.")
        st = self._store
        for i in range(st.n_springs):
            print(f"{i}: ({st.left[i]}, {st.right[i]}) rest {st.rest[i]}")

    # --------------------------------------------------------------- get / set
    def _snapshot(self) -> SimState:
        with self._lock:
            state = self._state
        if state is None:
            raise RuntimeError("Simulation not started.")
        return state

    def getAll(self) -> None:
        """Device -> host readback of all mass state and spring rest
        lengths (reference getAll/massFromArray, sim.cu:643-654,
        1094-1116; the reference never reads rest back, here it does)."""
        if not self._started or self._state is None:
            return
        state = self._snapshot()
        st = self._store
        # rows created since the last marshal have no device values yet
        n = min(st.n_masses, self._n_marshaled)
        m = state.masses
        host = lambda x: x.cpu().numpy()  # noqa: E731
        st.pos[:n] = host(m.pos)[:, :n].T
        st.vel[:n] = host(m.vel)[:, :n].T
        st.acc[:n] = host(m.acc)[:, :n].T
        st.extern_force[:n] = host(m.extern_force)[:, :n].T
        st.m[:n] = host(m.m)[:n]
        st.T[:n] = host(m.T)[:n]
        st.valid[:n] = host(m.valid)[:n]
        self._pull_rest_into_store(host(state.springs.rest),
                                   host(state.stencil.rest))

    def _pull_rest_into_store(self, rem_rest: np.ndarray,
                              st_rest: np.ndarray) -> None:
        """Reassemble host rest lengths from the stencil/remainder split."""
        st = self._store
        s = min(st.n_springs, self._s_marshaled)
        fam, slot = self._sp_family[:s], self._sp_slot[:s]
        in_st = fam >= 0
        if np.any(in_st):
            st.rest[:s][in_st] = st_rest[fam[in_st], slot[in_st]]
        in_rem = (fam < 0) & (slot >= 0)
        if np.any(in_rem):
            st.rest[:s][in_rem] = rem_rest[slot[in_rem]]

    def setAll(self) -> None:
        """Host -> device push of everything (reference setAll, sim.cu:720-765)."""
        if not self._started or self._state is None:
            return
        if self._running:
            raise RuntimeError("The simulation is running. Stop the simulation to make changes.")
        with self._cv:
            if self._structure_dirty:
                self._sync_full_preserving_edits()
            self._marshal()

    def get(self, obj) -> None:
        """Per-object readback (reference sim.cu:589-654).  get(Spring)
        pulls only the rest length, matching spring.cu:10-14."""
        if not self._started or self._state is None:
            return
        if isinstance(obj, Mass):
            self._pull_masses(np.array([obj._i]))
        elif isinstance(obj, Spring):
            self._pull_springs_rest(np.array([obj._i]))
        elif isinstance(obj, Container):
            self._pull_masses(obj._mass_idx)
            if len(obj._spring_idx):
                self._pull_springs_rest(obj._spring_idx)
        else:
            raise TypeError(type(obj))

    def _pull_springs_rest(self, idx: np.ndarray) -> None:
        """Pull current device rest lengths of the given spring rows."""
        j = self._journal
        if j is not None and j.store_fresh:
            return
        idx = np.asarray(idx, dtype=np.int64)
        idx = idx[idx < self._s_marshaled]
        if not len(idx):
            return
        state = self._snapshot()
        st = self._store
        fam, slot = self._sp_family[idx], self._sp_slot[idx]
        in_st = fam >= 0
        if np.any(in_st):
            st.rest[idx[in_st]] = state.stencil.rest[
                torch.as_tensor(fam[in_st], dtype=torch.long),
                torch.as_tensor(slot[in_st])].cpu().numpy()
        in_rem = (fam < 0) & (slot >= 0)
        if np.any(in_rem):
            st.rest[idx[in_rem]] = state.springs.rest[
                torch.as_tensor(slot[in_rem])].cpu().numpy()

    def _pull_masses(self, idx: np.ndarray) -> None:
        state = self._snapshot()
        st = self._store
        m = state.masses
        ti = torch.as_tensor(np.asarray(idx, dtype=np.int64))
        st.pos[idx] = m.pos[:, ti].cpu().numpy().T
        st.vel[idx] = m.vel[:, ti].cpu().numpy().T
        st.acc[idx] = m.acc[:, ti].cpu().numpy().T
        st.extern_force[idx] = m.extern_force[:, ti].cpu().numpy().T
        st.m[idx] = m.m[ti].cpu().numpy()
        st.T[idx] = m.T[ti].cpu().numpy()

    def set(self, obj) -> None:
        """Per-object host -> device push (reference sim.cu:604-765).  Only
        the object's own rows are written; everything else keeps its device
        value."""
        if not self._started or self._state is None:
            return
        if self._running:
            raise RuntimeError("The simulation is running. Stop the simulation to make changes.")
        if self._structure_dirty:
            # the re-marshal at resume pushes the store; record the rows
            if isinstance(obj, Mass):
                self._touch_mass(obj._i)
            elif isinstance(obj, Spring):
                self._touch_spring(obj._i)
            elif isinstance(obj, Container):
                self._touch_mass(obj._mass_idx)
                self._touch_spring(obj._spring_idx)
            else:
                raise TypeError(type(obj))
            return
        if isinstance(obj, Mass):
            self._push_masses(np.array([obj._i]))
        elif isinstance(obj, Spring):
            self._push_springs(np.array([obj._i]))
        elif isinstance(obj, Container):
            self._push_masses(obj._mass_idx)
            self._push_springs(obj._spring_idx)
        else:
            raise TypeError(type(obj))

    def _push_masses(self, idx: np.ndarray) -> None:
        if len(idx) == 0:
            return
        st = self._store
        needs_magnets = bool(np.any(st.mag_maxf[idx] != 0.0)
                             or np.any(st.mag_rad[idx] != 0.0))
        needs_drag = bool(np.any(st.drag[idx] != 0.0))
        recv_overflow = False
        if self._shape.magnet_receivers:
            # a compacted receiver set (SceneShape.magnet_receivers) breaks
            # with any shell radius, or with more attractors than its
            # capacity; only the pushed rows can bring either, so the full
            # recount runs only when a pushed row is an attractor
            if bool(np.any(st.mag_rad[idx] != 0.0)):
                recv_overflow = True
            elif bool(np.any(st.valid[idx] & (st.mag_maxf[idx] != 0.0))):
                nm = st.n_masses
                recv_overflow = (
                    int(np.count_nonzero(st.valid[:nm]
                                         & (st.mag_maxf[:nm] != 0.0)))
                    > self._shape.magnet_receivers)
        if ((needs_magnets and not self._shape.has_magnets)
                or (needs_drag and not self._shape.has_drag)
                or recv_overflow):
            self._upgrade_shape()
        ti = torch.as_tensor(np.asarray(idx, dtype=np.int64))
        with self._cv:
            m = self._state.masses
            vals = {"pos": st.pos[idx].T, "vel": st.vel[idx].T,
                    "extern_force": st.extern_force[idx].T,
                    "m": st.m[idx], "fixed": st.fixed[idx],
                    "valid": st.valid[idx], "drag": st.drag[idx],
                    "mag_rad": st.mag_rad[idx],
                    "mag_stiffness": st.mag_stiffness[idx],
                    "mag_maxf": st.mag_maxf[idx],
                    "mag_scale": st.mag_scale[idx]}
            self._state = dataclasses.replace(
                self._state, masses=dataclasses.replace(
                    m, **{f: _set_cols(getattr(m, f), ti, self._tensor(v))
                          for f, v in vals.items()}))

    def _push_springs(self, idx: np.ndarray,
                      _incremental: bool = False) -> None:
        """Push the 8 per-spring parameter fields of the given rows.
        ``_incremental=True`` (runtime/incremental.py) skips the feature
        and uniformity checks: the caller has recomputed the shape from the
        whole store already."""
        if len(idx) == 0:
            return
        st = self._store
        if not _incremental:
            # a pushed spring may enable a feature the current shape lacks
            needs_breathing = bool(np.any(
                (st.s_type[idx] != PASSIVE_SOFT)
                & (st.s_type[idx] != PASSIVE_STIFF)))
            needs_actuated = bool(np.any(
                (st.s_type[idx] == ACTUATED_EXPAND)
                | (st.s_type[idx] == ACTUATED_CONTRACT)))
            needs_damping = bool(np.any(st.damping[idx] != 0.0))
            if ((needs_breathing and not self._shape.has_breathing)
                    or (needs_actuated and not self._shape.has_actuated)
                    or (needs_damping and not self._shape.has_damping)):
                self._upgrade_shape()
            self._check_uniform_break(idx)
        fam, slot = self._sp_family[idx], self._sp_slot[idx]
        in_st = fam >= 0
        in_rem = (fam < 0) & (slot >= 0)
        fields = [("k", "k"), ("rest", "rest"), ("damping", "damping"),
                  ("type", "s_type"), ("omega", "omega"), ("l_max", "l_max"),
                  ("l_min", "l_min"), ("rate", "rate")]
        with self._cv:
            for sel, tree_name, rows in (
                    (in_st, "stencil", lambda s: (
                        torch.as_tensor(fam[s], dtype=torch.long),
                        torch.as_tensor(slot[s]))),
                    (in_rem, "springs", lambda s: (
                        torch.as_tensor(slot[s]),))):
                if not np.any(sel):
                    continue
                tree = getattr(self._state, tree_name)
                r = rows(sel)
                upd = {}
                for dev_f, host_f in fields:
                    old = getattr(tree, dev_f)
                    new = old.clone()
                    new[r] = torch.as_tensor(getattr(st, host_f)[idx[sel]]).to(
                        device=old.device, dtype=old.dtype)
                    upd[dev_f] = new
                self._state = dataclasses.replace(
                    self._state,
                    **{tree_name: dataclasses.replace(tree, **upd)})

    def _check_uniform_break(self, idx: np.ndarray) -> None:
        """A pushed stencil spring whose parameter differs from its
        family's scalar breaks that field's family-uniform flag
        (``titan_tpu/runtime/simulation.py::_check_uniform_break``).  The
        tiled step reads ONE scalar per uniform family, taken from the
        family's first masked lane (``ops/tiled_step.py::
        prep_tiled_inputs``), so a per-slot push would silently not take
        effect there.  Clear the broken flags (the dense [F, N] arrays the
        push writes already hold the right values) and pick the chunk for
        the new shape."""
        shape = self._shape
        if shape is None or not any(shape.stencil_uniform):
            return
        fam = self._sp_family[idx]
        in_st = fam >= 0
        if not np.any(in_st):
            return
        st, dt = self._store, self.config.np_dtype
        fis, rows = fam[in_st], np.asarray(idx)[in_st]
        uniform = list(shape.stencil_uniform)
        for i, f in enumerate(_UNIFORM_FIELDS):
            scal = self._fam_scalars.get(f)
            if not uniform[i] or scal is None:
                continue
            vals = getattr(st, "s_type" if f == "type" else f)[rows].astype(
                np.int8 if f == "type" else dt)
            if np.any(vals != scal[fis]):
                uniform[i] = False
                self._fam_scalars[f] = None
        if tuple(uniform) == shape.stencil_uniform:
            return
        self._shape = dataclasses.replace(shape,
                                          stencil_uniform=tuple(uniform))
        self._install_chunk(self._shape)
        self._rate = None
        self._timed_chunks = 0

    def _sync_full_preserving_edits(self) -> None:
        """Pull the full device state into the host store without
        clobbering the user's paused-time writes: ``valid``/``m``/
        ``extern_force`` of touched rows stay as the store has them,
        ``pos``/``vel``/``T`` where the user wrote them, ``rest`` of written
        springs, and whole fields a bulk write owns."""
        if not self._started or self._state is None:
            return
        j = self._journal
        if j is None:
            self.getAll()
            return
        if j.store_fresh:
            return
        st = self._store
        saved = [(f, slice(None), getattr(st, f).copy()) for f in j.skip_pull]
        rows = j.mass_rows(self._n_marshaled)
        if len(rows):
            for f in ("valid", "m", "extern_force"):
                saved.append((f, rows, getattr(st, f)[rows].copy()))
        for f in EditJournal.M_WRITTEN_FIELDS:
            wr = j.written_rows(f)
            wr = wr[wr < self._n_marshaled]
            if len(wr):
                saved.append((f, wr, getattr(st, f)[wr].copy()))
        wr = j.rest_written_rows()
        wr = wr[wr < self._s_marshaled]
        if len(wr):
            saved.append(("rest", wr, st.rest[wr].copy()))
        self.getAll()
        for f, rows_, vals in saved:
            getattr(st, f)[rows_] = vals
        j.store_fresh = True

    def _push_mass_rows_full(self, idx: np.ndarray) -> None:
        """Push EVERY mass field of the given rows to the device (the
        incremental edit path: new rows, and touched rows whose evolving
        fields were refreshed first).  Unlike _push_masses this includes
        acc and T and skips the feature-flip checks: the caller has
        recomputed the shape."""
        st = self._store
        ti = torch.as_tensor(np.asarray(idx, dtype=np.int64))
        m = self._state.masses
        vals = {"pos": st.pos[idx].T, "vel": st.vel[idx].T,
                "acc": st.acc[idx].T, "extern_force": st.extern_force[idx].T,
                "m": st.m[idx], "T": st.T[idx], "fixed": st.fixed[idx],
                "valid": st.valid[idx], "drag": st.drag[idx],
                "mag_rad": st.mag_rad[idx],
                "mag_stiffness": st.mag_stiffness[idx],
                "mag_maxf": st.mag_maxf[idx], "mag_scale": st.mag_scale[idx]}
        self._state = dataclasses.replace(
            self._state, masses=dataclasses.replace(
                m, **{f: _set_cols(getattr(m, f), ti, self._tensor(v))
                      for f, v in vals.items()}))

    def _upgrade_shape(self) -> None:
        """Recompute the shape's feature flags from the host store (the
        parameters are host-authoritative) and pick the chunk function for
        it.  Every feature's arrays are always staged, so no re-stage."""
        new_shape = dataclasses.replace(
            self._shape, **_feature_flags(self._store, self.config))
        if new_shape != self._shape:
            self._shape = new_shape
            self._install_chunk(new_shape)
            self._rate = None
            self._timed_chunks = 0

    # -------------------------------------------------------------- compaction
    def compact(self) -> None:
        """Physically remove soft-deleted masses and springs and remap
        containers and handles (reference invalidate + thrust::remove,
        sim.cu:343-414).  Runs at re-marshal when the dead fraction reaches
        ``config.compact_threshold``; callable at a pause.  Handles to
        surviving entities keep working; handles to compacted ones raise on
        their next use."""
        self._check_can_edit()
        self._sync_store_before_structural_edit()
        # compaction rearranges store rows: pull the live device state in
        # first (keeping journaled edits), then mark the store fresh so the
        # full re-marshal at resume does not pull again through the now
        # stale index maps
        self._sync_full_preserving_edits()
        self._compact_store()
        if self._started:
            self._structure_dirty = True
            if self._journal is not None:
                self._journal.force_full = True
                self._journal.store_fresh = True

    def _compact_store(self) -> None:
        mass_remap, spring_remap = self._store.compact()
        if (mass_remap >= 0).all() and (spring_remap >= 0).all():
            return
        self._remaps.append((mass_remap, spring_remap))
        self._gen += 1
        for c in self.containers:
            mi = c._mass_idx
            mi = mass_remap[mi[mi < len(mass_remap)]]
            c._mass_idx = mi[mi >= 0]
            si = c._spring_idx
            si = spring_remap[si[si < len(spring_remap)]]
            c._spring_idx = si[si >= 0]
        self._env_gravity_delta = None  # stale per-row data, if any
        get_logger().debug("compacted store to %d masses / %d springs",
                           self._store.n_masses, self._store.n_springs)

    def _translate_index(self, gen: int, i: int, kind: str) -> int:
        """Translate a handle's row index from generation ``gen`` to now."""
        sel = 0 if kind == "mass" else 1
        for remap in self._remaps[gen:]:
            if i < 0:
                return -1
            table = remap[sel]
            i = int(table[i]) if i < len(table) else i
        return i

    # ------------------------------------------------------------ struct edits
    def _mark_dirty(self, gcon: bool = False) -> None:
        """A structural edit after start(), or (``gcon``) a change of the
        global constraints: the next resume() applies it
        (runtime/incremental.py)."""
        if self._started:
            self._structure_dirty = True
            if gcon and self._journal is not None:
                self._journal.gcon_dirty = True

    def _mark_structure_dirty(self, mass_index: Optional[int] = None) -> None:
        """A local-constraint record changed (entities.addConstraint /
        clearConstraints); journaled for the incremental lcon rebuild."""
        if self._started:
            self._check_can_edit()
            self._sync_store_before_structural_edit()
            self._structure_dirty = True
            j = self._journal
            if j is not None:
                j.lcon_dirty = True
                if mass_index is not None:
                    j.touched_m.add(int(mass_index))

    def _sync_store_before_structural_edit(self) -> None:
        """Guard: structural edits need a paused (or unstarted) simulation.
        The edits are journaled and applied at the next resume()
        (runtime/incremental.py); a full re-marshal pulls the live state
        then, keeping every journaled row."""
        if self._started and self._state is not None and self._running:
            raise RuntimeError("The simulation is running. Stop the "
                               "simulation to make changes.")

    # -- journal recording (no-ops before start) ------------------------------
    def _touch_mass(self, rows, field: Optional[str] = None) -> None:
        j = self._journal
        if j is None or not self._started:
            return
        if np.isscalar(rows) or isinstance(rows, (int, np.integer)):
            j.touched_m.add(int(rows))
            if field is not None and field in j.m_written:
                j.m_written[field].append(np.array([int(rows)], np.int64))
        else:
            rows = np.asarray(rows)
            j.m_arrays.append(rows)
            if field is not None and field in j.m_written:
                j.m_written[field].append(rows)

    def _touch_spring(self, rows, rest: bool = False) -> None:
        j = self._journal
        if j is None or not self._started:
            return
        if np.isscalar(rows) or isinstance(rows, (int, np.integer)):
            j.touched_s.add(int(rows))
            if rest:
                j.s_rest_written.append(np.array([int(rows)], np.int64))
        else:
            rows = np.asarray(rows)
            j.s_arrays.append(rows)
            if rest:
                j.s_rest_written.append(rows)

    def _journal_bulk(self, *skip_pull_fields: str) -> None:
        """A whole-store write: the incremental path cannot express it, and
        the pull before the re-marshal keeps it."""
        j = self._journal
        if j is None or not self._started:
            return
        j.bulk = True
        j.skip_pull.update(skip_pull_fields)

    def _refresh_mass_rows(self, idx, skip=None) -> None:
        """Pull pos/vel/acc/T of the given EXISTING rows into the store,
        keeping per-field user writes (a row whose pos the user just wrote
        keeps the write)."""
        if not self._started or self._state is None:
            return
        j = self._journal
        if j is not None and j.store_fresh:
            return
        idx = np.asarray(idx, dtype=np.int64)
        idx = idx[idx < self._n_marshaled]
        if not len(idx):
            return
        m = self._snapshot().masses
        ti = torch.as_tensor(idx)
        st = self._store
        for f, dev in (("pos", m.pos[:, ti].cpu().numpy().T),
                       ("vel", m.vel[:, ti].cpu().numpy().T),
                       ("T", m.T[ti].cpu().numpy())):
            keep = np.zeros(len(idx), bool)
            if skip is not None and skip.get(f):
                keep = np.isin(idx, np.concatenate(
                    [np.asarray(a, np.int64).ravel() for a in skip[f]]))
            getattr(st, f)[idx[~keep]] = dev[~keep]
        st.acc[idx] = m.acc[:, ti].cpu().numpy().T


def _sync(state: SimState) -> None:
    """Wait until ``state`` has been computed (reads one scalar back)."""
    state.t.item()


def _set_cols(old: torch.Tensor, ti: torch.Tensor, vals: torch.Tensor):
    """Copy of ``old`` with entries ``ti`` of its last axis set to ``vals``
    (snapshots handed out earlier are never written)."""
    new = old.clone()
    new[..., ti.to(old.device)] = vals.to(old.dtype)
    return new


# (camera position, look-at target, up) before any setViewport
_DEFAULT_CAMERA = (np.array([15.0, 15.0, 7.0]), np.array([0.0, 0.0, 2.0]),
                   np.array([0.0, 0.0, 1.0]))


def _np3(v) -> np.ndarray:
    if isinstance(v, Vec):
        return v.numpy()
    return np.asarray(v, dtype=np.float64).reshape(3)


# distinct hues for per-container default colors (_register_built)
_CONTAINER_PALETTE = np.array([
    (0.96, 0.35, 0.32), (0.36, 0.65, 0.96), (0.42, 0.82, 0.47),
    (0.98, 0.77, 0.33), (0.73, 0.52, 0.94), (0.40, 0.85, 0.83),
    (0.95, 0.55, 0.77), (0.80, 0.80, 0.50),
])


def _feature_flags(st: HostStore, cfg: SimConfig) -> dict:
    """SceneShape feature flags from the host store (parameters and
    validity are host-authoritative), computed as
    ``titan_tpu/runtime/simulation.py::_feature_flags`` computes them."""
    n, s = st.n_masses, st.n_springs
    has_magnets = bool(np.any(st.mag_maxf[:n] != 0.0)
                       or np.any(st.mag_rad[:n] != 0.0))
    n_magnetic = int(np.count_nonzero(
        st.valid[:n] & ((st.mag_maxf[:n] != 0) | (st.mag_rad[:n] != 0)
                        | (st.mag_scale[:n] != 0)
                        | (st.mag_stiffness[:n] != 0))))
    magnet_binned, magnet_grid, magnet_receivers = (), False, 0
    if has_magnets and n_magnetic >= cfg.magnet_binned_threshold:
        # the bin table holds every valid mass (each is a shell-contact
        # source, sim.cu:842), so it is sized by the valid count
        n_valid = int(np.count_nonzero(st.valid[:n]))
        magnet_binned = (pad_to(max(n_valid, 1), 8), cfg.magnet_cell_cap)
        # receiver compaction is exact only when no mass has a shell
        # radius; it is worth it when the attractors are sparse
        n_recv = int(np.count_nonzero(st.valid[:n]
                                      & (st.mag_maxf[:n] != 0.0)))
        if not np.any(st.mag_rad[:n] != 0.0) and n_recv < n_valid // 4:
            magnet_receivers = pad_to(max(n_recv, 1), 8)
        # the JAX package's TPU grid-kernel rule (f32, a cell cap that is a
        # multiple of 8, no compaction, use_pallas); the fused step takes
        # the grid kernel whatever it says, the eager step reads it
        # (ops/step.py::magnet_route)
        magnet_grid = (cfg.use_pallas
                       and magnet_receivers == 0
                       and n_magnetic >= cfg.magnet_grid_threshold
                       and cfg.dtype == "float32"
                       and cfg.magnet_cell_cap % 8 == 0)
    return dict(
        has_magnets=has_magnets, magnet_binned=magnet_binned,
        magnet_grid=magnet_grid, magnet_receivers=magnet_receivers,
        has_drag=bool(np.any(st.drag[:n] != 0.0)),
        has_breathing=bool(np.any((st.s_type[:s] != PASSIVE_SOFT)
                                  & (st.s_type[:s] != PASSIVE_STIFF))),
        has_actuated=bool(np.any((st.s_type[:s] == ACTUATED_EXPAND)
                                 | (st.s_type[:s] == ACTUATED_CONTRACT))),
        has_damping=bool(np.any(st.damping[:s] != 0.0)),
        all_valid=bool(np.all(st.valid[:n])),
    )


def _remainder_degree_span(st: HostStore, rem_idx: np.ndarray, n: int):
    """(max vertex degree, max index span) over the remainder springs."""
    if rem_idx.shape[0]:
        ids = np.concatenate([st.right[rem_idx], st.left[rem_idx]])
        max_deg = int(np.bincount(ids, minlength=n).max())
        rem_span = int(np.max(np.abs(st.right[rem_idx] - st.left[rem_idx])))
    else:
        max_deg = 1
        rem_span = 0
    return max(max_deg, 1), rem_span


def _build_remainder_states(st: HostStore, rem_idx: np.ndarray, N: int,
                            S: int, max_degree: int, dt, cfg: SimConfig,
                            to_dev):
    """Device SpringState + Topology of the remainder springs, and each
    remainder slot's host endpoints (int64 [S] left, right).  Shared by
    _marshal and the incremental edit path's remainder rebuild."""
    s_rem = int(rem_idx.shape[0])

    def ssc(a, dtype=None):
        out = np.zeros(S, dtype=dtype or dt)
        out[:s_rem] = a[rem_idx]
        return to_dev(out, dtype)

    left = np.zeros(S, dtype=np.int32)
    right = np.zeros(S, dtype=np.int32)
    left[:s_rem] = st.left[rem_idx]
    right[:s_rem] = st.right[rem_idx]
    s_valid = np.zeros(S, dtype=bool)
    s_valid[:s_rem] = True  # rem_idx is already valid + attached

    springs = SpringState(
        left=to_dev(left), right=to_dev(right), valid=to_dev(s_valid),
        k=ssc(st.k), rest=ssc(st.rest), damping=ssc(st.damping),
        type=ssc(st.s_type, dtype=np.int8), omega=ssc(st.omega),
        l_max=ssc(st.l_max), l_min=ssc(st.l_min), rate=ssc(st.rate))

    seg_perm = np.zeros(2, dtype=np.int32)
    seg_ids = np.zeros(2, dtype=np.int32)
    if s_rem and cfg.scatter == ScatterMode.GATHER:
        inc_idx, inc_sign = builders.build_incidence(
            left[:s_rem], right[:s_rem], N, S)
        if inc_idx.shape[1] < max_degree:
            padc = max_degree - inc_idx.shape[1]
            inc_idx = np.pad(inc_idx, ((0, 0), (0, padc)), constant_values=S)
            inc_sign = np.pad(inc_sign, ((0, 0), (0, padc)))
    elif s_rem:
        seg_perm, seg_ids = builders.build_segment_sort(left, right)
        inc_idx = np.zeros((1, 1), dtype=np.int32)
        inc_sign = np.zeros((1, 1))
    else:
        inc_idx = np.full((N, 1), S, dtype=np.int32)
        inc_sign = np.zeros((N, 1))
    topo = Topology(inc_idx=to_dev(inc_idx),
                    inc_sign=to_dev(inc_sign.astype(dt)),
                    seg_perm=to_dev(seg_perm), seg_ids=to_dev(seg_ids))
    return springs, topo, left.astype(np.int64), right.astype(np.int64)


def _build_gcon(planes, balls, dt, to_dev) -> GlobalConstraints:
    """Global plane/ball constraint tensors (tiny; rebuilt whole)."""
    P, B = len(planes), len(balls)
    return GlobalConstraints(
        plane_normal=to_dev(np.array([p[0] for p in planes],
                                     dtype=dt).reshape(P, 3)),
        plane_offset=to_dev(np.array([p[1] for p in planes], dtype=dt)),
        plane_fk=to_dev(np.array([p[2] for p in planes], dtype=dt)),
        plane_fs=to_dev(np.array([p[3] for p in planes], dtype=dt)),
        ball_center=to_dev(np.array([b[0] for b in balls],
                                    dtype=dt).reshape(B, 3)),
        ball_radius=to_dev(np.array([b[1] for b in balls], dtype=dt)),
    )


def _local_caps(st: HostStore):
    cap_cp = cap_ball = cap_pl = cap_dir = 0
    for rec in st.local.values():
        cap_cp = max(cap_cp, len(rec.contact_planes))
        cap_ball = max(cap_ball, len(rec.balls))
        cap_pl = max(cap_pl, len(rec.constraint_planes))
        cap_dir = max(cap_dir, len(rec.directions))
    return cap_cp, cap_ball, cap_pl, cap_dir


def _marshal_local(st: HostStore, N: int, shape: SceneShape, dt,
                   to_dev) -> LocalConstraints:
    """The per-mass local-constraint slots from the host records
    (``titan_tpu/runtime/simulation.py::_marshal_local``): slot j of a type
    holds the mass's j-th record of it, and its count says how many are
    live; a deleted mass gets none.  A contact plane is the record form of
    ``Mass.addConstraint``, (normal, offset), frictionless, or the form of
    the per-env plane sweep, (normal, offset, fk, fs)."""
    cp, cb, cpl, cd = shape.cap_cp, shape.cap_ball, shape.cap_pl, shape.cap_dir
    lc = dict(
        cp_normal=np.zeros((N, cp, 3), dtype=dt),
        cp_offset=np.zeros((N, cp), dtype=dt),
        cp_fk=np.zeros((N, cp), dtype=dt), cp_fs=np.zeros((N, cp), dtype=dt),
        cp_count=np.zeros(N, dtype=np.int32),
        ball_center=np.zeros((N, cb, 3), dtype=dt),
        ball_radius=np.zeros((N, cb), dtype=dt),
        ball_count=np.zeros(N, dtype=np.int32),
        pl_normal=np.zeros((N, cpl, 3), dtype=dt),
        pl_friction=np.zeros((N, cpl), dtype=dt),
        pl_count=np.zeros(N, dtype=np.int32),
        dir_tangent=np.zeros((N, cd, 3), dtype=dt),
        dir_friction=np.zeros((N, cd), dtype=dt),
        dir_count=np.zeros(N, dtype=np.int32))
    for i, rec in st.local.items():
        if not st.valid[i]:
            continue
        for j, cp_rec in enumerate(rec.contact_planes):
            lc["cp_normal"][i, j] = cp_rec[0]
            lc["cp_offset"][i, j] = cp_rec[1]
            if len(cp_rec) > 2:
                lc["cp_fk"][i, j] = cp_rec[2]
                lc["cp_fs"][i, j] = cp_rec[3]
        lc["cp_count"][i] = len(rec.contact_planes)
        for j, (c, r) in enumerate(rec.balls):
            lc["ball_center"][i, j] = c
            lc["ball_radius"][i, j] = r
        lc["ball_count"][i] = len(rec.balls)
        for j, (nrm, fr) in enumerate(rec.constraint_planes):
            lc["pl_normal"][i, j] = nrm
            lc["pl_friction"][i, j] = fr
        lc["pl_count"][i] = len(rec.constraint_planes)
        for j, (tg, fr) in enumerate(rec.directions):
            lc["dir_tangent"][i, j] = tg
            lc["dir_friction"][i, j] = fr
        lc["dir_count"][i] = len(rec.directions)
    return LocalConstraints(**{k: to_dev(v) for k, v in lc.items()})
