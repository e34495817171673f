"""Incremental post-start topology edits: row-level surgery on the device
state (a port of ``titan_tpu/runtime/incremental.py``).

Every edit made at a pause is recorded in an :class:`EditJournal`, and
``apply_structural_edits`` replays the journal onto the device state with
indexed writes of the rows it touched instead of re-marshalling the scene:

- **created masses** fill the padded mass slots (the state is padded to
  ``pad_to(n)`` rows; creates that fit need only a row push);
- **created springs** fill free stencil-family slots when their index
  delta matches a family (a mask bit and the 8 field planes), and
  otherwise join the *remainder* springs, which are rebuilt whole (the
  small irregular tail by design);
- **deletes** clear a mask bit or a valid flag;
- **feature flips** (a new spring brings damping, a new mass magnets, ...)
  recompute the static ``SceneShape`` from the host store (parameters are
  host-authoritative) and pick the chunk for it, with no re-staging.

A full re-marshal happens exactly where the JAX package takes one: more
masses than the padded slots, a whole-store bulk write, an explicit
``compact()`` and the dead-fraction compaction threshold.  It pulls the
live device state first, keeping every row the user edited.

The device state is an immutable snapshot per chunk boundary that other
threads read (``getAll``, ``runtime.live.LiveViewer``), so every write
here is out of place: a touched field becomes a new tensor
(``index_put``), and an untouched one stays the same object.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _cat_rows(*parts) -> np.ndarray:
    arrs = [np.fromiter(p, dtype=np.int64, count=len(p))
            if isinstance(p, set)
            else np.asarray(p, dtype=np.int64).ravel() for p in parts]
    return np.unique(np.concatenate(arrs)) if arrs else \
        np.zeros(0, np.int64)


def _pad_rows(idx: np.ndarray, min_len: int = 8) -> np.ndarray:
    """Pad a row-index array to the next power-of-two length by repeating
    its last entry, as the JAX package does to keep its scatter programs
    few; here it bounds the distinct index lengths the surgery writes
    with.  Duplicates are safe: the repeated row carries the same
    payload."""
    n = len(idx)
    if n == 0:
        return idx
    m = max(min_len, 1 << (n - 1).bit_length())
    if m == n:
        return np.asarray(idx)
    return np.concatenate(
        [idx, np.full(m - n, idx[-1], np.asarray(idx).dtype)])


class EditJournal:
    """Record of paused-time edits since the last (re)marshal."""

    __slots__ = ("touched_m", "touched_s", "m_arrays", "s_arrays",
                 "m_written", "s_rest_written", "gcon_dirty", "lcon_dirty",
                 "force_full", "bulk", "store_fresh", "skip_pull")

    #: mass-store fields the device evolves or getAll() pulls; user writes
    #: to these are tracked per row so they win over the device value
    M_WRITTEN_FIELDS = ("pos", "vel", "T", "m", "extern_force")

    def __init__(self):
        self.touched_m = set()      # existing mass rows edited via handles
        self.touched_s = set()
        self.m_arrays = []          # bulk row-index arrays (container ops)
        self.s_arrays = []
        # field -> list of row arrays the user WROTE (per field, so a
        # drag-only edit does not shield the row's live pos from refresh)
        self.m_written = {f: [] for f in self.M_WRITTEN_FIELDS}
        self.s_rest_written = []    # row arrays with user-written rest
        self.gcon_dirty = False     # planes/balls list changed
        self.lcon_dirty = False     # local constraint records changed
        self.force_full = False     # compaction etc: must re-marshal
        self.bulk = False           # whole-store write: must re-marshal
        self.store_fresh = False    # store already holds live state
        self.skip_pull = set()      # store fields a bulk write owns

    def mass_rows(self, n0: int) -> np.ndarray:
        """Touched EXISTING mass rows (< n0), sorted unique."""
        rows = _cat_rows(self.touched_m, *self.m_arrays)
        return rows[rows < n0]

    def spring_rows(self, s0: int) -> np.ndarray:
        rows = _cat_rows(self.touched_s, *self.s_arrays)
        return rows[rows < s0]

    def written_rows(self, field: str) -> np.ndarray:
        return _cat_rows(*self.m_written[field])

    def rest_written_rows(self) -> np.ndarray:
        return _cat_rows(*self.s_rest_written)


_SPRING_FIELDS = (("k", "k"), ("rest", "rest"), ("damping", "damping"),
                  ("type", "s_type"), ("omega", "omega"),
                  ("l_max", "l_max"), ("l_min", "l_min"), ("rate", "rate"))
# order matches SceneShape.stencil_uniform
_UNIFORM_FIELDS = ("k", "rest", "damping", "type", "omega")
# shape fields whose change makes the learned step rate stale
_COST_FLAGS = ("has_damping", "has_breathing", "has_actuated", "has_drag",
               "has_magnets", "has_remainder", "stencil_uniform",
               "magnet_binned", "magnet_grid", "magnet_receivers")


def _stencil_surgery(stc, unfill, fills, fvals):
    """The stencil state with the ``unfill`` slots' mask bits cleared, then
    the ``fills`` slots' bits set and their 8 field planes written from
    ``fvals``; each touched plane is a new tensor."""
    dev = stc.mask.device

    def rows(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    mask = stc.mask
    if unfill:
        idx = (rows(_pad_rows(np.array([u[0] for u in unfill], np.int64))),
               rows(_pad_rows(np.array([u[1] for u in unfill], np.int64))))
        mask = mask.index_put(idx, torch.zeros((), dtype=torch.bool,
                                               device=dev))
    updates = {}
    if fills:
        idx = (rows(_pad_rows(np.array([f[1] for f in fills], np.int64))),
               rows(_pad_rows(np.array([f[2] for f in fills], np.int64))))
        mask = mask.index_put(idx, torch.ones((), dtype=torch.bool,
                                              device=dev))
        for f, vals in fvals.items():
            old = getattr(stc, f)
            updates[f] = old.index_put(
                idx, torch.as_tensor(vals).to(device=dev, dtype=old.dtype))
    updates["mask"] = mask
    return dataclasses.replace(stc, **updates)


def apply_structural_edits(sim) -> str:
    """Apply the paused-time edit journal; returns the path taken.

    ``"incremental"``: row-level surgery succeeded (touched device fields
    replaced, the chunk picked anew where static properties changed).
    ``"full"``: fell back to pull-everything + re-marshal.
    """
    if _try_incremental(sim):
        return "incremental"
    # hold the lock through pull + re-marshal: the worker is parked, but
    # concurrent readers (LiveViewer polls) must never see a torn
    # shape/state pair mid-marshal (the lock is an RLock)
    with sim._cv:
        sim._sync_full_preserving_edits()
        sim._marshal()
    return "full"


def _try_incremental(sim) -> bool:
    from .logging import get_logger
    from .simulation import (_build_gcon, _build_remainder_states,
                             _chunk_for, _feature_flags, _local_caps,
                             _marshal_local, _remainder_degree_span)

    j = sim._journal
    st, shape, cfg = sim._store, sim._shape, sim.config
    if j is None or shape is None or sim._state is None:
        return False
    if j.force_full or j.bulk:
        return False
    n, s = st.n_masses, st.n_springs
    n0, s0 = sim._n_marshaled, sim._s_marshaled
    N = shape.n_masses
    if n > N:
        return False  # beyond the padded mass capacity
    if cfg.compact_threshold:
        # a real marshal would compact here; keep that behavior
        dead_m = int(np.count_nonzero(~st.valid[:n] & ~st.hole[:n]))
        dead_s = s - int(np.count_nonzero(st.s_valid[:s]))
        if ((n and dead_m / n >= cfg.compact_threshold)
                or (s and dead_s / s >= cfg.compact_threshold)):
            return False

    dt = cfg.np_dtype
    fam, slot = sim._sp_family, sim._sp_slot   # marshal-time placement maps
    deltas = shape.stencil_deltas
    delta_to_fi = {d: fi for fi, d in enumerate(deltas)}
    mask = sim._st_mask                        # host mirror, [F, N] bool
    fam_scalars = sim._fam_scalars             # field -> [F] array or None
    uniform = list(shape.stencil_uniform)

    touched_m = j.mass_rows(n0)
    new_m = np.arange(n0, n, dtype=np.int64)
    touched_s = j.spring_rows(s0)
    new_s = np.arange(s0, s, dtype=np.int64)

    caps = _local_caps(st)
    caps_changed = caps != (shape.cap_cp, shape.cap_ball, shape.cap_pl,
                            shape.cap_dir)
    rebuild_lcon = j.lcon_dirty or caps_changed

    # ================================================= phase A: plan
    # (read-only: the rest pull below needs the marshal-time maps intact)
    def marshal_endpoints(i):
        """Endpoints spring i was marshalled with (None if unplaced)."""
        fi, sl = int(fam[i]), int(slot[i])
        if fi >= 0:
            return sl, sl + deltas[fi]
        if sl >= 0:
            return int(sim._rem_left[sl]), int(sim._rem_right[sl])
        return None

    def check_uniform(i, fi):
        """A staged or pushed stencil row whose parameter differs from its
        family's scalar (in the device dtype) demotes that field: the tiled
        step and the plain-spring loop read ONE scalar per uniform family,
        so a per-slot write would silently not take effect there."""
        for uf_i, f in enumerate(_UNIFORM_FIELDS):
            if not uniform[uf_i] or fam_scalars.get(f) is None:
                continue
            host_f = "s_type" if f == "type" else f
            fdt = np.int8 if f == "type" else dt
            if np.asarray(getattr(st, host_f)[i]).astype(fdt) \
                    != fam_scalars[f][fi]:
                uniform[uf_i] = False

    unfill = []            # (fi, lpos) stencil slots to clear
    retarget_rows = set()  # store rows whose placement is removed
    candidates = []        # store rows needing (re)placement, in order
    rem_changed = False
    for i in map(int, touched_s):
        want = bool(st.s_valid[i]) and st.left[i] >= 0 and st.right[i] >= 0
        old = marshal_endpoints(i)
        if old is None:
            if want:
                candidates.append(i)
                rem_changed = True  # can only have been left unplaced
            continue
        if want and old == (int(st.left[i]), int(st.right[i])):
            # a pure parameter edit, pushed row by row below without the
            # push's own uniform check: demote here
            if fam[i] >= 0:
                check_uniform(i, int(fam[i]))
            continue
        retarget_rows.add(i)
        if fam[i] >= 0:
            unfill.append((int(fam[i]), int(slot[i])))
        else:
            rem_changed = True
        if want:
            candidates.append(i)
    for i in map(int, new_s):
        if st.s_valid[i] and st.left[i] >= 0 and st.right[i] >= 0:
            candidates.append(i)

    freed = set(unfill)
    reserved = set()
    fills = []             # (store_row, fi, lpos)
    rem_add = []
    for i in candidates:
        li, ri = int(st.left[i]), int(st.right[i])
        fi = delta_to_fi.get(ri - li)
        free = (fi is not None and 0 <= li < N
                and ((not mask[fi, li]) or (fi, li) in freed)
                and (fi, li) not in reserved)
        if free:
            check_uniform(i, fi)
            fills.append((i, fi, li))
            reserved.add((fi, li))
        else:
            rem_add.append(i)
            rem_changed = True

    old_rem_rows = np.flatnonzero((fam[:s0] < 0) & (slot[:s0] >= 0))

    # ============================================ phase B: device pulls
    # rest is device-evolving state (actuated advance): refresh the store
    # rows the surgery will re-stage, except user-written ones
    refresh = set(map(int, touched_s))
    if rem_changed:
        refresh |= set(map(int, old_rem_rows))
    refresh -= set(map(int, j.rest_written_rows()))
    refresh = {i for i in refresh if marshal_endpoints(i) is not None}
    if refresh:
        sim._pull_springs_rest(
            np.fromiter(refresh, np.int64, len(refresh)))
    # evolving mass fields of touched existing rows (the push below
    # writes whole rows; a drag-only edit must not clobber live pos)
    if len(touched_m):
        sim._refresh_mass_rows(touched_m, skip=j.m_written)

    # ======================================= phase C: mutate (locked)
    if s > len(fam):
        fam = np.concatenate([fam, np.full(s - len(fam), -1, np.int32)])
        slot = np.concatenate([slot, np.full(s - len(slot), -1, np.int64)])
    for i in retarget_rows:
        fam[i] = -1
        slot[i] = -1

    new_springs_state = new_topo = None
    s_rem_new = sim._rem_count
    max_deg, rem_span = shape.max_degree, shape.remainder_span
    S = shape.n_springs
    if rem_changed:
        keep = np.flatnonzero((fam[:s] < 0) & (slot[:s] >= 0))
        rem_idx = np.unique(np.concatenate(
            [keep, np.asarray(rem_add, dtype=np.int64)]))
        s_rem_new = int(rem_idx.shape[0])
        S = max(128, ((max(s_rem_new, 1) + 127) // 128) * 128)
        max_deg, rem_span = _remainder_degree_span(st, rem_idx, n)
        # S, max_degree and remainder_span only grow (larger is always
        # safe: inc_idx pads with sign-0 columns, the span is a routing
        # threshold), to the next power of two, so that edit churn keeps
        # one shape and one chunk
        if S > shape.n_springs:
            S = 1 << (S - 1).bit_length()
        else:
            S = shape.n_springs
        if max_deg > shape.max_degree:
            max_deg = 1 << (max_deg - 1).bit_length()
        else:
            max_deg = shape.max_degree
        if rem_span > shape.remainder_span:
            rem_span = 1 << (rem_span - 1).bit_length()
        else:
            rem_span = shape.remainder_span
        new_springs_state, new_topo, rem_left, rem_right = \
            _build_remainder_states(st, rem_idx, N, S, max_deg, dt, cfg,
                                    sim._tensor)
        fam[rem_idx] = -1
        slot[rem_idx] = np.arange(s_rem_new)
        sim._rem_left, sim._rem_right = rem_left, rem_right

    flags = _feature_flags(st, cfg)
    new_shape = dataclasses.replace(
        shape, n_springs=S, max_degree=max_deg,
        has_remainder=s_rem_new > 0, remainder_span=rem_span,
        n_planes=len(sim._planes), n_balls=len(sim._balls),
        plane_friction=tuple(bool(p[2] or p[3]) for p in sim._planes),
        cap_cp=caps[0], cap_ball=caps[1], cap_pl=caps[2], cap_dir=caps[3],
        stencil_uniform=tuple(uniform), **flags)

    with sim._cv:
        state = sim._state
        # stencil surgery: clears first, then fills (a cleared slot may
        # be refilled by another spring of the same journal)
        if unfill or fills:
            for fi, lp in unfill:
                mask[fi, lp] = False
            fvals = {}
            if fills:
                rows = _pad_rows(np.array([f[0] for f in fills], np.int64))
                fvals = {dev_f: getattr(st, host_f)[rows]
                         for dev_f, host_f in _SPRING_FIELDS}
                for row, fi, lp in fills:
                    fam[row] = fi
                    slot[row] = lp
                    mask[fi, lp] = True
            state = dataclasses.replace(state, stencil=_stencil_surgery(
                state.stencil, unfill, fills, fvals))
        sim._sp_family, sim._sp_slot = fam, slot

        if new_springs_state is not None:
            state = dataclasses.replace(
                state, springs=new_springs_state, topo=new_topo)
            sim._rem_count = s_rem_new

        sim._state = state
        sim._shape = new_shape  # the pushes below consult the new envelope
        if any(u != o for u, o in zip(uniform, shape.stencil_uniform)):
            sim._fam_scalars = {
                f: (fam_scalars.get(f) if uniform[i_] else None)
                for i_, f in enumerate(_UNIFORM_FIELDS)}

        # per-row pushes: touched springs with pure parameter edits (rows
        # the rebuild or the fills just staged are current already)
        staged = ({f[0] for f in fills} | retarget_rows
                  | set(map(int, rem_add)))
        if rem_changed:
            staged |= set(map(int, old_rem_rows))
        push_s = np.array(sorted(set(map(int, touched_s)) - staged),
                          np.int64)
        if len(push_s):
            sim._push_springs(push_s, _incremental=True)

        all_m = np.concatenate([touched_m, new_m])
        if len(all_m):
            sim._push_mass_rows_full(all_m)

        if rebuild_lcon:
            sim._state = dataclasses.replace(
                sim._state, lcon=_marshal_local(st, N, new_shape, dt,
                                                sim._tensor))
        if j.gcon_dirty:
            sim._state = dataclasses.replace(
                sim._state, gcon=_build_gcon(sim._planes, sim._balls, dt,
                                             sim._tensor))

        if new_shape != shape:
            sim._chunk = _chunk_for(new_shape)
            # only a change of cost class makes the learned step rate
            # stale; capacity growth (S, max_degree, span, constraint
            # caps) keeps it and times the next chunk
            if any(getattr(new_shape, f) != getattr(shape, f)
                   for f in _COST_FLAGS):
                sim._rate = None
                sim._timed_chunks = 0
            else:
                sim._timed_chunks = 1

        sim._n_marshaled = n
        sim._s_marshaled = s
        sim._journal = EditJournal()
        sim._structure_dirty = False
    get_logger().debug(
        "incremental topology edit: %d mass rows, %d fills, %d->remainder"
        ", remainder %s (%d), shape %s", len(all_m), len(fills),
        len(rem_add), "rebuilt" if rem_changed else "kept", s_rem_new,
        "changed" if new_shape != shape else "unchanged")
    return True
