"""The fused adjoint's trace replay on the plain-spring path.

- Which scenes hand the replay (``ops/adjoint.py::_trace_run_cuda``) the
  plain-spring path's k (``kscal``, ``bits``: ``fused_step.bits_k``): the
  wrapper runs on the CPU against a stand-in for the library, which
  records what it is handed.  Plain springs with family-uniform k set
  them (links and local constraints too); damping, breathing, actuation
  and non-uniform k leave them null, as does a scene after a
  uniform-breaking ``Spring.set``.  The backward of the same segment
  reuses the replay's k.
- The route (``trace_path``): the plain-spring kernel on the plain-spring
  path, magnet scenes' per-pass launches too, the general body off it.
- ``trace_run.launches`` and ``trace_run.plain_launches`` follow
  ``trace_launch_count`` for each integrator, with and without magnets.
- Every entry of the adjoint library that the wrapper binds is defined in
  ``csrc/adjoint.cu``, its ctypes argument types following the C
  signature.
- On the CPU, entry t of ``trace_run_plain`` is bitwise
  ``fused_chunk_plain``'s state after t steps: the replay is the forward
  chunk's own steps, each step's input stored on the way, and the card's
  replay is held to the same (its last entry against the forward chunk,
  ``chip_smoke.py``).

The CUDA kernels are held against ``trace_run_plain`` and the forward
chunk on the card by ``chip_smoke.py``.  Nothing here imports JAX:
tests/test_torch_adjoint*.py hold the plain versions against ``titan_tpu``.
"""

import torch_threads  # noqa: F401  (before torch)

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import titan_tpu_torch as titan
from titan_tpu_torch import _build
from titan_tpu_torch.ops import adjoint, fused_step

CSRC = Path(adjoint.__file__).resolve().parent.parent / "csrc"
INTEGRATORS = {"euler": titan.Integrator.EULER,
               "verlet": titan.Integrator.VERLET,
               "rk2": titan.Integrator.RK2}
FEATURES = ["plain", "links", "local", "damping", "breathing", "actuated",
            "nonuniform_k"]


def lattice(integrator="euler", feature="plain", magnets_on=False,
            dims=(5, 4, 4), z=2.0):
    """A lattice at height z, marshalled on the CPU, with one feature."""
    sim = titan.Simulation(titan.SimConfig(
        device="cpu", integrator=INTEGRATORS[integrator]))
    sim.createLattice(titan.Vec(0, 0, z), titan.Vec(1, 1, 1), *dims)
    sim.setAllSpringConstantValues(700.0)
    st = sim._store
    n, s = st.n_masses, st.n_springs
    if feature == "damping":
        st.damping[:s] = 0.3
    elif feature == "breathing":
        st.s_type[: s // 2] = titan.ACTIVE_CONTRACT_THEN_EXPAND
        st.omega[: s // 2] = 5.0
    elif feature == "actuated":
        st.s_type[: s // 3] = titan.ACTUATED_EXPAND
        st.l_max[: s // 3] = st.rest[: s // 3] * 1.2
        st.rate[: s // 3] = 0.5
    elif feature == "nonuniform_k":
        st.k[:s] *= 1.0 + 0.1 * np.random.RandomState(1).rand(s)
    elif feature == "links":
        for q in range(3):
            sim.createSpring(sim.masses[q], sim.masses[n - 1 - q])
    elif feature == "local":
        for i in range(0, n, 7):
            sim.masses[i].addConstraint(titan.CONTACT_PLANE,
                                        titan.Vec(0, 0.1, 1), z - 0.01)
    if magnets_on:
        st.mag_maxf[:n] = 1e-3
        st.mag_rad[:n] = 0.05
    sim.createPlane(titan.Vec(0, 0, 1), 0)
    sim.setGlobalAcceleration(titan.Vec(0, 0, -9.8))
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim


@pytest.fixture
def stand_in_card(monkeypatch):
    """Runs ``adjoint._trace_run_cuda`` (and ``_bwd_run_cuda``) on CPU
    tensors: the input checks take any device, the magnet field is the
    plain one, and the library is a stand-in whose entries record what
    they are handed and return 0.  Yields the record: ("trace", the
    ``ChunkArgs``), ("pass", the ``ChunkArgs``, the pass's trace entry or
    None) or ("bwd", the ``BwdChunkArgs``)."""
    got = []

    def checked(name, t, shape, dtype=torch.float32, kernel="fused"):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name
        return t.data_ptr()

    def trace(a, ptr, stream):
        got.append(("trace", a._obj))
        return 0

    def trace_pass(a, p, stream):
        # the wrapper reuses one PassArgs: keep this pass's trace entry
        got.append(("pass", a._obj, p._obj.trace))
        return 0

    def bwd(a, stream):
        got.append(("bwd", a._obj))
        return 0
    for mod in (adjoint, fused_step):
        monkeypatch.setattr(mod, "_checked", checked)
    monkeypatch.setattr(adjoint, "_lib", lambda: types.SimpleNamespace(
        titan_adjoint_trace=trace, titan_adjoint_trace_pass=trace_pass,
        titan_adjoint_bwd=bwd))
    monkeypatch.setattr(adjoint, "magnet_field_fn",
                        lambda shape, state, plain: fused_step.magnet_field_fn(
                            shape, state, plain=True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    yield got


def run_stand_in(sim, seg, record, state=None, inv=None):
    """One segment's replay through the stand-in: (the records it made,
    launches, plain-spring launches)."""
    shape, state = sim._shape, state or sim._state
    run = adjoint.trace_run
    run.launches = run.plain_launches = 0
    start = len(record)
    adjoint._trace_run_cuda(shape, state, seg, inv)
    return record[start:], run.launches, run.plain_launches


@pytest.mark.parametrize("feature", FEATURES)
def test_trace_plain_k_follows_scene(feature, stand_in_card):
    """kscal and bits reach the replay's structure on plain springs with
    family-uniform k, with links or local constraints, and match
    ``bits_k``; damping, breathing, actuation and non-uniform k leave them
    null (the general body).  One call hands over the whole segment, one
    launch a step."""
    sim = lattice(feature=feature)
    shape = sim._shape
    plain = feature in ("plain", "links", "local")
    assert fused_step.takes_plain_spring_path(shape) == plain
    assert shape.has_remainder == (feature == "links")
    assert any((shape.cap_cp, shape.cap_ball, shape.cap_pl,
                shape.cap_dir)) == (feature == "local")
    inv = fused_step.prep_invariants(shape, sim._state)
    rec, launches, on_loop = run_stand_in(sim, 3, stand_in_card, inv=inv)
    assert len(rec) == 1 and rec[0][0] == "trace"
    a = rec[0][1]
    assert a.n_steps == 3
    for field in ("kscal", "bits"):
        assert (getattr(a, field) is not None) == plain, field
    assert (launches, on_loop) == (3, 3 if plain else 0)
    if plain:
        kscal, bits = fused_step.bits_k(shape, sim._state, inv)
        assert torch.equal(inv["kscal"], kscal)
        assert torch.equal(inv["bits"], bits)
        ks = torch.stack([kscal[f] * ((bits >> f) & 1).float()
                          for f in range(len(kscal))])
        assert torch.equal(ks, inv["k_eff"])


def test_trace_plain_k_clears_after_uniform_break(stand_in_card):
    """A set() of one spring's k at a pause clears the family's uniform k:
    the replay then takes the general body, one launch per step."""
    sim = lattice()
    sim.start()
    sim.wait(0.001)
    sim.getAll()
    sp = sim.springs[5]
    sp._k = 4 * sp._k
    sim.set(sp)
    state = sim._snapshot()
    sim.stop()
    assert not fused_step.takes_plain_spring_path(sim._shape)
    assert adjoint.trace_path(sim._shape) == "general"
    rec, launches, on_loop = run_stand_in(sim, 2, stand_in_card, state)
    (_, a), = rec
    assert a.kscal is None and a.bits is None
    assert (launches, on_loop) == (2, 0)


def test_bwd_reuses_the_replays_k(stand_in_card):
    """The backward of a segment reads the k the replay made on the same
    staging (``inv``): the same tensors, not a second ``bits_k``."""
    sim = lattice()
    shape, state = sim._shape, sim._state
    inv = fused_step.prep_invariants(shape, state)
    rec, _, _ = run_stand_in(sim, 2, stand_in_card, inv=inv)
    trace = adjoint.trace_run_plain(shape, state, 2)
    rng = np.random.RandomState(3)
    cts = [torch.from_numpy(rng.normal(0, 1, (3, shape.n_masses))
                            .astype(np.float32)) for _ in range(3)]
    adjoint._bwd_run_cuda(shape, state, trace, *cts, inv)
    a_tr, a_bw = rec[0][1], stand_in_card[-1][1]
    assert a_bw.kscal == a_tr.kscal == inv["kscal"].data_ptr()
    assert a_bw.bits == a_tr.bits == inv["bits"].data_ptr()


@pytest.mark.parametrize("feature,magnets_on,want", [
    ("plain", False, "plain"), ("plain", True, "plain"),
    ("damping", False, "general"), ("damping", True, "general")])
def test_trace_path(feature, magnets_on, want, stand_in_card):
    """The route is a rule of the scene: the plain-spring kernel on the
    plain-spring path, magnets or not (their field kernels run between
    passes, each pass its own call), the general body off it; the replay
    hands over what the route says."""
    sim = lattice(feature=feature, magnets_on=magnets_on)
    shape = sim._shape
    assert shape.has_magnets == magnets_on
    assert adjoint.trace_path(shape) == want
    rec, _, _ = run_stand_in(sim, 2, stand_in_card)
    kinds = {r[0] for r in rec}
    assert kinds == ({"pass"} if magnets_on else {"trace"})
    for r in rec:
        assert (r[1].kscal is not None) == (want == "plain")


@pytest.mark.parametrize("magnets_on", [False, True])
@pytest.mark.parametrize("integrator", ["euler", "verlet", "rk2"])
def test_trace_launch_counts(integrator, magnets_on, stand_in_card):
    """The launches of one segment of 4 steps: one per force pass (8 under
    RK2), every one on the plain-spring loop; without magnets one call
    hands over the segment, with RK2's local-constraint velocity buffer;
    with them one call a pass, the step's first pass carrying its trace
    entry."""
    seg = 4
    sim = lattice(integrator, feature="local", magnets_on=magnets_on)
    shape = sim._shape
    rk2 = integrator == "rk2"
    want = seg * (2 if rk2 else 1)
    assert adjoint.trace_launch_count(shape, seg) == (want, want)
    rec, launches, on_loop = run_stand_in(sim, seg, stand_in_card)
    assert launches == on_loop == want
    if not magnets_on:
        (_, a), = rec
        assert a.n_steps == seg and (a.vel_v1 is not None) == rk2
    else:
        assert len(rec) == want
        assert sum(r[2] is not None for r in rec) == seg


def c_signature(source: str, name: str) -> list:
    """The parameter types of ``extern "C" int name(...)`` in a C++
    source: "int", "float" or "pointer"."""
    params = re.search(r'extern "C" int %s\((.*?)\)\s*\{' % name, source,
                       re.S).group(1)
    kinds = []
    for p in params.split(","):
        p = p.strip()
        kinds.append("pointer" if "*" in p else p.split()[-2])
    return kinds


def test_entries_argtypes_follow_c():
    """Every entry ``adjoint._lib`` binds is defined in ``csrc/adjoint.cu``
    and its ctypes argument types follow the C signature, pointer for
    pointer and int for int."""
    src = (CSRC / "adjoint.cu").read_text()
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in (
        "titan_adjoint_trace", "titan_adjoint_trace_pass",
        "titan_adjoint_bwd", "titan_adjoint_bwd_kernel_info",
        "titan_adjoint_trace_kernel_info")})
    load = _build.load
    try:
        _build.load = lambda name: lib
        adjoint._lib()
    finally:
        _build.load = load
    kind = {ctypes.c_int: "int", ctypes.c_float: "float"}
    for name, entry in vars(lib).items():
        got = [kind.get(t, "pointer") for t in entry.argtypes]
        assert got == c_signature(src, name), name
        assert entry.restype is ctypes.c_int


@pytest.mark.parametrize("integrator", ["euler", "verlet", "rk2"])
def test_trace_entries_are_forward_states(integrator):
    """Entry t of the replay's plain version is bitwise the forward
    chunk's state after t steps (pos and vel), for a lattice that lands
    on its plane during the segment and carries local constraints."""
    seg = 6
    sim = lattice(integrator, feature="local", dims=(4, 3, 3), z=0.001)
    shape, state = sim._shape, sim._state
    trace = adjoint.trace_run_plain(shape, state, seg)
    assert tuple(trace.shape) == (seg, 6, shape.n_masses)
    assert torch.equal(trace[0], torch.cat([state.masses.pos,
                                            state.masses.vel]))
    for t in range(1, seg):
        s = fused_step.fused_chunk_plain(shape, state, t)
        assert torch.equal(trace[t, :3], s.masses.pos), t
        assert torch.equal(trace[t, 3:], s.masses.vel), t
    assert not torch.equal(trace[0], trace[-1])
