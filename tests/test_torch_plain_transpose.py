"""The plain-spring path of the tiled adjoint's backward (B7 and B8): its
spring-phase loop replayed in torch, which scenes set the backward's plain
flag, and the backward's ctypes structure against its C structure.

- A torch replay of ``csrc/adjoint_body.cuh::plain_family_transpose``
  (partner indices clamped into [0, N), k = kscal[f] x bit f of the left
  endpoint's existence word, no damping, each position cotangent and each
  own slot's k and rest gradient taken only where the partner index is in
  range) is bitwise the plain version's family transpose: every force
  transpose of ``tiled_bwd_run_plain``'s sweep (``ops/adjoint.py::
  backward_step``) on small lattices with and without deleted masses and
  a perturbed rest, under Euler, Verlet and RK2 (both passes).
- Which scenes set ``_TiledBwdArgs.plain_springs``: the wrapper
  ``_tiled_bwd_cuda`` runs on the CPU against a stand-in for the library,
  which records the structure it is handed.  Plain springs with
  family-uniform k set it (links too); damping, breathing, actuation and
  non-uniform k do not, nor does a scene after a uniform-breaking
  ``Spring.set``.
- ``_TiledBwdArgs._fields_`` names ``struct TiledBwdArgs``'s fields in
  ``csrc/tiled_adjoint.cu``, in order.

The CUDA kernels are held bitwise against ``tiled_bwd_run_plain`` on the
card by ``chip_smoke.py``.  Nothing here imports JAX: the plain version is
compared with ``titan_tpu`` by tests/test_torch_adjoint_tiled.py.
"""

import torch_threads  # noqa: F401  (before torch)

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import titan_tpu_torch as titan
from titan_tpu_torch.ops import adjoint, adjoint_tiled, fused_step
from titan_tpu_torch.ops import tiled_step

CSRC = Path(adjoint_tiled.__file__).resolve().parent.parent / "csrc"
INTEGRATORS = {"euler": titan.Integrator.EULER,
               "verlet": titan.Integrator.VERLET,
               "rk2": titan.Integrator.RK2}


def lattice(integrator="euler", deleted=False, perturb_rest=False,
            dims=(6, 5, 4), feature="plain", links=0):
    """A lattice in the air (no plane: the force transpose's gf reaches
    the springs as it is), its positions jittered from a seed so that
    every spring is strained."""
    sim = titan.Simulation(titan.SimConfig(
        device="cpu", integrator=INTEGRATORS[integrator]))
    sim.createLattice(titan.Vec(0, 0, 2.0), titan.Vec(1, 1, 1), *dims)
    sim.setAllSpringConstantValues(700.0)
    st = sim._store
    n, s = st.n_masses, st.n_springs
    rng = np.random.RandomState(4)
    st.pos[:n] += 0.02 * rng.randn(n, 3)
    if deleted:
        st.valid[[0, 7, 11]] = False
    if perturb_rest:
        st.rest[:s] *= 1.0 + 0.05 * rng.rand(s)
    if feature == "damping":
        st.damping[:s] = 0.3
    elif feature == "breathing":
        st.s_type[: s // 2] = titan.ACTIVE_CONTRACT_THEN_EXPAND
        st.omega[: s // 2] = 7.0
    elif feature == "actuated":
        st.s_type[: s // 3] = titan.ACTUATED_EXPAND
        st.l_max[: s // 3] = st.rest[: s // 3] * 1.2
        st.rate[: s // 3] = 0.5
    elif feature == "nonuniform_k":
        st.k[:s] *= 1.0 + 0.1 * rng.rand(s)
    for q in range(links):
        sim.createSpring(sim.masses[q], sim.masses[n - 1 - q])
    sim._T = 0.0
    sim._marshal()
    return sim


def cotangents(n, seed=5):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(0, 1, (3, n)).astype(np.float32))
            for _ in range(3)]


def spring_bar(k, rest, pl, pr, fbar):
    """csrc/adjoint_body.cuh::spring_bar of a plain spring (no damping)
    after titan::spring_eval, on [3, N] endpoints, in the kernel's
    operation order: (dbar, gk, grest)."""
    diff = pr - pl
    d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    ln = torch.where(d2 > 0, torch.sqrt(d2), 0.0)
    inv = torch.where(ln > 0, 1.0 / torch.where(ln > 0, ln, 1.0), 0.0)
    cm = k * (rest - ln)
    cbar = fbar[0] * diff[0] + fbar[1] * diff[1] + fbar[2] * diff[2]
    dbar = fbar * (cm * inv)
    magbar = cbar * inv
    invbar = cbar * cm
    gk = magbar * (rest - ln)
    grest = magbar * k
    lnbar = -magbar * k
    lnbar = lnbar - torch.where(ln > 0, invbar * inv * inv, 0.0)
    d2bar = torch.where(inv > 0, 0.5 * lnbar * inv, 0.0)
    return dbar + 2.0 * diff * d2bar, gk, grest


def transpose_replay(deltas, pos, gf, bits, kscal, rest_at, gp):
    """plain_family_transpose for every mass at once: per family the own
    slot (i -> i + d) and the right slot (i - d -> i) at partner indices
    clamped to i outside [0, N), k from the left endpoint's bits, each
    slot's share selected where its partner index is in range.  Returns
    (gp, gk [F, N], grest [F, N]), the gradients 0 where no slot is."""
    n = pos.shape[1]
    i = torch.arange(n)
    gk = torch.zeros((len(deltas), n))
    grest = torch.zeros((len(deltas), n))
    for fi, d in enumerate(deltas):
        jin = (i + d >= 0) & (i + d < n)
        lin = (i - d >= 0) & (i - d < n)
        j = torch.where(jin, i + d, i)
        left = torch.where(lin, i - d, i)
        kl = kscal[fi] * ((bits >> fi) & 1).float()
        kr = kscal[fi] * ((bits[left] >> fi) & 1).float()
        own = spring_bar(kl, rest_at(fi, i), pos, pos[:, j],
                         -gf + gf[:, j])
        right = spring_bar(kr, rest_at(fi, left), pos[:, left], pos,
                           -gf[:, left] + gf)
        gp = torch.where(jin, gp - own[0], gp)
        gk[fi] = torch.where(jin, own[1], 0.0)
        grest[fi] = torch.where(jin, own[2], 0.0)
        gp = torch.where(lin, gp + right[0], gp)
    return gp, gk, grest


@pytest.mark.parametrize("dims", [(6, 5, 4), (3, 7, 2)])
@pytest.mark.parametrize("perturb_rest", [False, True])
@pytest.mark.parametrize("deleted", [False, True])
@pytest.mark.parametrize("integrator", ["euler", "verlet", "rk2"])
def test_plain_transpose_replay_bitwise(integrator, deleted, perturb_rest,
                                        dims, monkeypatch):
    """Each force transpose of the plain sweep over a 3-step trace: the
    replay from the same positions and force cotangent gives its position
    cotangent bitwise, and its k and rest gradients at every slot whose
    partner index is in range (bit or not), 0 elsewhere."""
    sim = lattice(integrator, deleted, perturb_rest, dims)
    shape, state = sim._shape, sim._state
    assert fused_step.takes_plain_spring_path(shape)
    assert shape.n_planes == 0 and shape.n_balls == 0
    inv = tiled_step.prep_tiled_inputs(shape, state)
    assert "rest" in inv or not perturb_rest
    kscal, bits = inv["fparams"][0], inv["bits"]
    if "rest" in inv:
        rest_at = lambda fi, m: inv["rest"][fi][m]  # noqa: E731
    else:
        rest_at = lambda fi, m: inv["fparams"][1][fi].expand(  # noqa: E731
            m.shape)
    calls, original = [], adjoint._force_transpose

    def spy(pos, vel, gf, gvel_mut, P, *args, **kw):
        out = original(pos, vel, gf, gvel_mut, P, *args, **kw)
        # RK2 adds pass 1's bars to pass 2's dict later: keep its lists now
        calls.append((pos, gf, out[0], out[2]["k"], out[2]["rest"]))
        return out
    monkeypatch.setattr(adjoint, "_force_transpose", spy)
    trace = adjoint_tiled.tiled_trace_run_plain(shape, state, 3)
    adjoint_tiled.tiled_bwd_run_plain(shape, state, trace,
                                      *cotangents(shape.n_masses), inv)
    assert len(calls) == 3 * (2 if integrator == "rk2" else 1)
    n = shape.n_masses
    i = torch.arange(n)
    in_range = torch.stack([(i + d >= 0) & (i + d < n)
                            for d in shape.stencil_deltas])
    assert int((~inv["pair_ok"] & in_range).sum()) > 0   # slots with bit 0
    for pos, gf, gpos, bar_k, bar_rest in calls:
        gp, gk, grest = transpose_replay(shape.stencil_deltas, pos, gf, bits,
                                         kscal, rest_at, torch.zeros_like(pos))
        assert bool(torch.isfinite(gp).all())
        assert torch.equal(gp, gpos)
        assert torch.equal(gk, torch.where(in_range, torch.stack(bar_k),
                                           0.0))
        assert torch.equal(grest, torch.where(in_range,
                                              torch.stack(bar_rest), 0.0))


@pytest.fixture
def stand_in_card(monkeypatch):
    """Runs ``adjoint_tiled._tiled_bwd_cuda`` on CPU tensors: the input
    checks take any device, the library is a stand-in whose
    ``titan_tiled_bwd`` records the structure it is handed and returns 0.
    Yields that record."""
    got = []

    def checked(name, t, shape, dtype=torch.float32, kernel="fused"):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name
        return t.data_ptr()

    def bwd(a, mega, gf_odd, stream):
        got.append((a._obj, mega))
        return 0
    for mod in (adjoint_tiled, fused_step, adjoint):
        monkeypatch.setattr(mod, "_checked", checked)
    monkeypatch.setattr(adjoint_tiled, "_device_index", lambda dev: 0)
    monkeypatch.setattr(adjoint_tiled, "_lib", lambda: types.SimpleNamespace(
        titan_tiled_bwd=bwd))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    yield got


@pytest.mark.parametrize("feature", ["plain", "links", "damping",
                                     "breathing", "actuated",
                                     "nonuniform_k"])
def test_bwd_plain_flag_follows_scene(feature, stand_in_card):
    """B7 (and B8 under Euler) take the plain-spring loop on plain springs
    with family-uniform k, links or not; damping, breathing, actuation and
    non-uniform k keep the general body.  ``plain_launches`` counts the
    launches that took the loop."""
    links = 4 if feature == "links" else 0
    sim = lattice(feature="plain" if links else feature, links=links)
    shape, state = sim._shape, sim._state
    plain = feature in ("plain", "links")
    assert fused_step.takes_plain_spring_path(shape) == plain
    assert shape.has_remainder == bool(links)
    inv = tiled_step.prep_tiled_inputs(shape, state)
    trace = adjoint_tiled.tiled_trace_run_plain(shape, state, 2)
    cts = cotangents(shape.n_masses)
    megas = [False] + [True] * adjoint_tiled.mega_adjoint_ok(shape)
    assert len(megas) == (1 if links else 2)
    run = adjoint_tiled.tiled_bwd_run
    for mega in megas:
        run.plain_launches = run.mega_launches = run.step_launches = 0
        adjoint_tiled._tiled_bwd_cuda(shape, state, trace, *cts, inv, mega)
        a, got_mega = stand_in_card[-1]
        assert got_mega == int(mega) and a.plain_springs == int(plain)
        assert (a.bits is not None) == (feature != "nonuniform_k")
        launches = run.mega_launches + run.step_launches
        assert launches == (1 if mega else 4)
        assert run.plain_launches == (launches if plain else 0)


def test_bwd_plain_flag_clears_after_uniform_break(stand_in_card):
    """A set() of one spring's k at a pause clears the family's uniform k:
    the predicate then refuses the scene and the backward's flag is
    clear, its k riding as a plane."""
    sim = lattice()
    sim.start()
    sim.wait(0.001)
    sim.getAll()
    sp = sim.springs[5]
    sp._k = 4 * sp._k
    sim.set(sp)
    shape, state = sim._shape, sim._snapshot()
    sim.stop()
    assert not fused_step.takes_plain_spring_path(shape)
    inv = tiled_step.prep_tiled_inputs(shape, state)
    trace = adjoint_tiled.tiled_trace_run_plain(shape, state, 2)
    adjoint_tiled._tiled_bwd_cuda(shape, state, trace,
                                  *cotangents(shape.n_masses), inv, False)
    a, _ = stand_in_card[-1]
    assert a.plain_springs == 0 and a.bits is None and a.k is not None


def c_struct_fields(source: str, name: str) -> list:
    """The field names of ``struct name { ... }`` in a C++ source, in
    order, up to its first member function."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body).split("__device__")[0]
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"\[[^\]]*\]", "", decl).strip()
        if not decl:
            continue
        first, *rest = decl.split(",")
        names.append(first.replace("*", " ").split()[-1])
        names += [r.strip() for r in rest]
    return names


def test_tiled_bwd_args_fields_match_c_struct():
    """``_TiledBwdArgs`` mirrors ``struct TiledBwdArgs`` field by field,
    in order, its last field the plain-spring flag."""
    src = (CSRC / "tiled_adjoint.cu").read_text()
    want = c_struct_fields(src, "TiledBwdArgs")
    got = [f for f, _ in adjoint_tiled._TiledBwdArgs._fields_]
    assert got == want
    assert want[-1] == "plain_springs" and "bits" in want
