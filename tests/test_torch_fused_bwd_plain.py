"""The fused adjoint's backward on the plain-spring path, and the magnet
transpose's summation order.

- Which scenes hand the fused backward (``ops/adjoint.py::_bwd_run_cuda``)
  the plain-spring path's k (``kscal``, ``bits``: ``fused_step.bits_k``):
  the wrapper runs on the CPU against a stand-in for the library, which
  records the structure it is handed.  Plain springs with family-uniform
  k set them (links too); damping, breathing, actuation and non-uniform k
  leave them null, as does a scene after a uniform-breaking
  ``Spring.set``.  The folded sweep's second gf buffer (``gf_odd``) is set
  exactly where the plain-spring path folds (no magnets).
- ``bwd_run.launches`` and ``bwd_run.plain_launches`` follow the launch
  formula of each integrator, with and without magnets.
- ``_BwdArgs._fields_`` names ``struct BwdChunkArgs``'s fields in
  ``csrc/adjoint.cu``, in order, its last two the plain-spring path's k.
- ``magnets.magnet_transpose_plain`` in the kernel's slot order agrees in
  float64 with autograd through ``pairwise_field_lanes`` on a cloud whose
  acting pairs cross slot and chunk boundaries, with coincident, frozen
  and invalid masses; and a loop over the kernel's clusters, warps and
  pieces of 32 sources (``csrc/magnets_adjoint.cuh``) sums in its order.
  Its default slot count ``MAG_SLOTS`` is the kernel's kWarps x kCluster.

The CUDA kernels are held against ``bwd_run_plain`` and
``magnet_transpose_plain`` on the card by ``chip_smoke.py``.  Nothing here
imports JAX: tests/test_torch_adjoint*.py hold the plain versions against
``titan_tpu``.
"""

import torch_threads  # noqa: F401  (before torch)

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import titan_tpu_torch as titan
from titan_tpu_torch.ops import adjoint, fused_step, magnets
from titan_tpu_torch.state import MassState

from test_torch_plain_transpose import c_struct_fields

CSRC = Path(adjoint.__file__).resolve().parent.parent / "csrc"
INTEGRATORS = {"euler": titan.Integrator.EULER,
               "verlet": titan.Integrator.VERLET,
               "rk2": titan.Integrator.RK2}


def lattice(integrator="euler", feature="plain", links=0, magnets_on=False,
            dims=(5, 4, 4)):
    """A lattice in the air, marshalled on the CPU, with one feature."""
    sim = titan.Simulation(titan.SimConfig(
        device="cpu", integrator=INTEGRATORS[integrator]))
    sim.createLattice(titan.Vec(0, 0, 2.0), titan.Vec(1, 1, 1), *dims)
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
    for q in range(links):
        sim.createSpring(sim.masses[q], sim.masses[n - 1 - q])
    if magnets_on:
        st.mag_maxf[:n] = 1e-3
        st.mag_rad[:n] = 0.05
    sim.setGlobalAcceleration(titan.Vec(0, 0, -9.8))
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim


def cotangents(n, seed=3):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(0, 1, (3, n)).astype(np.float32))
            for _ in range(3)]


@pytest.fixture
def stand_in_card(monkeypatch):
    """Runs ``adjoint._bwd_run_cuda`` on CPU tensors: the input checks take
    any device, the library is a stand-in whose ``titan_adjoint_bwd``
    records the structure it is handed and returns 0.  Yields that
    record."""
    got = []

    def checked(name, t, shape, dtype=torch.float32, kernel="fused"):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name
        return t.data_ptr()

    def bwd(a, stream):
        got.append(a._obj)
        return 0
    for mod in (adjoint, fused_step):
        monkeypatch.setattr(mod, "_checked", checked)
    monkeypatch.setattr(adjoint, "_lib", lambda: types.SimpleNamespace(
        titan_adjoint_bwd=bwd))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    yield got


def run_stand_in(sim, seg, record, state=None):
    """One segment's backward through the stand-in: (the structure handed
    to the library, launches, plain-spring launches)."""
    shape, state = sim._shape, state or sim._state
    run = adjoint.bwd_run
    run.launches = run.plain_launches = 0
    trace = adjoint.trace_run_plain(shape, state, seg)
    adjoint._bwd_run_cuda(shape, state, trace, *cotangents(shape.n_masses),
                          None)
    return record[-1], run.launches, run.plain_launches


@pytest.mark.parametrize("feature", ["plain", "links", "damping",
                                     "breathing", "actuated",
                                     "nonuniform_k"])
def test_bwd_plain_k_follows_scene(feature, stand_in_card):
    """kscal and bits reach the C structure on plain springs with
    family-uniform k, links or not, and match ``bits_k``; damping,
    breathing, actuation and non-uniform k leave them null (the general
    body), and the folded sweep's second gf buffer with them."""
    links = 3 if feature == "links" else 0
    sim = lattice(feature="plain" if links else feature, links=links)
    shape = sim._shape
    plain = feature in ("plain", "links")
    assert fused_step.takes_plain_spring_path(shape) == plain
    assert shape.has_remainder == bool(links)
    a, launches, on_loop = run_stand_in(sim, 3, stand_in_card)
    for field in ("kscal", "bits", "gf_odd"):
        assert (getattr(a, field) is not None) == plain, field
    assert a.k is not None and a.rest is not None
    assert launches == (4 if plain else 6)
    assert on_loop == (launches if plain else 0)
    if plain:
        inv = fused_step.prep_invariants(shape, sim._state)
        kscal, bits = fused_step.bits_k(shape, sim._state, inv)
        ks = torch.stack([kscal[f] * ((bits >> f) & 1).float()
                          for f in range(len(kscal))])
        assert torch.equal(ks, inv["k_eff"])


def test_bwd_plain_k_clears_after_uniform_break(stand_in_card):
    """A set() of one spring's k at a pause clears the family's uniform k:
    the backward then takes the general body, k riding as the plane
    alone."""
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
    a, launches, on_loop = run_stand_in(sim, 2, stand_in_card, state)
    assert a.kscal is None and a.bits is None and a.gf_odd is None
    assert a.k is not None and (launches, on_loop) == (4, 0)


@pytest.mark.parametrize("magnets_on", [False, True])
@pytest.mark.parametrize("integrator", ["euler", "verlet", "rk2"])
def test_bwd_launch_counts(integrator, magnets_on, stand_in_card):
    """The launches of one segment of 5 steps: seg + 1 folded (Euler,
    Verlet), 3 seg + 1 (RK2), all on the plain-spring loop; a magnet
    scene's transpose reads every mass's gf between the phases, so it
    keeps two a step (five under RK2), on the loop too."""
    seg = 5
    sim = lattice(integrator, magnets_on=magnets_on)
    shape = sim._shape
    assert shape.has_magnets == magnets_on
    assert fused_step.takes_plain_spring_path(shape)
    rk2 = integrator == "rk2"
    if magnets_on:
        want = seg * (5 if rk2 else 2)
    else:
        want = 3 * seg + 1 if rk2 else seg + 1
    a, launches, on_loop = run_stand_in(sim, seg, stand_in_card)
    assert (a.gf_odd is None) == magnets_on
    assert (a.mag is not None) == magnets_on
    assert launches == on_loop == want
    assert adjoint.bwd_launch_count(shape, seg) == (want, want)


def test_bwd_args_fields_match_c_struct():
    """``_BwdArgs`` mirrors ``struct BwdChunkArgs`` field by field, in
    order, its last two fields the plain-spring path's k."""
    src = (CSRC / "adjoint.cu").read_text()
    want = c_struct_fields(src, "BwdChunkArgs")
    got = [f for f, _ in adjoint._BwdArgs._fields_]
    assert got == want
    assert want[-2:] == ["kscal", "bits"] and "gf_odd" in want


def cloud(n=70, seed=2, dtype=torch.float64):
    """A magnet cloud packed so that each mass has several partners inside
    the 0.14 m cutoff, spread over the index range; masses 5 and 6 share
    a position, mass 9 with them, a tenth of them are frozen and some
    invalid."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dtype)
    pos = rng.uniform(-0.15, 0.15, (3, n))
    pos[:, 6] = pos[:, 5]
    pos[:, 9] = pos[:, 5]
    valid = rng.uniform(0, 1, n) < 0.9
    valid[[5, 6]] = True
    m = MassState(
        pos=t(pos), vel=t(np.zeros((3, n))), acc=t(np.zeros((3, n))),
        m=t(np.ones(n)), extern_force=t(np.zeros((3, n))),
        fixed=torch.from_numpy(rng.uniform(0, 1, n) < 0.1),
        valid=torch.from_numpy(valid), T=t(np.zeros(n)),
        drag=t(np.zeros(n)),
        mag_rad=t(rng.uniform(0.0, 0.05, n)),
        mag_stiffness=t(rng.uniform(0, 200, n)),
        mag_maxf=t(rng.uniform(0, 1e-3, n) * (rng.uniform(0, 1, n) < 0.8)),
        mag_scale=t(rng.uniform(0, 1.5, n)))
    return m.pos, magnets.pairwise_params(m), m.fixed.to(dtype)


@pytest.mark.parametrize("slots,chunk", [(32, None), (4, 18), (3, 32),
                                         (8, 9)])
def test_transpose_plain_matches_autograd(slots, chunk):
    """The slot-ordered transpose is the vjp of the pairwise field, in
    float64 at 1e-9, whatever the slots and chunk: its acting pairs
    (coincident ones among them) cross the slot boundaries."""
    pos, prm, fixed = cloud()
    n, cut = pos.shape[1], 0.14
    d = pos[:, :, None] - pos[:, None, :]
    near = torch.sqrt((d * d).sum(0)) < cut
    ch = chunk or magnets.transpose_chunk(n, slots)
    slot = torch.arange(n) // ch
    across = near & (slot[:, None] != slot[None, :])
    assert int(across.sum()) > n      # pairs across slots, many
    rng = np.random.RandomState(4)
    gf = torch.from_numpy(rng.normal(0, 1, (3, n)))
    x = pos.clone().requires_grad_()
    p4 = prm[:4].clone().requires_grad_()
    field = magnets.pairwise_field_lanes(x, torch.cat([p4, prm[4:]]), cut)
    want = torch.autograd.grad(torch.sum(field * (1.0 - fixed) * gf),
                               [x, p4])
    gp, g4 = magnets.magnet_transpose_plain(pos, prm, fixed, gf, cut,
                                            slots=slots, chunk=chunk)
    assert float(want[1].abs().max()) > 0 and bool(torch.isfinite(gp).all())
    for name, a, b in (("gpos", gp, want[0]), ("params", g4, want[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


def test_transpose_plain_rejects_short_cover():
    pos, prm, fixed = cloud(n=40)
    with pytest.raises(ValueError, match="do not cover"):
        magnets.magnet_transpose_plain(pos, prm, fixed, pos, 0.14, slots=2,
                                       chunk=16)


def kernel_loop(pos, prm, fixed, gf, cutoff, warps, cluster):
    """The transpose kernel's loop nest, one receiver at a time: each
    cluster rank's warps take slots rank x warps + w of chunk sources, 32
    at a time (which act, then their terms in order), and the first rank
    sums the slots' partial sums in order.  Float64: a pair acts where
    sqrt(d2) < cutoff, as ``magnet_transpose_plain`` tests it in that
    dtype."""
    n = pos.shape[1]
    slots = warps * cluster
    chunk = magnets.transpose_chunk(n, slots)
    gfm = gf * (1.0 - fixed)
    bar = magnets._pair_bar
    out = torch.zeros((7, n), dtype=pos.dtype)
    for i in range(n):
        part = []
        for rank in range(cluster):
            for w in range(warps):
                lo = min((rank * warps + w) * chunk, n)
                hi = min(lo + chunk, n)
                acc = torch.zeros(7, dtype=pos.dtype)
                for base in range(lo, hi, 32):
                    for j in range(base, min(base + 32, hi)):
                        d = pos[:, i] - pos[:, j]
                        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                        dist = torch.sqrt(d2) if d2 > 0 else d2 * 0.0
                        if not (prm[4, i] != 0 and prm[4, j] != 0 and j != i
                                and dist < cutoff):
                            continue
                        safe = dist if dist > 0 else dist * 0.0 + 1.0
                        md = torch.clamp(d2, min=1e-12)
                        inter = dist - (prm[0, i] + prm[0, j])
                        r = bar(d, d2, dist, safe, md, inter, prm[1, i],
                                prm[2, i], prm[3, j], gfm[:, i])
                        s = bar(-d, d2, dist, safe, md, inter, prm[1, j],
                                prm[2, j], prm[3, i], gfm[:, j])
                        acc = torch.cat([acc[:3] + r[0] - s[0],
                                         (acc[3] - r[1] - s[1])[None],
                                         (acc[4] + r[2])[None],
                                         (acc[5] + r[3])[None],
                                         (acc[6] + s[4])[None]])
                part.append(acc)
        tot = torch.zeros(7, dtype=pos.dtype)
        for q in part:
            tot = tot + q
        out[:, i] = tot
    return out


@pytest.mark.parametrize("warps,cluster", [(8, 4), (7, 2)])
def test_transpose_plain_sums_in_kernel_order(warps, cluster):
    """``magnet_transpose_plain`` with the kernel's slots adds the terms in
    the kernel's loop nest's order (float64: the two round alike)."""
    pos, prm, fixed = cloud(n=45)
    rng = np.random.RandomState(5)
    gf = torch.from_numpy(rng.normal(0, 1, (3, 45)))
    gp, g4 = magnets.magnet_transpose_plain(pos, prm, fixed, gf, 0.14,
                                            slots=warps * cluster)
    want = kernel_loop(pos, prm, fixed, gf, 0.14, warps, cluster)
    assert float(want.abs().max()) > 0
    assert torch.equal(gp, want[:3]) and torch.equal(g4, want[3:])


def test_transpose_slots_match_kernel():
    """The plain version's default slots are the kernel's: kWarps x
    kCluster in ``csrc/magnets_adjoint.cuh`` is ``magnets.MAG_SLOTS``, so
    the CPU path and the card sum in one order."""
    src = (CSRC / "magnets_adjoint.cuh").read_text()
    const = dict(re.findall(r"constexpr int (kWarps|kCluster) = (\d+);", src))
    assert set(const) == {"kWarps", "kCluster"}
    assert int(const["kWarps"]) * int(const["kCluster"]) == magnets.MAG_SLOTS
    assert "kSlots = kWarps * kCluster;" in src
