"""The plain-spring path of the fused step and of the Euler / Verlet
resident grid: which scenes take it, its family-uniform k, and its family
loop replayed in torch.

- Which scenes take the path (``fused_step.takes_plain_spring_path``):
  plain springs and k uniform within every family; damping, breathing,
  actuation or a k that varies within a family send a scene to the
  kernels' general body.
- The path's k (``bits_k``: ``kscal`` x bit f of ``bits``) equals the
  validity-folded k plane bitwise, on a small lattice with deleted masses,
  and rides as a plane again after a uniform-breaking edit, as the tiled
  prep's does.
- A torch replay of ``csrc/step_body.cuh::plain_family_sum`` (partner
  indices clamped into [0, N), k from the left endpoint's existence bits,
  each spring added only where its partner exists) is bitwise the plain
  versions' family sum (``f - f_l + roll(f_l, d)`` over the validity-folded
  k plane), in the fused step's form (from the constant force, the rest
  plane) and the tiled grid's (from zero, the rest scalar where rest is
  uniform), with and without deleted masses and uniform rest.

The CUDA kernels are held bitwise against their plain versions on the card
by ``chip_smoke.py``.  Nothing here imports JAX: the plain versions are
compared with ``titan_tpu`` by tests/test_torch_fused_step.py and
tests/test_torch_tiled.py.
"""

import torch_threads  # noqa: F401  (before torch)

import numpy as np
import pytest
import torch

import titan_tpu_torch as titan
from titan_tpu_torch.ops import fused_step, tiled_step


def lattice_scene(deleted=True, dims=(6, 5, 4), perturb_rest=False):
    sim = titan.Simulation(titan.SimConfig(device="cpu"))
    sim.createLattice(titan.Vec(0, 0, 2.0), titan.Vec(1, 1, 1), *dims)
    sim.setAllSpringConstantValues(700.0)
    sim.createPlane(titan.Vec(0, 0, 1), 0)
    st = sim._store
    if deleted:
        st.valid[[0, 7, 11]] = False
    if perturb_rest:
        s = st.n_springs
        st.rest[:s] *= 1.0 + 0.05 * np.random.RandomState(3).rand(s)
    sim._T = 0.0
    sim._marshal()
    return sim


def kernel_k(shape, state):
    """(the fused prep, the [F, N] k the fused kernel reads): kscal[f] x
    bit f of ``fused_step.bits_k``'s bits where the scene takes the
    plain-spring path (as __fmul_rn in csrc/step_body.cuh::
    plain_family_sum), else the k plane."""
    inv = fused_step.prep_invariants(shape, state)
    if not fused_step.takes_plain_spring_path(shape):
        return inv, inv["k_eff"]
    kscal, bits = fused_step.bits_k(shape, state, inv)
    assert bits.dtype == torch.int32 and kscal.dtype == torch.float32
    on = torch.stack([(bits >> f) & 1
                      for f in range(len(shape.stencil_deltas))])
    return inv, kscal[:, None] * on.float()


def test_fused_uniform_k_rides_bits_bitwise():
    """kscal x bits is the validity-folded k plane bit for bit (deleted
    masses included); the tiled prep's scalars and bits are the same."""
    sim = lattice_scene()
    shape, state = sim._shape, sim._state
    assert shape.stencil_uniform[0] and not shape.all_valid
    assert fused_step.takes_plain_spring_path(shape)
    inv, k = kernel_k(shape, state)
    assert torch.equal(k, inv["k_eff"])
    assert int((inv["k_eff"] == 0).sum()) > 0
    kscal, bits = fused_step.bits_k(shape, state, inv)
    tinv = tiled_step.prep_tiled_inputs(shape, state)
    assert torch.equal(tinv["bits"], bits)
    assert torch.equal(tinv["fparams"][0], kscal)


def test_fused_k_rides_plane_after_uniform_break():
    """A set() of one spring's k at a pause clears the family's uniform k:
    the scene leaves the plain-spring path, and the fused kernel reads the k
    plane, which holds the edit, as the tiled prep does."""
    sim = lattice_scene(deleted=False)
    sim.start()
    sim.wait(0.001)
    sim.getAll()
    sp = sim.springs[5]
    sp._k = 4 * sp._k
    sim.set(sp)
    shape, state = sim._shape, sim._snapshot()
    sim.stop()
    assert not shape.stencil_uniform[0]
    assert not fused_step.takes_plain_spring_path(shape)
    inv, k = kernel_k(shape, state)
    fi, slot = int(sim._sp_family[5]), int(sim._sp_slot[5])
    assert float(k[fi, slot]) == 2800.0
    tinv = tiled_step.prep_tiled_inputs(shape, state)
    assert "bits" not in tinv and torch.equal(tinv["k"], inv["k_eff"])


@pytest.mark.parametrize("feature", ["plain", "damping", "breathing",
                                     "actuated", "nonuniform_k"])
def test_plain_spring_path_takes_plain_springs_only(feature):
    """The kernels' plain-spring loop takes a scene whose springs are plain
    and whose k rides the existence bits; damping, breathing, actuation or
    a k that varies within a family sends it to the general body, and then
    the tiled prep carries k as a plane or the spring features' inputs."""
    sim = titan.Simulation(titan.SimConfig(device="cpu"))
    sim.createLattice(titan.Vec(0, 0, 2.0), titan.Vec(1, 1, 1), 6, 5, 4)
    sim.setAllSpringConstantValues(700.0)
    st = sim._store
    s = st.n_springs
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
        st.k[:s] *= 1.0 + 0.1 * np.random.RandomState(1).rand(s)
    sim._T = 0.0
    sim._marshal()
    shape = sim._shape
    plain = feature == "plain"
    assert fused_step.takes_plain_spring_path(shape) == plain
    tinv = tiled_step.prep_tiled_inputs(shape, sim._state)
    assert ("bits" in tinv) == (feature != "nonuniform_k")
    assert any(key in tinv for key in ("damping", "bsign", "arate", "k")) \
        == (not plain)


def plain_spring(k, rest, pl, pr):
    """csrc/step_body.cuh::plain_spring on [3, N] endpoints: the force on
    the right endpoint, in the kernel's operation order."""
    diff = pr - pl
    d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    ln = torch.where(d2 > 0, torch.sqrt(d2), 0.0)
    inv = torch.where(ln > 0, 1.0 / torch.where(ln > 0, ln, 1.0), 0.0)
    return diff * ((k * (rest - ln)) * inv)


def plain_loop_replay(deltas, pos, bits, kscal, rest_at, f):
    """csrc/step_body.cuh::plain_family_sum for every mass at once: per
    family, partners i + d and i - d clamped to i outside [0, N), k =
    kscal[f] x bit f of the left endpoint's word, rest ``rest_at(f, m)``,
    "- left + right" each only where its partner exists."""
    n = pos.shape[1]
    i = torch.arange(n)
    for fi, d in enumerate(deltas):
        jin = (i + d >= 0) & (i + d < n)
        lin = (i - d >= 0) & (i - d < n)
        j = torch.where(jin, i + d, i)
        left = torch.where(lin, i - d, i)
        kl = kscal[fi] * ((bits >> fi) & 1).float()
        kr = kscal[fi] * ((bits[left] >> fi) & 1).float()
        fl = plain_spring(kl, rest_at(fi, i), pos, pos[:, j])
        fr = plain_spring(kr, rest_at(fi, left), pos[:, left], pos)
        f = torch.where(jin, f - fl, f)
        f = torch.where(lin, f + fr, f)
    return f


def roll_family_sum(deltas, pos, k_plane, rest_plane, f):
    """The plain versions' family sum (``fused_chunk_plain``'s loop for
    plain springs): f - f_l + roll(f_l, d) per family, the wrapped lanes
    carrying k = 0."""
    for fi, d in enumerate(deltas):
        diff = torch.roll(pos, -d, dims=-1) - pos
        ln = torch.sqrt(torch.sum(diff * diff, dim=0))
        inv = torch.where(ln > 0, 1.0 / torch.where(ln > 0, ln, 1.0), 0.0)
        fs = ((k_plane[fi] * (rest_plane[fi] - ln)) * inv) * diff
        f = f - fs + torch.roll(fs, d, dims=-1)
    return f


@pytest.mark.parametrize("form", ["fused", "tiled"])
@pytest.mark.parametrize("perturb_rest", [False, True])
@pytest.mark.parametrize("deleted", [False, True])
@pytest.mark.parametrize("dims", [(6, 5, 4), (3, 7, 2)])
def test_plain_loop_replay_bitwise(form, perturb_rest, deleted, dims):
    """The plain-spring loop's arithmetic, on the inputs each kernel is
    given, is bitwise the plain versions' family sum: the fused step's
    from the constant force with the rest plane, the tiled grid's from
    zero with the rest scalar where rest is uniform in every family."""
    sim = lattice_scene(deleted, dims, perturb_rest)
    shape, state = sim._shape, sim._state
    assert fused_step.takes_plain_spring_path(shape)
    uniform_rest = bool(shape.stencil_uniform[1])
    assert not (perturb_rest and uniform_rest)
    torch.manual_seed(0)
    pos = state.masses.pos + 0.02 * torch.randn_like(state.masses.pos)
    inv = fused_step.prep_invariants(shape, state)
    rest = state.stencil.rest.float()
    deltas = shape.stencil_deltas
    if form == "fused":
        kscal, bits = fused_step.bits_k(shape, state, inv)
        f0 = inv["const_f"].float()
        rest_at = lambda fi, m: rest[fi][m]  # noqa: E731
    else:
        tinv = tiled_step.prep_tiled_inputs(shape, state)
        kscal, bits = tinv["fparams"][0], tinv["bits"]
        f0 = torch.zeros_like(pos)
        assert ("rest" in tinv) != uniform_rest
        if not uniform_rest:
            rest_at = lambda fi, m: tinv["rest"][fi][m]  # noqa: E731
        else:
            rest_at = lambda fi, m: tinv["fparams"][1][fi].expand(  # noqa: E731
                m.shape)
    got = plain_loop_replay(deltas, pos, bits, kscal, rest_at, f0)
    want = roll_family_sum(deltas, pos, inv["k_eff"], rest, f0)
    assert bool(torch.isfinite(got).all())
    assert int((inv["k_eff"] == 0).sum()) > 0
    assert torch.equal(got, want)
