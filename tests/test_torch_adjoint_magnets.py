"""The fused adjoint's magnet branches (``titan_tpu_torch/ops/adjoint.py``,
``ops/magnets.py``) against the JAX package.

- ``adjoint_rollout`` (its plain versions on the CPU) against ``jax.grad``
  through ``titan_tpu.diff.rollout`` of ``xla_only_shape`` (the exact
  pairwise XLA path), 20 steps in segments of 10, on tests/test_adjoint.py's
  ``MAG_SCENES`` (their flags on a 5 x 5 x 1 sheet) with that file's
  magnet setup (fat shell magnets and
  pull-only attractors; a deleted mass carrying magnet parameters) and a
  cutoff that reaches the lattice's neighbours (at the default 0.14 m no
  pair of that 4^3 lattice interacts), over
  pos, vel and the four per-mass magnet parameters, at that file's
  normalised atol 5e-4, masked by validity;
- the pairwise field in the kernel's summation order
  (``magnets.pairwise_field_lanes``) against ``forces.magnet_forces``, and
  the plain transpose (``magnets.magnet_transpose_plain``, the B5 kernel's
  order) against autograd through it, in f64 at 1e-9, with deleted,
  fixed and zero-parameter masses;
- ``backward_step`` is the VJP of ``forward_step`` on a marshalled
  RobotLink scene (f64, 1e-9): the magnet rows of the staged parameters;
- ``trace_run_plain`` of a magnet scene holds each step's input and each
  force pass's constant force (``const_f + field``), and replays the chunk
  bitwise;
- routes on shapes: the 1,024-link RobotLink swarm takes the fused step
  and adjoint, a 64^3 magnet lattice with links the tiled ones, the
  spring-less 50k swarm the fused step and ``fast_rollout``.

Small tensors: torch runs these on one thread.
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu import diff as jdiff
from titan_tpu.state import xla_only_shape
from titan_tpu_torch import diff as tdiff
from titan_tpu_torch.ops import adjoint as tadj
from titan_tpu_torch.ops import forces as F
from titan_tpu_torch.ops import fused_step, magnets
from titan_tpu_torch.ops import step as tstep
from titan_tpu_torch.state import MassState

import test_adjoint
from test_torch_magnet_scenes import link_scene, swarm_scene
from test_torch_step import carry_over, jax_grad_ref
from test_torch_tiled import _lattice_shape

MAG_ARGS = ("mag_rad", "mag_stiffness", "mag_maxf", "mag_scale")


# tests/test_adjoint.py's magnet scenes are a 4^3 lattice 0.333 m apart:
# at the default 0.14 m cutoff no pair interacts and every magnet gradient
# is 0 in both packages, so here the cutoff reaches the nearest neighbours
MAG_CUTOFF = 0.5


def _mag_scene(name):
    """tests/test_adjoint.py's magnet scene ``name`` (its ``_scene`` for the
    MAG_SCENES flags: k 800, rest x 1.03, damping, deleted masses 3 and
    17, a 0.4 / 0.6 friction plane, the integrator; and that file's magnet
    setup, :708-716) on a 5 x 5 x 1 sheet 0.25 m apart in place of its 4^3
    lattice (the JAX reference of a 4-family sheet compiles in a third of
    a 13-family lattice's time), with ``magnet_cutoff`` MAG_CUTOFF;
    marshalled in titan_tpu."""
    kw = test_adjoint.MAG_SCENES[name]
    cfg = dict(velocity_clamp=False, magnet_cutoff=MAG_CUTOFF)
    if kw.get("integrator"):
        cfg["integrator"] = titan_tpu.Integrator(kw["integrator"])
    Vec = titan_tpu.Vec
    sim = titan_tpu.Simulation(titan_tpu.SimConfig(**cfg))
    sim.createLattice(Vec(0, 0, 2), Vec(1, 1, 0), 5, 5, 1)
    sim.setAllSpringConstantValues(800.0)
    st = sim._store
    st.rest[: st.n_springs] *= 1.03
    st.damping[: st.n_springs] = kw.get("damping", 0.0)
    if kw.get("deleted"):
        st.valid[[3, 17]] = False
    sim.createPlane(Vec(0, 0, 1), 0, *((0.4, 0.6) if kw.get("friction")
                                       else ()))
    sim.setTimeStep(1e-4)
    sim.setGlobalAcceleration(Vec(0, 0, -9.8))
    st.mag_rad[:6] = 0.35
    st.mag_stiffness[:6] = 5.0
    st.mag_maxf[:10] = 0.5
    st.mag_scale[:10] = 1.0
    if kw.get("deleted"):
        st.mag_maxf[3] = 2.0                 # deleted mass 3 with params
    sim._T = 0.0
    sim._marshal()
    return sim


def _with_mag(state, args):
    pos, vel, *mag = args
    return dataclasses.replace(state, masses=dataclasses.replace(
        state.masses, pos=pos, vel=vel, **dict(zip(MAG_ARGS, mag))))


@pytest.mark.parametrize("scene", sorted(test_adjoint.MAG_SCENES))
def test_magnet_grads_match_jax(scene):
    jsim = _mag_scene(scene)
    jshape, jstate = jsim._shape, jsim._state
    assert jshape.has_magnets and not jshape.magnet_binned
    n = jsim._store.n_masses
    npad = jstate.masses.pos.shape[1]
    rng = np.random.RandomState(9)
    wpos, wvel = (rng.normal(0, 1, (3, npad)).astype(np.float32)
                  for _ in range(2))
    wpos[:, n:] = 0.0
    wvel[:, n:] = 0.0
    steps = 20

    def jloss(*args):
        out = jdiff.rollout(xla_only_shape(jshape), _with_mag(jstate, args),
                            steps)
        return jnp.sum(out.masses.pos * wpos) + jnp.sum(out.masses.vel * wvel)

    m = jstate.masses
    jargs = (m.pos, m.vel) + tuple(getattr(m, k) for k in MAG_ARGS)
    want = jax_grad_ref(jloss, tuple(range(len(jargs))), jargs)

    shape, state = carry_over(jsim)
    assert tdiff.grad_route(shape) == ("adjoint", None)
    args = [t.clone().requires_grad_() for t in (
        state.masses.pos, state.masses.vel) + tuple(
        getattr(state.masses, k) for k in MAG_ARGS)]
    out = tdiff.grad_rollout(shape, _with_mag(state, args), steps,
                             segment=10)
    loss = (torch.sum(out.masses.pos * torch.from_numpy(wpos))
            + torch.sum(out.masses.vel * torch.from_numpy(wvel)))
    got = torch.autograd.grad(loss, args)
    valid = state.masses.valid.numpy()
    for name, a, x in zip(("pos", "vel") + MAG_ARGS, got, want):
        a, x = a.numpy(), np.asarray(x)
        assert np.isfinite(a).all(), f"grad[{name}] not finite"
        if name in ("pos", "vel"):
            a, x = a[:, :n], x[:, :n]
        else:
            assert not np.any(a[~valid]), name
            x = x * valid
        scale = max(np.abs(x).max(), 1e-8)
        assert np.abs(x).max() > 0, f"grad[{name}] is 0: nothing to hold"
        np.testing.assert_allclose(a / scale, x / scale, atol=5e-4,
                                   err_msg=f"grad[{name}] mismatch")


def _cloud(n=150, seed=3, dtype=torch.float64):
    """A random magnet cloud with deleted, fixed and zero-parameter
    masses: (pos, folded params [5, N], fixed [N], masses)."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    valid = rng.uniform(0, 1, n) < 0.9
    m = MassState(
        pos=t(rng.uniform(-0.3, 0.3, (3, n))), vel=t(np.zeros((3, n))),
        acc=t(np.zeros((3, n))), m=t(np.ones(n)),
        extern_force=t(np.zeros((3, n))), fixed=torch.from_numpy(
            rng.uniform(0, 1, n) < 0.1), valid=torch.from_numpy(valid),
        T=t(np.zeros(n)), drag=t(np.zeros(n)),
        mag_rad=t(rng.uniform(0.0, 0.05, n) * (rng.uniform(0, 1, n) < 0.7)),
        mag_stiffness=t(rng.uniform(0, 200, n)),
        mag_maxf=t(rng.uniform(0, 1e-3, n) * (rng.uniform(0, 1, n) < 0.7)),
        mag_scale=t(rng.uniform(0, 1.5, n)))
    return m.pos, magnets.pairwise_params(m), m.fixed.to(dtype), m


def test_field_and_transpose_plain_in_kernel_order():
    pos, prm, fixed, m = _cloud()
    cut = 0.14
    got = magnets.pairwise_field_lanes(pos, prm, cut)
    np.testing.assert_allclose(got.numpy(), F.magnet_forces(m, cut).numpy(),
                               rtol=1e-12, atol=1e-12)
    rng = np.random.RandomState(4)
    gf = torch.from_numpy(rng.normal(0, 1, pos.shape))
    pos = pos.clone().requires_grad_()
    p4 = prm[:4].clone().requires_grad_()
    field = magnets.pairwise_field_lanes(pos, torch.cat([p4, prm[4:]]), cut)
    want = torch.autograd.grad(torch.sum(field * (1.0 - fixed) * gf),
                               [pos, p4])
    gp, g4 = magnets.magnet_transpose_plain(pos.detach(), prm, fixed, gf,
                                            cut)
    assert float(want[1].abs().max()) > 0
    for name, a, b in (("gpos", gp, want[0]), ("params", g4, want[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=name)
    # the wrapper runs the plain version for state on the CPU
    w = magnets.magnet_transpose(pos.detach(), prm, fixed, gf, cut)
    assert torch.equal(w[0], gp) and torch.equal(w[1], g4)


@pytest.mark.parametrize("integrator", ["EULER", "RK2"])
def test_backward_step_is_vjp_on_robotlinks(integrator):
    jsim = link_scene(titan_tpu, n_links=6, integrator=integrator,
                      magnetic_force=0.5)
    shape, state = carry_over(jsim)
    P = tadj._prep(shape, state)

    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) \
            and v.is_floating_point() else v

    P = {k: (tuple(f64(c) for c in v) if isinstance(v, tuple)
             else [tuple(f64(c) for c in x) for x in v]
             if isinstance(v, list) else f64(v)) for k, v in P.items()}
    m = state.masses
    pos, vel, acc = (t.double() for t in (m.pos, m.vel, m.acc))
    rng = np.random.RandomState(5)
    vel = vel + torch.from_numpy(rng.normal(0, 0.3, vel.shape))
    gp2, gv2, ga2 = (torch.from_numpy(rng.normal(0, 1, pos.shape))
                     for _ in range(3))
    rg, rs = tadj.torch_rolls()
    t_now = torch.tensor(0.37, dtype=torch.float64)
    prm = P["mag"]

    def fwd(pos, vel, acc, p4):
        Pv = {**P, "mag": torch.cat([p4, prm[4:]])}
        return tadj.forward_step(pos, vel, acc, Pv, rg, rs, t_now, s_idx=3.0)

    _, vjp = torch.func.vjp(fwd, pos, vel, acc, prm[:4])
    gpos_v, gvel_v, gacc_v, g4_v = vjp((gp2, gv2, ga2))
    gpos, gvel, gacc, bars = tadj.backward_step(pos, vel, gp2, gv2, ga2, P,
                                                rg, rs, t_now, s_idx=3.0)
    tol = dict(rtol=1e-9, atol=1e-9)
    for name, a, b in (("gpos", gpos, gpos_v), ("gvel", gvel, gvel_v),
                       ("gacc_prev", gacc, gacc_v)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **tol)
    for row, bar in enumerate(tadj.MAG_BARS):
        np.testing.assert_allclose(bars[bar].numpy(), g4_v[row].numpy(),
                                   err_msg=bar, **tol)
    assert float(g4_v[2].abs().max()) > 0


@pytest.mark.parametrize("integrator", ["EULER", "VERLET", "RK2"])
def test_trace_replays_magnet_chunk_bitwise(integrator):
    shape, state = carry_over(link_scene(titan_tpu, n_links=6,
                                         integrator=integrator,
                                         magnetic_force=0.5))
    seg = 5
    trace = tadj.trace_run(shape, state, seg)           # CPU: plain version
    rk2 = integrator == "RK2"
    assert trace.shape == (seg, 12 if rk2 else 9, shape.n_masses)
    assert tadj.trace_rows(shape) == trace.shape[1]
    field = fused_step.magnet_field_fn(shape, state, plain=True)
    inv = fused_step.prep_invariants(shape, state)
    for s in range(seg):
        prev = fused_step.fused_chunk_plain(shape, state, s)
        x = torch.cat([prev.masses.pos, prev.masses.vel])
        assert torch.equal(trace[s, :6], x), s
        assert torch.equal(trace[s, 6:9],
                           inv["const_f"] + field(prev.masses.pos)), s
    last = fused_step.fused_chunk_plain(shape, state, seg)
    step = dataclasses.replace(prev, masses=dataclasses.replace(
        prev.masses, pos=trace[-1, :3].clone(), vel=trace[-1, 3:6].clone()))
    again = fused_step.fused_chunk_plain(shape, step, 1)
    for f in ("pos", "vel"):
        assert torch.equal(getattr(again.masses, f),
                           getattr(last.masses, f)), f


def test_magnet_routes_on_shapes():
    """As the reference routes them (magnet_pallas_max, the pairwise
    temporaries' budget, the residency rules)."""
    links, _ = carry_over(link_scene(titan_tpu, n_links=4))
    swarm1024 = dataclasses.replace(links, n_masses=2048, n_springs=1024)
    assert swarm1024.stencil_deltas == (1,)
    assert tstep.chunk_route(swarm1024) == ("fused", None)
    assert tdiff.grad_route(swarm1024) == ("adjoint", None)
    one_more = dataclasses.replace(swarm1024, n_masses=2049)
    assert tstep.chunk_route(one_more) == ("tiled", None)
    assert tdiff.grad_route(one_more) == ("tiled_adjoint", None)
    # scripts/tpu_soak.py's flow 6: 64^3, 10,000 magnets (binned, grid
    # field), 50 links
    soak = _lattice_shape(64, has_magnets=True, magnet_binned=(262144, 16),
                          magnet_grid=True, has_remainder=True, n_springs=50,
                          max_degree=1)
    assert tstep.chunk_route(soak) == ("tiled", None)
    assert tdiff.grad_route(soak) == ("tiled_adjoint", None)
    # the pairwise temporaries' budget alone: with magnet_pallas_max
    # raised, 8,192 masses fill the 16 MiB and 8,320 exceed it
    cfg = dataclasses.replace(links.config, magnet_pallas_max=10 ** 6)
    wide = dataclasses.replace(links, n_masses=65 * 128, config=cfg)
    assert tstep.magnet_pair_bytes(wide) > tstep.MAGNET_PAIR_BUDGET
    assert tstep.chunk_route(wide) == ("tiled", None)
    assert tstep.chunk_route(dataclasses.replace(
        wide, n_masses=64 * 128))[0] == "fused"
    # the spring-less swarm: no tiled step or adjoint takes it
    sw, _ = carry_over(swarm_scene())
    sw50k = dataclasses.replace(sw, n_masses=50048,
                                magnet_binned=(50048, 16))
    assert tstep.chunk_route(sw50k) == ("fused", None)
    route, reason = tdiff.grad_route(sw50k)
    assert route == "fast" and "no stencil spring families" in reason


# the tiled adjoint (f32) against autograd through the eager rollout, of
# each gradient's max: the two forwards round differently
TOL_EAGER = 1e-5


@pytest.mark.parametrize("case", ["binned", "past_magnet_pallas_max"])
def test_adjoint_refuses_magnets_outside_its_envelope(case):
    """The fused adjoint's transpose is the all-pairs field's: a binned
    scene (128 RobotLink masses, some cells past the binned pass's 16-source
    cap, where the binned field is a different function) and a scene past
    ``magnet_pallas_max`` raise in ``adjoint_rollout``; ``grad_rollout``
    takes the tiled adjoint, whose gradients over pos, vel and the four
    magnet parameters match autograd through the eager rollout (the binned
    pass, or all pairs) at TOL_EAGER of each gradient's max."""
    sim = link_scene(titan_tpu_torch, n_links=64, binned=case == "binned",
                     magnetic_force=0.5)
    shape, state = sim._shape, sim._state
    if case == "binned":
        m = state.masses
        assert shape.magnet_binned
        assert not torch.allclose(
            tstep.magnet_pass(m, shape),
            F.magnet_forces(m, shape.config.magnet_cutoff)), \
            "no neighbourhood overflows its cap"
        reason = "binned magnets"
    else:
        cfg = dataclasses.replace(shape.config,
                                  magnet_pallas_max=shape.n_masses - 1)
        shape = dataclasses.replace(shape, config=cfg)
        reason = "magnet_pallas_max"
    assert reason in tadj.adjoint_reject_reason(shape)
    with pytest.raises(ValueError, match=reason):
        tdiff.adjoint_rollout(shape, state, 4)
    assert tdiff.grad_route(shape) == ("tiled_adjoint", None)
    steps = 10
    rng = np.random.RandomState(5)
    w = [torch.from_numpy(rng.normal(0, 1, state.masses.pos.shape).astype(
        np.float32)) for _ in range(2)]

    def grads(rollout):
        args = [t.clone().requires_grad_() for t in (
            state.masses.pos, state.masses.vel) + tuple(
            getattr(state.masses, k) for k in MAG_ARGS)]
        out = rollout(_with_mag(state, args))
        loss = (torch.sum(out.masses.pos * w[0])
                + torch.sum(out.masses.vel * w[1]))
        return torch.autograd.grad(loss, args)

    got = grads(lambda st: tdiff.grad_rollout(shape, st, steps, segment=5))
    want = grads(lambda st: tdiff.rollout(shape, st, steps))
    for name, a, b in zip(("pos", "vel") + MAG_ARGS, got, want):
        scale = float(b.abs().max())
        assert scale > 0, f"grad[{name}] is 0: nothing to hold"
        err = float((a - b).abs().max()) / scale
        assert err <= TOL_EAGER, (name, err)
