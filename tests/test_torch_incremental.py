"""The port's incremental topology edits (``runtime/incremental.py``)
against titan_tpu's, on the cases of ``tests/test_topology_edit.py`` that
run on one device.

Each case drives the same paused-time edit sequence through three
simulations in f64: the port and titan_tpu resuming through their
incremental apply, and the port with ``journal.force_full`` set before
every resume.  Held:

- the path each resume took (``"incremental"`` or ``"full"``) equals JAX's
  ``apply_structural_edits`` on the same edits;
- pos, vel and rest after the edits are within 2e-5 of JAX's (5e-5 for
  the fuzz cases, as the JAX package holds its own), with JAX's own
  ``assert_pair_equal``;
- the port's incremental path agrees with its forced full re-marshal at
  the same tolerance.

In f64 because XLA:CPU and PyTorch round the stiff f32 spring forces
differently (ROADMAP queue C): in f32 every case's velocities came out
1.4e-4 to 3.5e-3 apart across the packages.  In f64 the port steps
through its eager step; ``test_f32_kernel_path_matches_full`` holds the
incremental path against the full one in f32 too, where the port steps
through the fused kernel's plain version, which reads a family-uniform
field as one scalar a family.

The horizons are shorter than ``test_topology_edit.py``'s (0.01 s before
the edits and after each, in place of 0.03 and 0.05): the port's CPU
chunk costs ~1.2-1.9 ms a step, and the 17 cases run three simulations
each.  The JAX chunks are compiled once per scene shape with
``FAST_XLA``.  The mesh cases of ``test_topology_edit.py`` wait for the
port's multi-device layer (ROADMAP A9).
"""

import torch_threads  # noqa: F401  (before torch)

import contextlib

import jax
import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu.ops.step import build_chunk_fn as jax_chunk_fn
from titan_tpu.runtime import simulation as jsim
from titan_tpu.runtime.incremental import _try_incremental as jax_try
from titan_tpu_torch.runtime import simulation as tsim
from titan_tpu_torch.runtime.incremental import _try_incremental as port_try

from test_topology_edit import assert_pair_equal
from test_torch_step import FAST_XLA

PKGS = (titan_tpu_torch, titan_tpu)
_COMPILED = {}      # (JAX scene shape, state layout) -> compiled chunk


def _fast_jax_chunk_for(shape):
    """``titan_tpu.runtime.simulation._chunk_for`` with one ``FAST_XLA``
    compile per scene shape and state layout."""
    fn = jax_chunk_fn(shape)

    def chunk(state, n):
        leaves, tree = jax.tree_util.tree_flatten(state)
        key = (shape, tree, tuple((a.shape, str(a.dtype)) for a in leaves))
        exe = _COMPILED.get(key)
        if exe is None:
            exe = _COMPILED[key] = fn.lower(state, n).compile(
                compiler_options=FAST_XLA)
        return exe(state, n)
    return chunk


@pytest.fixture(autouse=True)
def fast_jax_chunks(monkeypatch):
    monkeypatch.setattr(jsim, "_chunk_for", _fast_jax_chunk_for)


@contextlib.contextmanager
def recording_paths(pkg):
    """Record the path of every ``apply_structural_edits`` the package's
    ``Simulation.resume`` makes."""
    mod = tsim if pkg is titan_tpu_torch else jsim
    orig = mod.apply_structural_edits
    paths = []

    def spy(sim):
        paths.append(orig(sim))
        return paths[-1]
    mod.apply_structural_edits = spy
    try:
        yield paths
    finally:
        mod.apply_structural_edits = orig


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def build_scene(pkg, nx=4, actuated=False, magnets=False, dtype="float32"):
    """``test_topology_edit.build_scene`` in either package (the port on the
    CPU)."""
    cfg = (pkg.SimConfig(device="cpu", dtype=dtype)
           if pkg is titan_tpu_torch else pkg.SimConfig(dtype=dtype))
    sim = pkg.Simulation(cfg)
    sim.createLattice(pkg.Vec(0, 0, 5), pkg.Vec(1, 1, 1), nx, nx, nx)
    sim.createPlane(pkg.Vec(0, 0, 1), 0)
    if actuated:
        s = sim.springs[3]
        s._type = pkg.ACTUATED_EXPAND
        s._l_max = 2.0
        s._rate = 0.5
    if magnets:
        for i in (0, 7):
            m = sim.masses[i]
            m.max_mag_force = 2.0
            m.rad = 0.05
            m.mag_scale_factor = 1.0
    sim.setTimeStep(1e-4)
    return sim


def snapshot(sim):
    sim.getAll()
    st = sim._store
    n, s = st.n_masses, st.n_springs
    return st.pos[:n].copy(), st.vel[:n].copy(), st.rest[:s].copy()


# ------------------------------------------------- the edits, in both packages
def create_remainder_spring(sim, pkg, ctx):
    s = sim.createSpring(sim.masses[0], sim.masses[37])
    s._k = 500.0


def refill_freed_slot(sim, pkg, ctx):
    st = sim._store
    li, ri = int(st.left[10]), int(st.right[10])
    k, rest = float(st.k[10]), float(st.rest[10])
    sim.deleteSpring(sim.springs[10])
    s = sim.createSpring(sim.masses[li], sim.masses[ri])
    s._k = k
    s._rest = rest


def delete_spring_20(sim, pkg, ctx):
    sim.deleteSpring(sim.springs[20])


def delete_mass_9(sim, pkg, ctx):
    sim.deleteMass(sim.masses[9])


def create_mass_and_spring(sim, pkg, ctx):
    m = sim.createMass(pkg.Vec(0.2, 0.2, 6.0))
    s = sim.createSpring(sim.masses[0], m)
    s._k = 200.0


def churn(sim, pkg, ctx):
    i = ctx["i"] % 3
    if i == 0:
        m = sim.createMass(pkg.Vec(0.5, 0.5, 5.5 + ctx["i"] * 0.1))
        sim.createSpring(sim.masses[2], m)
    elif i == 1:
        sim.deleteSpring(sim.springs[30 + ctx["i"]])
    else:
        s = sim.createSpring(sim.masses[1], sim.masses[42])
        s._k = 123.0
    ctx["i"] += 1


def damped_cross_link(sim, pkg, ctx):
    s = sim.createSpring(sim.masses[0], sim.masses[37])
    s._k = 300.0
    s._damping = 5.0


def overflow_capacity(sim, pkg, ctx):
    for i in range(200):  # 64 masses padded to 128: overflow
        sim.createMass(pkg.Vec(2 + 0.01 * i, 2, 2))


def add_local_constraint(sim, pkg, ctx):
    sim.masses[0].addConstraint(pkg.CONTACT_PLANE, pkg.Vec(0, 0, 1), 4.0)


def add_plane(sim, pkg, ctx):
    sim.createPlane(pkg.Vec(0, 0, 1), -1.0)


def retarget_spring(sim, pkg, ctx):
    s = sim.springs[10]
    s.setMasses(sim.masses[0], sim.masses[37])
    s._rest = 0.8


def delete_spring_12(sim, pkg, ctx):
    sim.deleteSpring(sim.springs[12])


def delete_and_compact(sim, pkg, ctx):
    sim.deleteMass(sim.masses[9])
    sim.compact()


def fuzz_ctx(seed):
    def make():
        rng = np.random.RandomState(900 + seed)
        return {"rng": rng, "ops": [rng.randint(0, 6) for _ in range(10)]}
    return make


def fuzz(sim, pkg, ctx):
    """``test_random_edit_interleaving_fuzz``'s burst."""
    rng = ctx["rng"]
    n0 = sim._store.n_masses
    for op in ctx["ops"]:
        if op == 0:
            sim.deleteSpring(sim.springs[int(rng.randint(0, 100))])
        elif op == 1:
            m = sim.createMass(pkg.Vec(rng.rand(), rng.rand(), 5.5))
            s = sim.createSpring(sim.masses[int(rng.randint(0, n0))], m)
            s._k = 77.0
        elif op == 2:
            s = sim.createSpring(sim.masses[int(rng.randint(0, 8))],
                                 sim.masses[int(rng.randint(40, 60))])
            s._k = 55.0
        elif op == 3:
            sp = sim.springs[int(rng.randint(0, 100))]
            sp._k = float(900 + rng.randint(0, 100))
            sim.set(sp)
        elif op == 4:
            sim.deleteMass(sim.masses[int(rng.randint(20, 40))])
        else:
            mm = sim.masses[int(rng.randint(0, n0))]
            mm.pos = pkg.Vec(rng.rand(), rng.rand(), 5.2)
            sim.set(mm)


# name: (edit, options) -- test_topology_edit.py's run_pair protocol: t0
# before the first edit, then `rounds` times (edit, resume, wait t1)
CASES = {
    "create_remainder_spring": (create_remainder_spring, {}),
    "create_spring_fills_freed_family_slot": (refill_freed_slot, {}),
    "delete_spring": (delete_spring_20, {}),
    "delete_mass": (delete_mass_9, {}),
    "create_mass_and_spring": (create_mass_and_spring, {}),
    "repeated_edit_churn": (churn, dict(t1=0.005, rounds=4,
                                        ctx=lambda: {"i": 0})),
    "actuated_rest_progress": (delete_spring_20, dict(
        scene=dict(actuated=True), t1=0.005)),
    "feature_flip_new_spring_damping": (damped_cross_link, {}),
    "capacity_overflow_falls_back": (overflow_capacity, {}),
    "local_constraint_add_at_pause": (add_local_constraint, {}),
    "plane_add_at_pause": (add_plane, {}),
    "retarget_spring_at_pause": (retarget_spring, {}),
    "magnet_scene_edit": (delete_spring_12, dict(scene=dict(magnets=True))),
    "compact_then_resume": (delete_and_compact, {}),
    **{f"random_edit_interleaving_fuzz_{seed}": (fuzz, dict(
        scene=dict(nx=5), t1=0.004, rounds=2, atol=5e-5,
        ctx=fuzz_ctx(seed))) for seed in range(3)},
}


def run_case(pkg, name, force_full=False, dtype="float32"):
    """(pos, vel, rest after the edits, the paths the resumes took)."""
    edit, opt = CASES[name]
    ctx = opt.get("ctx", dict)()
    with recording_paths(pkg) as paths:
        sim = build_scene(pkg, dtype=dtype, **opt.get("scene", {}))
        sim.start()
        sim.wait(opt.get("t0", 0.01))
        for _ in range(opt.get("rounds", 1)):
            edit(sim, pkg, ctx)
            if force_full and sim._journal is not None:
                sim._journal.force_full = True
            sim.resume()
            sim.wait(opt.get("t1", 0.01))
        out = snapshot(sim)
        sim.stop()
    return out, paths


@pytest.mark.parametrize("name", sorted(CASES))
def test_edit_matches_jax_and_full_path(name, x64):
    atol = CASES[name][1].get("atol", 2e-5)
    got, paths = run_case(titan_tpu_torch, name, dtype="float64")
    want, jax_paths = run_case(titan_tpu, name, dtype="float64")
    full, full_paths = run_case(titan_tpu_torch, name, force_full=True,
                                dtype="float64")
    assert paths == jax_paths, (paths, jax_paths)
    assert full_paths == ["full"] * len(paths)
    assert_pair_equal((got, want), atol=atol)
    assert_pair_equal((got, full), atol=atol)


@pytest.mark.parametrize("name", ["create_spring_fills_freed_family_slot",
                                  "feature_flip_new_spring_damping",
                                  "random_edit_interleaving_fuzz_0"])
def test_f32_kernel_path_matches_full(name):
    """The incremental path against the forced full one in f32, where the
    port steps through ``fused_chunk_plain`` (a fill, a feature flip that
    demotes nothing and a fuzz burst whose ``set`` of a k demotes the
    family-uniform k)."""
    atol = CASES[name][1].get("atol", 2e-5)
    got, paths = run_case(titan_tpu_torch, name)
    full, _ = run_case(titan_tpu_torch, name, force_full=True)
    assert "incremental" in paths
    assert_pair_equal((got, full), atol=atol)


def test_actuated_rest_advances_across_an_edit():
    """An unrelated paused edit must not rewind actuated rest lengths."""
    sim = build_scene(titan_tpu_torch, actuated=True)
    r0 = float(sim._store.rest[3])
    sim.start()
    sim.wait(0.03)
    sim.deleteSpring(sim.springs[20])
    sim.resume()
    sim.wait(0.03)
    sim.getAll()
    assert float(sim._store.rest[3]) > r0 + 0.02
    sim.stop()


def paused(pkg, nx=4, t=0.02, dtype="float32"):
    sim = build_scene(pkg, nx=nx, dtype=dtype)
    sim.start()
    sim.wait(t)
    return sim


def test_fill_reuses_slot_without_remainder():
    got = {}
    for pkg in PKGS:
        sim = paused(pkg)
        refill_freed_slot(sim, pkg, None)
        s = sim.springs[sim._store.n_springs - 1]
        st = sim._store
        assert (jax_try if pkg is titan_tpu else port_try)(sim)
        got[pkg] = (sim._rem_count, sim._shape.has_remainder,
                    int(sim._sp_family[s._i]), int(sim._sp_slot[s._i]),
                    int(st.left[s._i]))
        sim.stop()
    assert got[titan_tpu_torch] == got[titan_tpu]
    rem_count, has_rem, fi, sl, li = got[titan_tpu_torch]
    assert rem_count == 0 and not has_rem and fi >= 0 and sl == li


def test_feature_flip_takes_the_incremental_path():
    for pkg in PKGS:
        sim = paused(pkg)
        s = sim.createSpring(sim.masses[0], sim.masses[37])
        s._damping = 5.0
        assert not sim._shape.has_damping
        assert (jax_try if pkg is titan_tpu else port_try)(sim)
        assert sim._shape.has_damping
        sim.stop()


def test_attribute_write_while_dirty_applied_at_resume():
    """A write to an untouched row while the structure is dirty is
    journaled and applied at resume."""
    vel = {}
    for pkg in PKGS:
        sim = paused(pkg)
        sim.createSpring(sim.masses[0], sim.masses[37])  # dirty
        sim.masses[7].vel = pkg.Vec(0, 0, 0.5)
        sim.resume()
        sim.wait(1e-4)
        vel[pkg] = snapshot(sim)[1]
        sim.stop()
    assert vel[titan_tpu_torch][7, 2] > 0.3
    np.testing.assert_allclose(vel[titan_tpu_torch], vel[titan_tpu],
                               atol=2e-5, rtol=0)


def test_uniform_break_set_is_effective(x64):
    """set() of one stencil spring's k on a family-uniform scene clears the
    uniform-k flag, in both packages, and the runs agree after it (f64, as
    the edit cases)."""
    out = {}
    for pkg in PKGS:
        sim = paused(pkg, t=0.01, dtype="float64")
        assert sim._shape.stencil_uniform[0]
        s = sim.springs[10]
        assert sim._sp_family[10] >= 0
        s._k = 1.0
        sim.set(s)
        assert not sim._shape.stencil_uniform[0]
        sim.resume()
        sim.wait(0.05)
        out[pkg] = snapshot(sim)
        sim.stop()
    assert_pair_equal((out[titan_tpu_torch], out[titan_tpu]))


def test_one_spring_edit_cost_scales_with_rows_not_scene(monkeypatch):
    """A one-spring edit takes the incremental path, reads nothing back in
    full (no getAll) and re-stages no mass tensor: ``masses.pos`` stays
    the same tensor object."""
    for pkg in PKGS:
        sim = paused(pkg, nx=6, t=0.01)
        called = {"getAll": 0}
        orig = sim.getAll

        def spy():
            called["getAll"] += 1
            return orig()
        monkeypatch.setattr(sim, "getAll", spy)
        pos_before = sim._state.masses.pos
        masses_before = sim._state.masses
        sim.deleteSpring(sim.springs[10])
        assert (jax_try if pkg is titan_tpu else port_try)(sim)
        assert called["getAll"] == 0
        assert sim._state.masses.pos is pos_before
        if pkg is titan_tpu_torch:
            assert sim._state.masses is masses_before
        sim.stop()


def test_uniform_break_while_structure_dirty():
    """A pure parameter edit journaled while the structure is dirty demotes
    the family-uniform k, and the slot holds the new k."""
    got = {}
    for pkg in PKGS:
        sim = paused(pkg, t=0.01)
        assert sim._shape.stencil_uniform[0]
        sim.deleteSpring(sim.springs[50])
        sim.springs[7]._k = 50.0
        assert (jax_try if pkg is titan_tpu else port_try)(sim)
        fam, slot = int(sim._sp_family[7]), int(sim._sp_slot[7])
        got[pkg] = (sim._shape.stencil_uniform, fam, slot,
                    float(np.asarray(sim._state.stencil.k)[fam, slot]))
        sim.resume()
        sim.wait(0.01)
        sim.stop()
    assert got[titan_tpu_torch] == got[titan_tpu]
    uniform, fam, _, k = got[titan_tpu_torch]
    assert not uniform[0] and fam >= 0 and k == 50.0
