"""The plain-spring path of the tiled step's per-step kernel and of the tiled
adjoint's trace replay: which launches take it, and the chunk's ctypes
structures against their C structures.

- Which launches set ``_TiledChunk.plain_springs`` and count in
  ``tiled_chunk.plain_launches`` / ``tiled_trace_run.plain_launches``: the
  wrappers (``tiled_step._tiled_chunk_cuda``, ``adjoint_tiled.
  _tiled_trace_cuda``) run on the CPU against a stand-in for the
  libraries, which records each structure it is handed.  Plain springs
  with family-uniform k set the flag on every launch (links too): the
  per-step chunk, the resident-grid segments and their per-step tail, the
  Euler, Verlet and RK2 replay and a magnet scene's glue passes, forward
  and replay.  Every launch then takes the loop.  Damping, breathing,
  actuation, non-uniform k and a uniform-breaking ``Spring.set`` clear
  the flag.
- ``_TiledChunk``, ``_TiledArgs`` and ``_TiledPass`` name their C
  structures' fields in ``csrc/tiled_chunk.cuh`` and
  ``csrc/tiled_body.cuh``, in order.

The CUDA kernels are held bitwise against ``tiled_chunk_plain`` and
``tiled_trace_run_plain`` on the card by ``chip_smoke.py``.  Nothing here
imports JAX: the plain versions are compared with ``titan_tpu`` by
tests/test_torch_tiled.py and tests/test_torch_adjoint_tiled.py.
"""

import torch_threads  # noqa: F401  (before torch)

import types

import pytest
import torch

from titan_tpu_torch.ops import adjoint_tiled, fused_step, tiled_step

from test_torch_plain_transpose import CSRC, c_struct_fields, lattice

# a chunk of two resident-grid segments and a per-step tail of 5
STEPS = 2 * tiled_step.MEGA_SEG + 5
FEATURES = ("plain", "links", "damping", "breathing", "actuated",
            "nonuniform_k")


@pytest.fixture
def stand_in_card(monkeypatch):
    """Runs the tiled chunk's and replay's wrappers on CPU tensors: the
    input checks take any device, the libraries are stand-ins that record
    (entry point, plain_springs, k_seg or the pass's mode) and return 0,
    and a magnet scene's field is 0.  Yields that record."""
    got = []

    def checked(name, t, shape, dtype=torch.float32, kernel="fused"):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name
        return t.data_ptr()

    def chunk(name):
        def run(c, *rest):
            got.append((name, c._obj.plain_springs, c._obj.k_seg))
            return 0
        return run

    def one_pass(name):
        def run(c, p, stream):
            got.append((name, c._obj.plain_springs, p._obj.mode))
            return 0
        return run

    for mod in (tiled_step, fused_step):
        monkeypatch.setattr(mod, "_checked", checked)
    monkeypatch.setattr(tiled_step, "_lib", lambda: types.SimpleNamespace(
        titan_tiled_chunk=chunk("chunk"), titan_tiled_pass=one_pass("pass")))
    monkeypatch.setattr(adjoint_tiled, "_lib", lambda: types.SimpleNamespace(
        titan_tiled_trace=chunk("trace"),
        titan_tiled_trace_pass=one_pass("trace_pass")))
    monkeypatch.setattr(adjoint_tiled, "magnet_field_fn",
                        lambda shape, state, plain: zero_field)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    yield got


def zero_field(pos):
    return torch.zeros_like(pos)


def zero_counts():
    for run in (tiled_step.tiled_chunk, adjoint_tiled.tiled_trace_run):
        run.mega_launches = run.step_launches = run.plain_launches = 0


def counts(run):
    return run.mega_launches, run.step_launches, run.plain_launches


def scene(feature="plain", integrator="euler", magnets=False):
    links = 4 if feature == "links" else 0
    sim = lattice(integrator, feature="plain" if links else feature,
                  links=links)
    if magnets:
        st = sim._store
        st.mag_rad[: st.n_masses: 7] = 0.05
        st.mag_stiffness[: st.n_masses: 7] = 100.0
        st.mag_maxf[: st.n_masses: 7] = 1e-3
        st.mag_scale[: st.n_masses: 7] = 1.0
        sim._marshal()
    return sim._shape, sim._state


@pytest.mark.parametrize("feature", FEATURES)
def test_plain_flag_follows_scene(feature, stand_in_card):
    """Euler: the chunk (resident-grid segments and the per-step tail; a
    link scene takes per-step launches only), a per-step chunk and the
    replay each hand the library the flag of the scene's path, and the
    launches that took the loop are all of them on plain springs with
    family-uniform k, none otherwise."""
    shape, state = scene(feature)
    plain = feature in ("plain", "links")
    assert fused_step.takes_plain_spring_path(shape) == plain
    k_seg = tiled_step.mega_seg(shape)
    assert k_seg == (0 if feature == "links" else tiled_step.MEGA_SEG)
    inv = tiled_step.prep_tiled_inputs(shape, state)
    mega = STEPS // k_seg if k_seg else 0
    step = STEPS - mega * k_seg
    for k in {k_seg, 0}:
        zero_counts()
        tiled_step._tiled_chunk_cuda(shape, state, STEPS, k)
        adjoint_tiled._tiled_trace_cuda(shape, state, STEPS, inv, k)
        want_mega = mega if k else 0
        want_step = STEPS - want_mega * k_seg if k else STEPS
        assert stand_in_card[-2:] == [("chunk", int(plain), k),
                                      ("trace", int(plain), k)]
        for run in (tiled_step.tiled_chunk, adjoint_tiled.tiled_trace_run):
            assert counts(run) == (
                want_mega, want_step,
                want_mega + want_step if plain else 0)
    assert step == (STEPS if feature == "links" else 5)


@pytest.mark.parametrize("integrator", ["verlet", "rk2"])
def test_plain_launches_by_integrator(integrator, stand_in_card):
    """A plain scene under Verlet and RK2 takes the loop on every launch,
    forward and replay alike: both resident-grid launches and every
    per-step launch (two a step under RK2)."""
    shape, state = scene(integrator=integrator)
    assert fused_step.takes_plain_spring_path(shape)
    inv = tiled_step.prep_tiled_inputs(shape, state)
    per = 2 if integrator == "rk2" else 1
    zero_counts()
    tiled_step._tiled_chunk_cuda(shape, state, STEPS, tiled_step.MEGA_SEG)
    adjoint_tiled._tiled_trace_cuda(shape, state, STEPS, inv,
                                    tiled_step.MEGA_SEG)
    assert [flag for _, flag, _ in stand_in_card] == [1, 1]
    for run in (tiled_step.tiled_chunk, adjoint_tiled.tiled_trace_run):
        assert counts(run) == (2, 5 * per, 5 * per + 2)
    assert tiled_step.plain_launch_count(shape, 2, 5 * per) == 5 * per + 2


@pytest.mark.parametrize("feature,integrator", [("plain", "euler"),
                                                ("plain", "rk2"),
                                                ("damping", "euler")])
def test_glue_passes_take_scene_path(feature, integrator, stand_in_card):
    """A magnet scene's glue passes, forward (``titan_tiled_pass``) and
    replay (``titan_tiled_trace_pass``): one launch per force pass, each
    with the scene's flag, all counted as plain launches where its springs
    are plain."""
    shape, state = scene(feature, integrator, magnets=True)
    assert shape.has_magnets and tiled_step.mega_seg(shape) == 0
    plain = feature == "plain"
    passes = 3 * (2 if integrator == "rk2" else 1)
    inv = tiled_step.prep_tiled_inputs(shape, state)
    zero_counts()
    tiled_step._tiled_chunk_cuda(shape, state, 3, 0, field=zero_field)
    adjoint_tiled._tiled_trace_cuda(shape, state, 3, inv, 0)
    names = [name for name, _, _ in stand_in_card]
    assert names == ["pass"] * passes + ["trace_pass"] * passes
    assert {flag for _, flag, _ in stand_in_card} == {int(plain)}
    modes = [mode for _, _, mode in stand_in_card[:passes]]
    assert modes == ([tiled_step._RK2A, tiled_step._RK2B] * 3
                     if integrator == "rk2" else [tiled_step._EULER] * 3)
    for run in (tiled_step.tiled_chunk, adjoint_tiled.tiled_trace_run):
        assert counts(run) == (0, passes, passes if plain else 0)


def test_plain_flag_clears_after_uniform_break(stand_in_card):
    """A set() of one spring's k at a pause clears the family's uniform k:
    the chunk and the replay then hand the library a clear flag and count
    no plain launch, the k riding as a plane."""
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
    assert "bits" not in inv and "k" in inv
    zero_counts()
    tiled_step._tiled_chunk_cuda(shape, state, STEPS, tiled_step.MEGA_SEG)
    adjoint_tiled._tiled_trace_cuda(shape, state, STEPS, inv,
                                    tiled_step.MEGA_SEG)
    assert [flag for _, flag, _ in stand_in_card] == [0, 0]
    assert tiled_step.tiled_chunk.plain_launches == 0
    assert adjoint_tiled.tiled_trace_run.plain_launches == 0


@pytest.mark.parametrize("struct,source,name", [
    (tiled_step._TiledChunk, "tiled_chunk.cuh", "TiledChunk"),
    (tiled_step._TiledArgs, "tiled_body.cuh", "TiledArgs"),
    (tiled_step._TiledPass, "tiled_chunk.cuh", "TiledPass")])
def test_tiled_structs_match_c(struct, source, name):
    """Each ctypes mirror names its C structure's fields, in order;
    ``_TiledChunk`` ends with the plain-spring flag."""
    want = c_struct_fields((CSRC / source).read_text(), name)
    assert [f for f, _ in struct._fields_] == want
    if name == "TiledChunk":
        assert want[-1] == "plain_springs"
