"""The port's marshalled state against titan_tpu's, and the state bridge.

Both packages marshal the same scene from their own host stores; every
array of the resulting state (stencil deltas and masks, k, rest, const
parameters, constraint tables, remainder topology) and every SceneShape
flag must be identical.  ``state_from_numpy`` must carry a titan_tpu state
across unchanged.
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu.state import state_to_numpy as jax_state_to_numpy
from titan_tpu_torch.ops.fused_step import prep_invariants
from titan_tpu_torch.state import (shape_from_fields, state_from_numpy,
                                   state_to_numpy)

from test_torch_step import build_scene


def entry_scene(pkg, nx=20):
    """The flagship scene of ``__graft_entry__.entry()`` (20^3 lattice on a
    friction plane), built through either package's public API."""
    cfg = pkg.SimConfig(device="cpu") if pkg is titan_tpu_torch \
        else pkg.SimConfig()
    sim = pkg.Simulation(cfg)
    sim.createLattice(pkg.Vec(0, 0, 5), pkg.Vec(4, 4, 4), nx, nx, nx)
    sim.setAllSpringConstantValues(1000.0)
    sim.setTimeStep(0.0001)
    sim.setGlobalAcceleration(pkg.Vec(0, 0, -9.8))
    sim.defaultRestLengths()
    sim.createPlane(pkg.Vec(0, 0, 1), 0, 10, 10)
    sim._T = 0.0
    sim._marshal()
    return sim


def assert_same_state(port_np: dict, jax_np):
    for name, want in dataclasses.asdict(jax_np).items():
        got = port_np[name]
        if isinstance(want, dict):
            for f, w in want.items():
                w = np.asarray(w)
                assert got[f].dtype == w.dtype, (name, f)
                np.testing.assert_array_equal(got[f], w, strict=True,
                                              err_msg=f"{name}.{f}")
        else:
            np.testing.assert_array_equal(got, np.asarray(want), strict=True,
                                          err_msg=name)


def assert_same_shape(port_shape, jax_shape):
    for f in dataclasses.fields(jax_shape):
        if f.name != "config":
            assert getattr(port_shape, f.name) == getattr(jax_shape, f.name), \
                f.name
    for f in dataclasses.fields(jax_shape.config):
        want = getattr(jax_shape.config, f.name)
        got = getattr(port_shape.config, f.name)
        if hasattr(want, "value"):
            want, got = want.value, got.value
        assert got == want, f.name


@pytest.mark.parametrize("variant", ["plain", "actuated", "deleted",
                                     "remainder", "ball", "beam"])
def test_marshal_matches_jax_small(variant):
    jsim = build_scene(titan_tpu, variant, n=5)
    tsim = build_scene(titan_tpu_torch, variant, n=5)
    assert_same_state(state_to_numpy(tsim._state),
                      jax_state_to_numpy(jsim._state))
    assert_same_shape(tsim._shape, jsim._shape)
    np.testing.assert_array_equal(tsim._sp_family, jsim._sp_family)
    np.testing.assert_array_equal(tsim._sp_slot, jsim._sp_slot)


def test_marshal_matches_jax_entry_scene():
    """The 20^3 entry() scene: 13 families incl. the negative offset,
    every array equal, and the kernel's invariants (const_f = extern + m g,
    the frozen mask) as titan_tpu's pallas_step stages them."""
    from titan_tpu.ops.pallas_step import prep_invariants as jax_prep
    jsim, tsim = entry_scene(titan_tpu), entry_scene(titan_tpu_torch)
    assert tsim._shape.stencil_deltas == (1, 20, 400, 19, 399, 380, 401, 21,
                                          420, -381, 379, 419, 421)
    assert tsim._store.n_springs == 93_556
    assert_same_state(state_to_numpy(tsim._state),
                      jax_state_to_numpy(jsim._state))
    assert_same_shape(tsim._shape, jsim._shape)
    got = prep_invariants(tsim._shape, tsim._state)
    want = jax_prep(jsim._shape, jsim._state)
    for key in ("k_eff", "damp_eff", "bsign", "minv", "fixed", "const_f",
                "scal", "planes", "balls"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      strict=True, err_msg=key)


def test_state_from_numpy_round_trips():
    jsim = build_scene(titan_tpu, "remainder", n=5)
    np_state = jax_state_to_numpy(jsim._state)
    port = state_from_numpy(np_state, "cpu")
    assert port.masses.pos.device.type == "cpu"
    assert_same_state(state_to_numpy(port), np_state)
    shape = shape_from_fields(jsim._shape, "cpu")
    assert shape.config.device == "cpu"
    assert shape.config.integrator is titan_tpu_torch.Integrator.EULER
    assert_same_shape(shape, jsim._shape)
    assert hash(shape) == hash(shape_from_fields(jsim._shape, "cpu"))
