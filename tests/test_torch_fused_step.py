"""The port's fused step against the TPU kernel it replaces.

``fused_chunk_plain`` (the plain PyTorch version of the CUDA kernel) runs
against ``titan_tpu.ops.pallas_step.build_pallas_chunk`` in Pallas interpret
mode on the CPU, forced exactly as tests/test_pallas_step.py forces it, on
identical state, at that file's tolerances: pos/vel 1e-5, T 1e-7, actuated
rest 1e-6.  The CUDA kernel itself is held against ``fused_chunk_plain`` on
the card by ``chip_smoke.py`` (this suite imports JAX, which the machine
with the card does not have).
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
from titan_tpu.ops import pallas_step
from titan_tpu_torch import diff as tdiff
from titan_tpu_torch.ops import fused_step
from titan_tpu_torch.state import shape_from_fields

from test_torch_step import build_scene, carry_over

# RK2 with actuation is left out of the 50-step f32 comparison: XLA:CPU and
# PyTorch round the f32 spring forces differently (vel differs by ~7e-8
# after one step, in every variant, while f64 agrees to 1e-9), and that
# scene amplifies it to 1.6e-5 by step 50 (ROADMAP, section C).  RK2 and
# actuation are each covered.
FUSED_VARIANTS = ["plain", "friction", "ball", "damping", "breathing",
                  "actuated", "deleted", "drag", "verlet", "rk2",
                  "clamp_off", "remainder"]


@pytest.fixture
def interpret(monkeypatch):
    import jax.experimental.pallas as pl
    orig_call = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig_call(*args, **kwargs)

    monkeypatch.setattr("titan_tpu.ops.pallas_step.pl.pallas_call",
                        interp_call)


@pytest.mark.parametrize("variant", FUSED_VARIANTS)
def test_fused_plain_matches_pallas_kernel(variant, interpret):
    jsim = build_scene(titan_tpu, variant)
    assert pallas_step.pallas_supported(jsim._shape)
    shape, state = carry_over(jsim)
    assert fused_step.fused_reject_reason(shape) is None

    steps = 50
    out = fused_step.fused_chunk(shape, state, steps)   # CPU -> plain version
    want = pallas_step.build_pallas_chunk(jsim._shape)(jsim._state,
                                                       jnp.int32(steps))
    n = jsim._store.n_masses
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(out.masses, f).numpy()[:, :n],
                                   np.asarray(getattr(want.masses, f))[:, :n],
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(out.masses.T.numpy()[:n],
                               np.asarray(want.masses.T)[:n], atol=1e-7)
    assert float(out.t) == pytest.approx(float(want.t), abs=1e-7)
    if variant.endswith("actuated"):
        np.testing.assert_allclose(out.stencil.rest.numpy(),
                                   np.asarray(want.stencil.rest),
                                   atol=1e-6, rtol=1e-6)
        assert not torch.equal(out.stencil.rest, state.stencil.rest), \
            "actuation did nothing"
    # the chunk never writes into its input state
    np.testing.assert_array_equal(state.masses.pos.numpy(),
                                  np.asarray(jsim._state.masses.pos))


def test_fused_chunk_plain_is_chunk_invariant():
    """Two chunks of 10 steps == one of 20 (t restarts from the carried
    state's t), so chunk boundaries placed by breakpoints change nothing."""
    shape, state = carry_over(build_scene(titan_tpu, "breathing"))
    one = fused_step.fused_chunk_plain(shape, state, 20)
    two = fused_step.fused_chunk_plain(
        shape, fused_step.fused_chunk_plain(shape, state, 10), 10)
    np.testing.assert_allclose(two.masses.pos.numpy(), one.masses.pos.numpy(),
                               atol=1e-6)
    assert float(two.t) == pytest.approx(float(one.t), abs=1e-9)


@pytest.mark.parametrize("variant,reason", [
    # magnets enter the fused step through its constant force, remainder
    # springs through the incidence table
    pytest.param("remainder", None, id="remainder-remainder"),
    ("magnets", None),
    # the per-mass local-constraint slots run inside the step kernel
    ("local", None), ("float64", "f32-only"),
    ("strict_extern", "persistent_extern_force"),
    # use_pallas is carried over from titan_tpu's config but switches
    # nothing in the port: an in-envelope scene takes the fused chunk
    ("pallas_off", None)])
def test_fused_reject_reason(variant, reason):
    jsim = build_scene(titan_tpu, "remainder" if variant == "remainder"
                       else "plain")
    shape = shape_from_fields(jsim._shape, "cpu")
    cfg = shape.config
    if variant == "magnets":
        shape = dataclasses.replace(shape, has_magnets=True)
    elif variant == "local":
        shape = dataclasses.replace(shape, cap_cp=1)
    elif variant == "float64":
        shape = dataclasses.replace(
            shape, config=dataclasses.replace(cfg, dtype="float64"))
    elif variant == "strict_extern":
        shape = dataclasses.replace(shape, config=dataclasses.replace(
            cfg, persistent_extern_force=False))
    elif variant == "pallas_off":
        shape = dataclasses.replace(
            shape, config=dataclasses.replace(cfg, use_pallas=False))
    got = fused_step.fused_reject_reason(shape)
    if reason is None:
        assert got is None
    else:
        assert got is not None and reason in got


def test_adjoint_reject_reason_names_magnets():
    """The fused step and the adjoint kernels both take magnet scenes (the
    adjoint's magnet branches, B4 and B5); the adjoint keeps the
    reference's magnet_pallas_max rule, and refuses binned magnets (its
    transpose is the all-pairs field's): within it the fused adjoint, past
    it the tiled one."""
    from titan_tpu_torch.ops.adjoint import adjoint_reject_reason
    shape = dataclasses.replace(
        shape_from_fields(build_scene(titan_tpu, "plain")._shape, "cpu"),
        has_magnets=True)
    assert fused_step.fused_reject_reason(shape) is None
    assert adjoint_reject_reason(shape) is None
    assert tdiff.grad_route(shape) == ("adjoint", None)
    cfg = dataclasses.replace(shape.config,
                              magnet_pallas_max=shape.n_masses - 1)
    past = dataclasses.replace(shape, config=cfg)
    assert "magnet_pallas_max" in adjoint_reject_reason(past)
    assert "binned magnets" in adjoint_reject_reason(
        dataclasses.replace(shape, magnet_binned=(shape.n_masses, 16)))
    assert tdiff.grad_route(past) == ("tiled_adjoint", None)
