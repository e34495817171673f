"""ROADMAP C1: the port's residency rules against titan_tpu's, term for term,
and the routes they pick for scenes with per-mass local constraints.

- ``resident_bytes`` and ``adjoint_resident_bytes`` equal the JAX
  package's rules on lattice shapes either side of the budget, with slot
  caps (1,1,1,1), (2,0,1,0) and none, under Euler and RK2;
- each route on a 43^3-shaped and a 100^3-shaped local-constraint scene,
  the 60^3 shape the slot rows tip over the budget, and
  ``mega_seg`` / ``mega_adjoint_ok`` refusing glue.

(Kept apart from tests/test_torch_local.py so that neither file holds more
tests than tests/test_adjoint_tiled.py: xdist's ``--dist loadfile`` hands
out the files with the most tests first.)
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import pytest

import titan_tpu
from titan_tpu.ops import adjoint as jadj
from titan_tpu.ops import pallas_step
from titan_tpu.state import SceneShape as JaxShape
from titan_tpu_torch import diff as tdiff
from titan_tpu_torch.ops import adjoint_tiled, tiled_step
from titan_tpu_torch.ops import step as tstep
from titan_tpu_torch.ops.adjoint import adjoint_resident_bytes
from titan_tpu_torch.state import shape_from_fields

from test_torch_tiled import _lattice_shape


CAPS = [(1, 1, 1, 1), (2, 0, 1, 0), (0, 0, 0, 0)]


def _jax_shape(nx, caps, integrator=None, **flags):
    """A JAX lattice shape like test_torch_tiled._lattice_shape's."""
    port = _lattice_shape(nx, cap_cp=caps[0], cap_ball=caps[1],
                          cap_pl=caps[2], cap_dir=caps[3], **flags)
    vals = {f.name: getattr(port, f.name)
            for f in dataclasses.fields(port) if f.name != "config"}
    cfg = titan_tpu.SimConfig(integrator=titan_tpu.Integrator(integrator)
                              if integrator else titan_tpu.Integrator.EULER)
    return JaxShape(config=cfg, **vals)


def _equals_jax_rule(port_bytes, reject, module, monkeypatch):
    """The JAX package's rule counts exactly ``port_bytes``: it refuses the
    scene at that budget and accepts it one byte above."""
    monkeypatch.setattr(module, "_VMEM_BUDGET", port_bytes)
    assert "budget" in (reject() or "")
    monkeypatch.setattr(module, "_VMEM_BUDGET", port_bytes + 1)
    assert reject() is None


@pytest.mark.parametrize("integrator", [None, "rk2"])
@pytest.mark.parametrize("caps", CAPS)
@pytest.mark.parametrize("nx", [20, 43, 60, 100])
def test_residency_rules_equal_jax(nx, caps, integrator, monkeypatch):
    jshape = _jax_shape(nx, caps, integrator, has_drag=True,
                        has_damping=True)
    shape = shape_from_fields(jshape, "cpu")
    _equals_jax_rule(tstep.resident_bytes(shape),
                     lambda: pallas_step.pallas_reject_reason(jshape),
                     pallas_step, monkeypatch)
    monkeypatch.setattr(pallas_step, "_VMEM_BUDGET", 1 << 40)
    _equals_jax_rule(adjoint_resident_bytes(shape),
                     lambda: jadj.adjoint_reject_reason(jshape), jadj,
                     monkeypatch)


def test_local_routes_on_shapes():
    local = dict(cap_cp=1, cap_ball=1, cap_pl=1, cap_dir=1)
    small, big = _lattice_shape(43, **local), _lattice_shape(100, **local)
    # 43^3: 40.8 MB and 45.9 MiB of the 100 MB budget
    assert tstep.resident_bytes(small) < tstep.RESIDENT_BUDGET
    assert tstep.chunk_route(small) == ("fused", None)
    assert tdiff.grad_route(small) == ("adjoint", None)
    assert tstep.chunk_route(big) == ("tiled", None)
    assert tdiff.grad_route(big) == ("tiled_adjoint", None)
    assert tiled_step.mega_seg(big) == tiled_step.MEGA_SEG
    assert adjoint_tiled.mega_adjoint_ok(big)
    # the slot rows tip a scene just under the rule over it: 60^3 fits
    # without local constraints (91.6 MB), not with them (110.6 MB)
    assert tstep.chunk_route(_lattice_shape(60))[0] == "fused"
    assert tstep.chunk_route(_lattice_shape(60, **local))[0] == "tiled"
    # glue (magnets, remainder springs) runs no resident grid, forward or
    # backward
    for glue in (dict(has_remainder=True), dict(has_magnets=True)):
        glued = _lattice_shape(100, **glue)
        assert tiled_step.mega_seg(glued) == 0
        assert not adjoint_tiled.mega_adjoint_ok(glued)
