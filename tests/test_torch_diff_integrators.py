"""The port's ``adjoint_rollout`` gradients against ``jax.grad`` through the
JAX package's XLA rollout (``test_torch_diff.py::check_adjoint_scene``), on
the Verlet and RK2 scenes of test_adjoint.py."""

import torch_threads  # noqa: F401  (before torch)

import pytest

from test_torch_diff import check_adjoint_scene


@pytest.mark.parametrize("scene_name", ["verlet", "rk2", "rk2_actuated"])
def test_adjoint_rollout_grads_match_jax_adjoint_integrators(scene_name):
    check_adjoint_scene(scene_name)
