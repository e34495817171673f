"""The port's ``adjoint_rollout`` gradients against ``jax.grad`` through the
JAX package's XLA rollout (``test_torch_diff.py::check_adjoint_scene``), on
the Euler scenes of test_adjoint.py with a fixed face, deleted masses,
breathing and actuation."""

import torch_threads  # noqa: F401  (before torch)

import pytest

from test_torch_diff import check_adjoint_scene


@pytest.mark.parametrize("scene_name", ["beam_fixed", "deleted_extern",
                                        "breathing", "actuated"])
def test_adjoint_rollout_grads_match_jax_adjoint_scenes(scene_name):
    check_adjoint_scene(scene_name)
