"""titan_tpu_torch: the PyTorch/CUDA port of titan_tpu.

The same ``Simulation`` / ``Mass`` / ``Spring`` / ``Container`` API as the
JAX package, running on an NVIDIA GPU by default (``SimConfig.device``).
Scenes inside the fused kernel's envelope step through the hand-written
CUDA kernel ``csrc/fused_step.cu``, and ``diff.grad_rollout`` differentiates
them through the adjoint kernels of ``csrc/adjoint.cu``; the kernels are
built with ``nvcc`` at first use.  This package imports neither JAX nor ``titan_tpu``.

    import titan_tpu_torch as titan
    sim = titan.Simulation()                    # SimConfig(device="cuda")
    sim.createLattice(titan.Vec(0, 0, 10), titan.Vec(5, 5, 5), 5, 5, 5)
    sim.createPlane(titan.Vec(0, 0, 1), 0)
    sim.start()
    sim.pause(1.0)
    sim.getAll()
    sim.stop()
"""

from .vec import Vec, dot, cross  # noqa: F401
from .config import (  # noqa: F401
    SimConfig, Integrator, ScatterMode,
    PASSIVE_SOFT, PASSIVE_STIFF,
    ACTIVE_CONTRACT_THEN_EXPAND, ACTIVE_EXPAND_THEN_CONTRACT,
    ACTUATED_EXPAND, ACTUATED_CONTRACT,
    CONSTRAINT_PLANE, CONTACT_PLANE, BALL, DIRECTION,
)
from .entities import Mass, Spring  # noqa: F401
from .containers import Container, Cube, Lattice, Beam, RobotLink  # noqa: F401
from .runtime.simulation import Simulation  # noqa: F401
from . import diff  # noqa: F401  (differentiable rollouts)
from . import models  # noqa: F401  (cloth/rope/walker/truss archetypes)
from . import parallel  # noqa: F401  (flat-packed and vmapped batches)

__version__ = "0.1.0"
