"""Batched environments (the counterpart of ``titan_tpu/parallel``): the
flat-packed batch (``flat.py``) and the per-env vmap (``batched.py``).
The multi-device modules (``sharded``, ``halo*``, ``mesh``, ``multihost``,
``shard_batched_state``) are not ported yet (ROADMAP A9)."""

from .batched import (  # noqa: F401
    BatchedScenes, build_batched_step, make_batched_state,
)
from .flat import replicate_scene, set_env_gravity, set_env_plane  # noqa: F401
