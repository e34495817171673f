"""Batching and multi-device stepping (the counterpart of
``titan_tpu/parallel``): the flat-packed batch (``flat.py``), the per-env
vmap (``batched.py``), meshes of shards (``mesh.py``), the exchange layer
between them (``comm.py``), the sharded, halo-exchange and per-shard tiled
routes (``sharded.py``, ``halo.py``, ``halo_tiled.py``), the distributed
adjoint (``halo_adjoint.py``) and multi-process runs (``multihost.py``)."""

from .batched import (  # noqa: F401
    BatchedScenes, build_batched_step, make_batched_state, shard_batched_state,
)
from .sharded import build_sharded_chunk, shard_state  # noqa: F401
from .halo import build_halo_chunk, halo_supported, place  # noqa: F401
from .halo_tiled import (  # noqa: F401
    build_halo_tiled_chunk, halo_tiled_supported,
)
from .mesh import make_mesh  # noqa: F401
from . import multihost  # noqa: F401
from .flat import replicate_scene, set_env_gravity, set_env_plane  # noqa: F401
