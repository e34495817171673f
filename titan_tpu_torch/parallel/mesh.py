"""Meshes of shards: the counterpart of ``titan_tpu/parallel/mesh.py``.

A ``Mesh`` is an ordered, one-dimensional list of shards along one named
axis, each shard a ``torch.device``.  A device may repeat: D shards can
share one card (``devices=[torch.device("cuda", 0)] * 4``) or the CPU
(``[torch.device("cpu")] * 4``, the tests' counterpart of the JAX package's
8 virtual CPU devices).  ``mesh.shape[axis]`` is the shard count, as on a
JAX mesh, and ``mesh.devices.size`` the same number within one process.

A mesh may span processes (``multihost.make_global_mesh``): each process
then holds a contiguous run of the shards, ``mesh.local`` their global
indices, and ``mesh.group`` is the ``torch.distributed`` process group the
exchange layer (``comm.py``) talks through.  Within one process every shard
is local and ``group`` is None.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """D shards along ``axis_names[0]`` (the port's meshes are 1-D; further
    axis names, as JAX's default ``("dp",)`` shapes take them, have size
    1).  ``devices`` are this process's shards' devices, in axis order;
    ``n_shards`` the shard count of every process together, ``first`` the
    global index of this process's first shard."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str],
                 n_shards: Optional[int] = None, first: int = 0,
                 group=None):
        self.local_devices = tuple(torch.device(d) for d in devices)
        if not self.local_devices:
            raise ValueError("a mesh needs at least one shard")
        self.axis_names = tuple(axis_names)
        self.n_shards = int(n_shards if n_shards is not None
                            else len(self.local_devices))
        self.first = int(first)
        self.group = group
        if self.first + len(self.local_devices) > self.n_shards:
            raise ValueError(f"shards {self.first}.."
                             f"{self.first + len(self.local_devices) - 1} "
                             f"outside a mesh of {self.n_shards}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, the first axis holding every shard."""
        return {a: (self.n_shards if i == 0 else 1)
                for i, a in enumerate(self.axis_names)}

    @property
    def devices(self) -> np.ndarray:
        """This process's shards' devices, an object array (every shard's
        within one process)."""
        arr = np.empty(len(self.local_devices), dtype=object)
        arr[:] = self.local_devices
        return arr

    @property
    def local(self) -> range:
        """Global indices of this process's shards."""
        return range(self.first, self.first + len(self.local_devices))

    @property
    def home(self) -> torch.device:
        """The device that holds this process's gathered view of the state
        (its first shard's)."""
        return self.local_devices[0]

    @property
    def multiprocess(self) -> bool:
        return self.group is not None

    def _key(self):
        return (tuple(str(d) for d in self.local_devices), self.axis_names,
                self.n_shards, self.first, id(self.group))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({self.axis_names[0]}={self.n_shards}, local "
                f"{self.first}..{self.first + len(self.local_devices) - 1} on "
                f"{', '.join(str(d) for d in self.local_devices)})")


def make_mesh(axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A mesh over the given devices, or one shard on each visible CUDA
    device (``titan_tpu/parallel/mesh.py:12-23``).  ``shape`` is accepted
    as on a JAX mesh; every axis but the first must be 1."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=[torch.device("
                "'cpu')] * D for a mesh of CPU shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(np.asarray(devices, dtype=object).ravel())
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if int(np.prod(shape)) != len(devices):
            raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
        if any(s != 1 for s in shape[1:]):
            raise ValueError(f"mesh shape {shape}: the port's meshes are "
                             "one-dimensional")
    return Mesh(devices, axis_names)
