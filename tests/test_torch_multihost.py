"""Multi-process runs of the port (``titan_tpu_torch/parallel/
multihost.py``): 2 processes x 2 CPU shards over a gloo process group form
one 4-shard mesh, as ``tests/test_multihost.py`` runs 2 JAX processes.

- Each process (``tests/torch_multihost_worker.py``, with a time limit)
  builds the same scene and runs the distributed tiled chunk,
  ``Simulation.distribute`` to a pause and a gradient through the
  distributed adjoint (its remainder springs as glue); the results are
  bitwise the same legs in this process over 4 CPU shards.
- In a single process the helpers are no-ops: ``host_gather`` returns its
  argument, the control-plane check passes, ``make_global_mesh`` is
  ``make_mesh``; ``initialize`` without its addresses is refused.
"""

import torch_threads  # noqa: F401  (before torch)

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from titan_tpu_torch.parallel import make_mesh, multihost

import torch_multihost_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_bitwise_one_process(tmp_path):
    port = _free_port()
    out_path = str(tmp_path / "mh.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), "2", str(r), out_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = np.load(out_path)
    want = worker.run_all(make_mesh(("shard",),
                                    devices=[torch.device("cpu")] * 4))
    assert str(want["sim_route"]) == "halo"
    assert sorted(got.files) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_single_process_helpers_are_no_ops():
    assert multihost.process_count() == 1
    x = np.arange(6.0).reshape(2, 3)
    assert np.array_equal(multihost.host_gather(x), x)
    multihost.assert_replicated_control_plane(1.5, "t")
    mesh = multihost.make_global_mesh(
        ("shard",), devices=[torch.device("cpu")] * 2)
    assert mesh == make_mesh(("shard",), devices=[torch.device("cpu")] * 2)
    assert not mesh.multiprocess and mesh.shape == {"shard": 2}
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize()
