"""The multi-device layer's modules (``titan_tpu_torch/parallel/``: mesh,
comm, sharded, halo, halo_tiled, halo_adjoint, multihost) and the
multi-process test's worker (``tests/torch_multihost_worker.py``) import
neither JAX nor anything of the JAX package: ``test_torch_isolation.py``'s
check, on the files it leaves to this one."""

import torch_threads  # noqa: F401  (before torch)

import subprocess
import sys

import pytest

from test_torch_isolation import (FORBIDDEN, PARALLEL_SLICE, ROOT,
                                  _imported_roots, _port_files)

WORKER = ROOT / "tests" / "torch_multihost_worker.py"


@pytest.mark.parametrize("path", _port_files(parallel_slice=True) + [WORKER],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_parallel_module_is_held_here():
    par = _port_files(parallel_slice=True)
    assert sorted(str(p.relative_to(ROOT)) for p in par) == sorted(
        PARALLEL_SLICE)


def test_import_leaves_jax_out():
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import titan_tpu_torch.parallel.comm, "
            "titan_tpu_torch.parallel.halo, "
            "titan_tpu_torch.parallel.halo_adjoint, "
            "titan_tpu_torch.parallel.halo_tiled, "
            "titan_tpu_torch.parallel.mesh, "
            "titan_tpu_torch.parallel.multihost, "
            "titan_tpu_torch.parallel.sharded, torch_multihost_worker; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
