"""The host layer's modules (``stl.py``, ``testutil.py``, ``native/``,
``runtime/incremental.py``, ``runtime/live.py``, ``runtime/viewer.py``)
import neither JAX nor anything of the JAX package:
``test_torch_isolation.py``'s check, on the files it leaves to this one."""

import torch_threads  # noqa: F401  (before torch)

import subprocess
import sys

import pytest

from test_torch_isolation import (FORBIDDEN, HOST_SLICE, ROOT,
                                  _imported_roots, _port_files)


@pytest.mark.parametrize("path", _port_files(host_slice=True),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_host_module_is_held_here():
    host = _port_files(host_slice=True)
    assert len(host) == 6
    assert all(any(str(p.relative_to(ROOT)).startswith(prefix)
                   for p in host) for prefix in HOST_SLICE)


def test_import_leaves_jax_out():
    code = ("import sys, titan_tpu_torch, titan_tpu_torch.stl, "
            "titan_tpu_torch.testutil, titan_tpu_torch.native, "
            "titan_tpu_torch.runtime.incremental, "
            "titan_tpu_torch.runtime.live, titan_tpu_torch.runtime.viewer; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
