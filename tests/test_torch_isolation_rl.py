"""The RL slice's modules (``rl.py``, ``models/``, ``parallel/``,
``runtime/checkpoint.py``, ``runtime/profiling.py``) import neither JAX nor
anything of the JAX package: ``test_torch_isolation.py``'s check, on the
files it leaves to this one."""

import torch_threads  # noqa: F401  (before torch)

import subprocess
import sys

import pytest

from test_torch_isolation import (FORBIDDEN, ROOT, RL_SLICE, _all_port_files,
                                  _imported_roots, _port_files)


@pytest.mark.parametrize("path", _port_files(rl_slice=True),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_two_files_cover_every_port_file():
    """The RL slice's files here, the host slice's in
    test_torch_isolation_host.py and the rest in test_torch_isolation.py:
    together every port file, each once."""
    rl, host, rest = (_port_files(rl_slice=True),
                      _port_files(host_slice=True), _port_files())
    assert len(rl) == 8 and not set(rl) & (set(rest) | set(host))
    assert not set(host) & set(rest)
    assert sorted(rl + host + rest) == sorted(_all_port_files())
    assert all(any(str(p.relative_to(ROOT)).startswith(prefix)
                   for p in rl) for prefix in RL_SLICE)


def test_import_leaves_jax_out():
    code = ("import sys, titan_tpu_torch, titan_tpu_torch.rl, "
            "titan_tpu_torch.models, titan_tpu_torch.parallel, "
            "titan_tpu_torch.runtime.checkpoint, "
            "titan_tpu_torch.runtime.profiling; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
