"""The port stands alone: neither ``titan_tpu_torch``, ``chip_smoke.py`` nor
the port's GPU scripts ``scripts/cuda_*.py`` import JAX or anything of the
JAX package, statically or at run time."""

import torch_threads  # noqa: F401  (before torch)

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "titan_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


# The RL slice's modules are held by test_torch_isolation_rl.py, and the
# host layer's (STL import, viewers, incremental edits, the native
# emitter, the test helpers) by test_torch_isolation_host.py, so that this
# file stays under tests/test_adjoint_tiled.py's 34 tests: --dist loadfile
# starts the files with the most tests first, and one more file ahead of
# that longest file would start it only after another file's end
# (ROADMAP, test budget).
RL_SLICE = ("titan_tpu_torch/models/", "titan_tpu_torch/parallel/",
            "titan_tpu_torch/rl.py", "titan_tpu_torch/runtime/checkpoint.py",
            "titan_tpu_torch/runtime/profiling.py")
HOST_SLICE = ("titan_tpu_torch/native/", "titan_tpu_torch/stl.py",
              "titan_tpu_torch/testutil.py",
              "titan_tpu_torch/runtime/incremental.py",
              "titan_tpu_torch/runtime/live.py",
              "titan_tpu_torch/runtime/viewer.py")


def _all_port_files():
    files = sorted((ROOT / "titan_tpu_torch").rglob("*.py"))
    return (files + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("cuda_*.py")))


def _port_files(rl_slice=False, host_slice=False):
    """The port's files outside the RL and host slices, or those in the RL
    slice (``rl_slice``) or in the host slice (``host_slice``)."""
    def group(p):
        rel = str(p.relative_to(ROOT))
        return ("rl" if rel.startswith(RL_SLICE)
                else "host" if rel.startswith(HOST_SLICE) else "core")
    want = "rl" if rl_slice else "host" if host_slice else "core"
    return [p for p in _all_port_files() if group(p) == want]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_out():
    code = ("import sys, titan_tpu_torch, titan_tpu_torch.ops.fused_step, "
            "titan_tpu_torch.runtime.simulation, titan_tpu_torch.diff, "
            "titan_tpu_torch.ops.adjoint, titan_tpu_torch.ops.tiled_step; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
