"""The port's checkpoint and profiling services against titan_tpu's.

``runtime/checkpoint.py`` writes the JAX package's file format key for key,
so a checkpoint written by either package loads in the other and resumes.
The scene is the flat-packed batch of examples/batched_rl_envs.py (3^3
lattices with a per-env k sweep, per-env gravity and contact planes),
saved at a pause.  A port checkpoint resumed in the port is bitwise the
uninterrupted run; across the packages the f32 runs are held at 1e-5 of
position and 2e-2 of velocity (measured 3.0e-6 and 1.31e-2: the
static/kinetic friction switch of masses that start inside their plane,
as in tests/test_torch_models_flat.py).
"""

import torch_threads  # noqa: F401  (before torch)

import json

import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu.runtime import checkpoint as jax_checkpoint
from titan_tpu_torch.runtime import checkpoint, profiling

from test_torch_models_flat import _flat_batch

POS_TOL, VEL_TOL = 1e-5, 2e-2
T_SAVE, T_END = 0.01, 0.02
CKPT = {titan_tpu: jax_checkpoint, titan_tpu_torch: checkpoint}


def _load(pkg, path):
    if pkg is titan_tpu_torch:
        return checkpoint.load(path, titan_tpu_torch.SimConfig(device="cpu"))
    return jax_checkpoint.load(path)


def _state(sim):
    sim.getAll()
    n = sim._store.n_masses
    return sim._store.pos[:n].copy(), sim._store.vel[:n].copy()


def _uninterrupted(pkg):
    big, _ = _flat_batch(pkg)
    big.start()
    big.pause(T_SAVE)
    big.resume()
    big.pause(T_END)
    out = _state(big)
    big.stop()
    return out


@pytest.fixture(scope="module")
def runs():
    return {pkg: _uninterrupted(pkg) for pkg in (titan_tpu, titan_tpu_torch)}


def _saved_at_pause(pkg, path):
    big, _ = _flat_batch(pkg)
    big.start()
    big.pause(T_SAVE)
    CKPT[pkg].save(big, path)
    big.stop()


def _resumed(pkg, path):
    sim = _load(pkg, path)
    assert sim.time() == pytest.approx(T_SAVE)
    sim.resume()
    sim.pause(T_END)
    out = _state(sim)
    sim.stop()
    return out


def test_port_resume_is_bitwise_the_uninterrupted_run(tmp_path, runs):
    path = str(tmp_path / "ck.npz")
    _saved_at_pause(titan_tpu_torch, path)
    pos, vel = _resumed(titan_tpu_torch, path)
    want = runs[titan_tpu_torch]
    assert np.array_equal(pos, want[0]) and np.array_equal(vel, want[1])


@pytest.mark.parametrize("writer,reader", [
    (titan_tpu_torch, titan_tpu), (titan_tpu, titan_tpu_torch)],
    ids=["port_to_jax", "jax_to_port"])
def test_checkpoint_loads_across_packages(tmp_path, runs, writer, reader):
    path = str(tmp_path / "ck.npz")
    _saved_at_pause(writer, path)
    pos, vel = _resumed(reader, path)
    want = runs[reader]
    np.testing.assert_allclose(pos, want[0], atol=POS_TOL)
    np.testing.assert_allclose(vel, want[1], atol=VEL_TOL)


def test_file_format_is_the_jax_packages(tmp_path):
    """The same un-started scene saved by both packages: the same arrays
    under the same keys, and the same metadata."""
    files = {}
    for pkg in (titan_tpu, titan_tpu_torch):
        big, _ = _flat_batch(pkg)
        files[pkg] = str(tmp_path / f"{pkg.__name__}.npz")
        CKPT[pkg].save(big, files[pkg])
    with np.load(files[titan_tpu]) as want, \
            np.load(files[titan_tpu_torch]) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            if k != "_meta":
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(got[k], want[k]), k
        meta = [json.loads(bytes(f["_meta"]).decode()) for f in (want, got)]
    assert meta[0] == meta[1]


def test_prestart_roundtrip_and_running_save_raises(tmp_path):
    big, envs = _flat_batch(titan_tpu_torch)
    path = str(tmp_path / "pre.npz")
    checkpoint.save(big, path)
    sim = _load(titan_tpu_torch, path)
    assert not sim._started and len(sim.containers) == len(envs)
    assert sim._store.n_springs == big._store.n_springs
    assert sorted(sim._store.local) == sorted(big._store.local)
    big.setBreakpoint(10.0)
    big.start()
    with pytest.raises(RuntimeError):
        checkpoint.save(big, str(tmp_path / "running.npz"))
    big.pause(0.001)
    big.stop()


def test_measure_throughput_and_trace(tmp_path):
    big, _ = _flat_batch(titan_tpu_torch, n_envs=2, sweep=False)
    with profiling.trace(str(tmp_path / "trace")) as logdir:
        rep = profiling.measure_throughput(big, steps=20, warmup_steps=5)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert logdir == str(tmp_path / "trace")
    assert rep.steps == 20 and rep.wall_s > 0
    assert rep.n_springs == big._store.n_springs
    assert rep.spring_updates_per_sec == pytest.approx(
        rep.n_springs * rep.steps_per_sec)
    assert "spring-updates/s" in str(rep)
    # outside the control plane: the simulation's clock did not move
    assert big.time() == 0.0 and not big._started
