"""Checkpoint / resume: serialize a running simulation to disk
(the counterpart of ``titan_tpu/runtime/checkpoint.py``).

The reference has NO serialization at all (SURVEY.md section 5.4 -- "resume"
there means its breakpoint protocol).  Because the whole simulation state is
one set of device tensors + a host store, checkpointing is a plain
save/restore:

    titan_tpu_torch.runtime.checkpoint.save(sim, "ckpt.npz")
    ...
    sim2 = titan_tpu_torch.runtime.checkpoint.load("ckpt.npz")  # paused at t
    sim2.resume()

The file is a single .npz holding the host store (synced from the device
first), scene-level settings, and control-plane time: the JAX package's
format, key for key, so that a checkpoint written by either package loads
in the other.  The file names no device: ``load`` builds the simulation on
the device of its ``config`` (the card by default).  Loads reconstruct a
paused, started Simulation ready to resume().
"""

from __future__ import annotations

import io
import json
from typing import Optional

import numpy as np

from ..config import Integrator, ScatterMode, SimConfig

_MASS_F3 = ("pos", "vel", "acc", "extern_force", "color")
_MASS_F1 = ("m", "T", "drag", "mag_rad", "mag_stiffness", "mag_maxf",
            "mag_scale", "fixed", "valid", "hole")
_SPRING_F = ("left", "right", "s_valid", "k", "rest", "damping", "s_type",
             "omega", "l_max", "l_min", "rate")


def save(sim, path: str) -> None:
    """Snapshot a simulation (running, paused, or pre-start) to ``path``."""
    if sim._started and sim._state is not None:
        if sim._running:
            raise RuntimeError("pause the simulation before checkpointing")
        sim.getAll()
    st = sim._store
    n, s = st.n_masses, st.n_springs
    arrays = {}
    for f in _MASS_F3 + _MASS_F1:
        arrays["m_" + f] = getattr(st, f)[:n]
    for f in _SPRING_F:
        arrays["s_" + f] = getattr(st, f)[:s]
    local = {
        str(i): {
            # contact planes may carry (normal, offset) or
            # (normal, offset, fk, fs) -- see parallel.flat.set_env_plane
            "contact_planes": [(cp[0].tolist(),) + tuple(cp[1:])
                               for cp in rec.contact_planes],
            "balls": [(v.tolist(), d) for v, d in rec.balls],
            "constraint_planes": [(v.tolist(), d)
                                  for v, d in rec.constraint_planes],
            "directions": [(v.tolist(), d) for v, d in rec.directions],
        }
        for i, rec in st.local.items()
    }
    cfg = sim.config
    meta = {
        "version": 1,
        "n_masses": n,
        "n_springs": s,
        "T": sim._T,
        "dt": sim._dt,
        "global_acc": list(sim._global_acc),
        "started": sim._started,
        "planes": [(p[0].tolist(), p[1], p[2], p[3]) for p in sim._planes],
        "balls": [(b[0].tolist(), b[1]) for b in sim._balls],
        # container membership (restored as generic Containers)
        "containers": [
            {"masses": c._mass_idx.tolist(), "springs": c._spring_idx.tolist()}
            for c in sim.containers
        ],
        "local": local,
        "config": {
            "integrator": cfg.integrator.value,
            "velocity_clamp": cfg.velocity_clamp,
            "dtype": cfg.dtype,
            "scatter": cfg.scatter.value,
            "use_stencil": cfg.use_stencil,
            "normal_coeff": cfg.normal_coeff,
            "magnet_cutoff": cfg.magnet_cutoff,
            "max_chunk_steps": cfg.max_chunk_steps,
            "persistent_extern_force": cfg.persistent_extern_force,
        },
    }
    arrays["_meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8).copy()
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def load(path: str, config: Optional[SimConfig] = None):
    """Restore a Simulation from ``path``.  If it was started, the result is
    started-and-paused at the checkpointed time; call resume().  Without a
    ``config`` the file's settings are used on the default device (the
    card); a given ``config`` (e.g. ``SimConfig(device="cpu")``) replaces
    them, as in the JAX package."""
    from .simulation import Simulation

    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["_meta"]).decode("utf-8"))
        if config is None:
            c = meta["config"]
            config = SimConfig(
                integrator=Integrator(c["integrator"]),
                velocity_clamp=c["velocity_clamp"],
                dtype=c["dtype"],
                scatter=ScatterMode(c["scatter"]),
                use_stencil=c["use_stencil"],
                normal_coeff=c["normal_coeff"],
                magnet_cutoff=c["magnet_cutoff"],
                max_chunk_steps=c["max_chunk_steps"],
                persistent_extern_force=c["persistent_extern_force"],
            )
        sim = Simulation(config)
        st = sim._store
        n, s = meta["n_masses"], meta["n_springs"]
        st.reserve_masses(n)
        st.reserve_springs(s)
        st.n_masses, st.n_springs = n, s
        for f in _MASS_F3 + _MASS_F1:
            if "m_" + f in data:        # "hole" absent in v1 checkpoints
                getattr(st, f)[:n] = data["m_" + f]
        if "m_color" not in data:       # absent pre-round-4: default
            st.color[:n] = st.DEFAULT_COLOR
        for f in _SPRING_F:
            getattr(st, f)[:s] = data["s_" + f]
        for i_str, rec in meta["local"].items():
            r = st.local_record(int(i_str))
            r.contact_planes = [(np.asarray(cp[0]),) + tuple(cp[1:])
                                for cp in rec["contact_planes"]]
            r.balls = [(np.asarray(v), d) for v, d in rec["balls"]]
            r.constraint_planes = [(np.asarray(v), d)
                                   for v, d in rec["constraint_planes"]]
            r.directions = [(np.asarray(v), d) for v, d in rec["directions"]]
        sim._dt = meta["dt"]
        sim._global_acc = np.asarray(meta["global_acc"])
        sim._planes = [(np.asarray(p[0]), p[1], p[2], p[3])
                       for p in meta["planes"]]
        sim._balls = [(np.asarray(b[0]), b[1]) for b in meta["balls"]]
        from ..containers import Container
        for crec in meta.get("containers", []):
            c = Container(sim)
            c._mass_idx = np.asarray(crec["masses"], dtype=np.int64)
            c._spring_idx = np.asarray(crec["springs"], dtype=np.int64)
            sim.containers.append(c)
        if meta["started"]:
            sim._T = meta["T"]
            sim._marshal()
            sim._started = True
            sim._running = False
            import threading
            sim._worker = threading.Thread(target=sim._run, daemon=True,
                                           name="titan-torch-worker")
            sim._worker.start()
    return sim
