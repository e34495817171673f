"""Flat-packed batched environments: N identical scenes as ONE big scene
(the counterpart of ``titan_tpu/parallel/flat.py``; host code over the
store, which gives the JAX package's store arrays bit for bit).

Replicating a scene E times with mass-index offset e * n preserves every
spring's constant index delta, so the whole batch runs as a single stencil
scene -- stepped by the fused CUDA kernel (``csrc/fused_step.cu``), or past
the reference's residency rule by the tiled kernels (``csrc/tiled_step.cu``).
This is also exactly the reference's own multi-agent strategy (flat arrays,
test/physics/multiagent_unittest.cpp) -- but here the packing is an
automatic transform with per-env Containers for get/set.

Per-env parameter sweeps work through the per-spring/per-mass arrays (k,
rest, m, ...).  Per-env GRAVITY is supported at flat-packed speed via
``set_env_gravity`` (folded into the persistent external force, which the
kernels already carry per mass).  Per-env CONTACT-PLANE offsets are
supported via ``set_env_plane`` (folded into per-mass local contact-plane
slots, which every step kernel runs, friction included).

    sim = titan.Simulation()
    ... build one env ...
    big, envs = replicate_scene(sim, n_envs=1024, spacing=Vec(3, 0, 0))
    big.start(); big.pause(1.0); big.getAll()
    envs[7].masses[0].pos        # env 7's copy
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..containers import Container
from ..vec import Vec


def replicate_scene(src, n_envs: int, spacing=None,
                    config=None) -> Tuple[object, List[Container]]:
    """Build a new Simulation containing n_envs copies of ``src``'s scene.

    ``src`` must be un-started.  ``spacing`` (a Vec) offsets each copy
    spatially (recommended when magnets are in play, since magnet forces are
    global).  Global constraints (planes/balls) and gravity are shared.
    Returns (big_sim, [env containers]).
    """
    from ..runtime.simulation import Simulation

    assert not src._started, "replicate an un-started scene"
    st = src._store
    n, s = st.n_masses, st.n_springs
    off = (Vec(spacing).numpy() if spacing is not None
           else np.zeros(3))

    sim = Simulation(config or src.config)
    big = sim._store
    big.reserve_masses(n * n_envs)
    big.reserve_springs(s * n_envs)

    for f in big._MASS_FIELDS_1:
        getattr(big, f)[: n * n_envs] = np.tile(getattr(st, f)[:n], n_envs)
    for f in big._MASS_FIELDS_3:
        getattr(big, f)[: n * n_envs] = np.tile(getattr(st, f)[:n],
                                                (n_envs, 1))
    big.fixed[: n * n_envs] = np.tile(st.fixed[:n], n_envs)
    big.valid[: n * n_envs] = np.tile(st.valid[:n], n_envs)
    big.hole[: n * n_envs] = np.tile(st.hole[:n], n_envs)
    # spatial offsets per env
    env_of_mass = np.repeat(np.arange(n_envs), n)
    big.pos[: n * n_envs] += env_of_mass[:, None] * off
    big.n_masses = n * n_envs

    for f in ("k", "rest", "damping", "s_type", "omega", "l_max", "l_min",
              "rate"):
        getattr(big, f)[: s * n_envs] = np.tile(getattr(st, f)[:s], n_envs)
    big.s_valid[: s * n_envs] = np.tile(st.s_valid[:s], n_envs)
    env_of_spring = np.repeat(np.arange(n_envs, dtype=np.int64), s)
    big.left[: s * n_envs] = np.tile(st.left[:s], n_envs) + env_of_spring * n
    big.right[: s * n_envs] = (np.tile(st.right[:s], n_envs)
                               + env_of_spring * n)
    big.n_springs = s * n_envs

    # local constraints replicate per env
    for i, rec in st.local.items():
        for e in range(n_envs):
            r = sim._store.local_record(i + e * n)
            shift = e * off
            r.contact_planes = [(cp[0].copy(), cp[1] + float(cp[0] @ shift))
                                + tuple(cp[2:])
                                for cp in rec.contact_planes]
            r.balls = [(v + shift, d) for v, d in rec.balls]
            r.constraint_planes = [(v.copy(), d)
                                   for v, d in rec.constraint_planes]
            r.directions = [(v.copy(), d) for v, d in rec.directions]

    sim._planes = [(p[0].copy(), p[1], p[2], p[3]) for p in src._planes]
    sim._balls = [(b[0].copy(), b[1]) for b in src._balls]
    sim._dt = src._dt
    sim._global_acc = src._global_acc.copy()

    envs = []
    for e in range(n_envs):
        c = Container(sim)
        c._mass_idx = np.arange(e * n, (e + 1) * n, dtype=np.int64)
        c._spring_idx = np.arange(e * s, (e + 1) * s, dtype=np.int64)
        sim.containers.append(c)
        envs.append(c)
    return sim, envs


def set_env_gravity(sim, envs, g_envs) -> None:
    """Per-env gravity on the flat-packed fast path (BASELINE config 5:
    per-env parameter sweeps).

    Gravity enters the step as the per-mass constant force m*g, which the
    kernels carry alongside the persistent external force (``const_f`` of
    ops/fused_step.py and ops/tiled_step.py).  A per-env gravity g_e is
    therefore exactly expressible as extern_force += m * (g_e - g_global)
    on that env's masses -- zero cost, still one flat stencil scene.

    NOTE: this *adds to* the persistent external force (and calling it again
    replaces the gravity component, not user-set forces, because the delta
    is tracked).  Requires ``SimConfig.persistent_extern_force`` (default).
    Call before start(), or at a pause followed by set(env)/setAll().
    """
    assert sim.config.persistent_extern_force, (
        "per-env gravity rides the persistent external force")
    g_envs = np.asarray([Vec(g).numpy() if isinstance(g, Vec) else
                         np.asarray(g, dtype=np.float64).reshape(3)
                         for g in g_envs])
    assert len(g_envs) == len(envs)
    st = sim._store
    prev = getattr(sim, "_env_gravity_delta", None)
    if prev is not None:
        st.extern_force[: st.n_masses] -= prev  # undo the previous sweep
    delta = np.zeros((st.n_masses, 3))
    for c, g_e in zip(envs, g_envs):
        idx = c._mass_idx
        delta[idx] = st.m[idx, None] * (g_e - sim._global_acc)
    st.extern_force[: st.n_masses] += delta
    sim._env_gravity_delta = delta


def set_env_plane(sim, envs, normal, offsets, fk: float = 0.0,
                  fs: float = 0.0) -> None:
    """Per-env contact-plane offsets at flat-packed speed (the other sweep
    axis of BASELINE config 5).

    A global plane (createPlane) is per-scene, but the kernels already
    carry PER-MASS local contact-plane slots (friction included), so a
    per-env offset d_e is exactly expressible by giving every mass of env
    e a local contact plane (normal, d_e, fk, fs).  The
    contact + static/kinetic friction math is identical to the global
    plane's (reference object.cu:76-109 vs the local slot application at
    sim.cu:1311-1326); only the application order relative to OTHER
    constraint objects differs.

    Call before start(): local-constraint capacity is static scene shape.
    Calling again replaces the plane this function previously added for
    each mass (the slot index is tracked), so sweeps can be re-issued at a
    pause -- the capacity flip on first use re-marshals at start.
    """
    nv = Vec(normal).numpy() if isinstance(normal, Vec) else \
        np.asarray(normal, dtype=np.float64).reshape(3)
    nrm = float(np.linalg.norm(nv))
    assert nrm > 0, "plane normal must be nonzero"
    nv = nv / nrm
    offs = np.asarray(offsets, dtype=np.float64).reshape(len(envs))
    slots = getattr(sim, "_env_plane_slot", None)
    if slots is None:
        slots = sim._env_plane_slot = {}
    for c, d in zip(envs, offs):
        ent = (nv.copy(), float(d), float(fk), float(fs))
        for i in c._mass_idx:
            i = int(i)
            rec = sim._store.local_record(i)
            j = slots.get(i)
            if j is None:
                slots[i] = len(rec.contact_planes)
                rec.contact_planes.append(ent)
            else:
                rec.contact_planes[j] = ent
