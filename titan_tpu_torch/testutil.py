"""Physics-invariant helpers used by the test suite (a copy of
``titan_tpu/testutil.py``).

Port of the reference's test/testutil/utils.h:11-43 (energy and momentum);
note the reference hardcodes g = 9.8 in the gravitational term.
"""

from __future__ import annotations

import numpy as np

from .vec import Vec


def energy(sim) -> float:
    """Total energy: gravitational (g = 9.8 hardcoded, utils.h:26) + kinetic
    + spring potential.  Calls sim.getAll() like the reference."""
    sim.getAll()
    st = sim._store
    n, s = st.n_masses, st.n_springs
    pos, vel, m = st.pos[:n], st.vel[:n], st.m[:n]
    potential_g = float(np.sum(9.8 * pos[:, 2] * m))
    kinetic = float(np.sum(0.5 * m * np.sum(vel * vel, axis=1)))
    li, ri = st.left[:s], st.right[:s]
    ok = (li >= 0) & (ri >= 0) & st.s_valid[:s]
    d = pos[np.where(ok, ri, 0)] - pos[np.where(ok, li, 0)]
    length = np.sqrt(np.sum(d * d, axis=1))
    pe = st.k[:s] * (length - st.rest[:s]) ** 2 / 2
    potential_s = float(np.sum(np.where(ok, pe, 0.0)))
    return potential_s + kinetic + potential_g


def momentum(sim) -> Vec:
    """Linear + angular momentum (utils.h:32-43; summed like the reference)."""
    sim.getAll()
    st = sim._store
    n = st.n_masses
    p = st.m[:n, None] * st.vel[:n]
    linear = p.sum(axis=0)
    angular = np.cross(p, st.pos[:n]).sum(axis=0)
    return Vec(linear + angular)
