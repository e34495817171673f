"""Reusable scene/robot archetypes built on the core builders (a copy of
``titan_tpu/models/archetypes.py``: host builders over the store, which give
the JAX package's store arrays bit for bit).

The reference ships raw builders (Lattice/Beam/Cube/RobotLink) and a
commented-out ``Robot`` class (object.h:332-348); these are the assembled
model families users actually simulate: cloth sheets, ropes, breathing-gait
walkers, and magnet-truss robots (the reference paper's subject).  Every
archetype returns the Container(s) it created on the given Simulation.
"""

from __future__ import annotations

import numpy as np

from ..config import (ACTIVE_CONTRACT_THEN_EXPAND,
                      ACTIVE_EXPAND_THEN_CONTRACT)
from ..containers import Container, RobotLink
from ..vec import Vec


def cloth(sim, center, size: float = 1.0, n: int = 20, k: float = 500.0,
          damping: float = 0.2, fix_edge: str = "top") -> Container:
    """A cloth sheet: n x n x 1 lattice (structural + shear springs via the
    13-family topology degenerating to 2-D), with one edge pinned.

    fix_edge: 'top' | 'left' | 'corners' | 'none'.
    """
    c = Vec(center)
    sheet = sim.createLattice(c, Vec(size, 0.0, size), n, 1, n)
    sheet.setSpringConstants(k)
    sheet.defaultRestLengths()
    st = sim._store
    st.damping[sheet._spring_idx] = damping
    # lattice index order: iz + iy*nz + ix*ny*nz with ny=1 -> iz + ix*n
    idx = sheet._mass_idx.reshape(n, n)  # [ix, iz]
    if fix_edge == "top":
        st.fixed[idx[:, -1]] = True
    elif fix_edge == "left":
        st.fixed[idx[0, :]] = True
    elif fix_edge == "corners":
        st.fixed[[idx[0, -1], idx[-1, -1]]] = True
    return sheet


def rope(sim, start, end, n: int = 30, k: float = 2000.0,
         damping: float = 0.5, mass: float = 0.05,
         fix_start: bool = True) -> Container:
    """A rope/chain: n masses on a line joined by consecutive springs."""
    a, b = Vec(start).numpy(), Vec(end).numpy()
    ts = np.linspace(0.0, 1.0, n)[:, None]
    pos = a + ts * (b - a)
    c = Container(sim)
    c._mass_idx = sim._store.add_masses_bulk(pos, m=mass)
    left = c._mass_idx[:-1]
    right = c._mass_idx[1:]
    seg = np.linalg.norm(b - a) / (n - 1)
    c._spring_idx = sim._store.add_springs_bulk(left, right, k=k, rest=seg)
    sim._store.damping[c._spring_idx] = damping
    if fix_start:
        sim._store.fixed[c._mass_idx[0]] = True
    sim.containers.append(c)
    return c


def walker(sim, center=None, size: float = 1.0, n: int = 4,
           k: float = 3000.0, omega: float = 6.0) -> Container:
    """A breathing-gait soft walker: lattice body whose front half contracts
    while the back half expands (reference spring types
    ACTIVE_CONTRACT_THEN_EXPAND / ACTIVE_EXPAND_THEN_CONTRACT,
    sim.cu:1169-1172).  Locomotes on a friction plane (tests/test_gait.py)."""
    c = Vec(center) if center is not None else Vec(0, 0, 0.55 * size)
    body = sim.createLattice(c, Vec(size, size, size), n, n, n)
    body.setSpringConstants(k)
    st = sim._store
    li = st.left[body._spring_idx]
    ri = st.right[body._spring_idx]
    mid_x = 0.5 * (st.pos[li, 0] + st.pos[ri, 0])
    front = mid_x < c[0]
    st.s_type[body._spring_idx[front]] = ACTIVE_CONTRACT_THEN_EXPAND
    st.s_type[body._spring_idx[~front]] = ACTIVE_EXPAND_THEN_CONTRACT
    st.omega[body._spring_idx] = omega
    return body


def quadruped(sim, center=None, body_size: float = 0.8,
              leg_len: float = 0.35, k: float = 3000.0,
              omega: float = 7.0, link_k: float = 4000.0) -> dict:
    """A soft quadruped: a lattice body on four breathing lattice legs,
    cross-linked by stiff springs (the inter-container-spring pattern of
    the reference's multi-agent test, multiagent_unittest.cpp:29-35).

    Gait: a trot -- diagonal leg pairs breathe in antiphase
    (ACTIVE_CONTRACT_THEN_EXPAND vs ACTIVE_EXPAND_THEN_CONTRACT,
    sim.cu:1169-1172), with the front legs' phase leading so vertical
    breathing rectifies into forward travel against plane friction.

    Returns {'body': Container, 'legs': [Container x4]}; add a friction
    plane and gravity before start() (see tests/test_models.py).
    """
    c = Vec(center) if center is not None else Vec(0, 0, leg_len + 0.3)
    half = body_size / 2
    body = sim.createLattice(c, Vec(body_size, body_size, 0.3), 4, 4, 2)
    body.setSpringConstants(k)
    st = sim._store
    legs = []
    for qi, (sx, sy) in enumerate(((1, 1), (1, -1), (-1, 1), (-1, -1))):
        leg_c = Vec(c[0] + sx * (half - 0.08), c[1] + sy * (half - 0.08),
                    c[2] - 0.15 - leg_len / 2)
        leg = sim.createLattice(leg_c, Vec(0.16, 0.16, leg_len), 2, 2, 3)
        leg.setSpringConstants(k)
        # trot: diagonal pairs (++/-- vs +-/-+) in antiphase
        styp = (ACTIVE_CONTRACT_THEN_EXPAND if sx * sy > 0
                else ACTIVE_EXPAND_THEN_CONTRACT)
        st.s_type[leg._spring_idx] = styp
        st.omega[leg._spring_idx] = omega
        legs.append(leg)
        # cross-link the leg's top 4 masses to the nearest body-bottom
        # masses (stiff passive springs, like the reference's inter-agent
        # links)
        top4 = [m for m in leg.masses if abs(m.pos[2]
                - (leg_c[2] + leg_len / 2)) < 1e-9]
        for lm in top4:
            best = min((bm for bm in body.masses),
                       key=lambda bm: (bm.pos - lm.pos).norm())
            sp = sim.createSpring(lm, best)
            sp._k = link_k
            sp.defaultLength()
    return {"body": body, "legs": legs}


def tensegrity(sim, center, radius: float = 0.5, strut_k: float = 20000.0,
               cable_k: float = 300.0, cable_tension: float = 0.12,
               mass: float = 0.05, damping: float = 0.4) -> Container:
    """A six-strut tensegrity icosahedron (Snelson's 'expanded octahedron',
    the canonical soft-robotics tensegrity module).

    12 masses at icosahedron vertices (0, +-1, +-phi) cyclic; of the 30
    equal-length edges, the 6 opposite pairs that differ only in the +-1
    coordinate become rigid struts (stiff springs at exact rest) and the
    remaining 24 become pre-tensioned cables (rest shortened by
    ``cable_tension``), yielding a self-stressed structure that holds its
    shape with no fixed masses.  The reference has no assembled model like
    this; it composes from the same Mass/Spring primitives
    (mass.h:16-87, spring.h:20-75).
    """
    from itertools import combinations
    phi = (1 + 5 ** 0.5) / 2
    base = []
    for a in (-1.0, 1.0):
        for b in (-phi, phi):
            base += [(0.0, a, b), (b, 0.0, a), (a, b, 0.0)]
    verts = np.asarray(base)                    # 12 vertices, edge length 2
    verts *= radius / np.linalg.norm(verts[0])  # circumradius -> radius
    pos = Vec(center).numpy() + verts

    c = Container(sim)
    c._mass_idx = sim._store.add_masses_bulk(pos, m=mass)
    d2 = ((verts[:, None] - verts[None]) ** 2).sum(-1)
    e2 = np.sort(np.unique(np.round(d2, 9)))[1]     # squared edge length
    pairs = np.array([(i, j) for i, j in combinations(range(12), 2)
                      if abs(d2[i, j] - e2) < 1e-9])
    assert pairs.shape[0] == 30
    # struts: the two endpoints differ ONLY in the +-1 coordinate
    diff_axes = np.count_nonzero(
        np.abs(verts[pairs[:, 0]] - verts[pairs[:, 1]]) > 1e-12, axis=1)
    is_strut = diff_axes == 1
    assert int(is_strut.sum()) == 6
    edge = float(np.sqrt(e2))
    k = np.where(is_strut, strut_k, cable_k)
    rest = np.where(is_strut, edge, edge * (1.0 - cable_tension))
    c._spring_idx = sim._store.add_springs_bulk(
        c._mass_idx[pairs[:, 0]], c._mass_idx[pairs[:, 1]], k=k, rest=rest)
    sim._store.damping[c._spring_idx] = damping
    sim.containers.append(c)
    return c


def truss_tetrahedron(sim, center, edge: float = 0.3, link_mass: float = 0.1,
                      expansion_ratio: float = 1.5, rate: float = 0.009,
                      k: float = 1000.0, mag_force: float = 0.5) -> list:
    """A magnet-truss tetrahedron: 6 RobotLinks whose magnetic endpoints
    cluster at 4 vertices (the reference paper's robot module; RobotLink
    semantics object.cu:368-464).  Returns the list of links; actuate with
    link.expand()/contract()/setLength()."""
    c = Vec(center).numpy()
    verts = c + edge * np.array([
        [1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]) / np.sqrt(3)
    links = []
    for i in range(4):
        for j in range(i + 1, 4):
            vi, vj = verts[i], verts[j]
            d = (vj - vi)
            d = d / np.linalg.norm(d)
            # leave a small magnet gap at each vertex cluster
            p1 = vi + d * 0.02
            p2 = vj - d * 0.02
            length = float(np.linalg.norm(p2 - p1))
            links.append(sim.createRobotLink(
                Vec(*p1), Vec(*p2), link_mass,
                max_exp_length=length * expansion_ratio,
                min_exp_length=length, expansion_rate=rate, k=k,
                magnetic_force=mag_force))
    return links
