"""Containers: groups of masses/springs with bulk operations (a copy of
``titan_tpu/containers.py``).

Reference: class Container and subclasses Cube/Lattice/Beam/RobotLink
(object.h:230-330, object.cu:146-464).  A container here owns index arrays
into the simulation store; ``masses``/``springs`` expose lazy handle
sequences so index-based user code works unchanged while a 1M-mass container
stays two numpy arrays.
"""

from __future__ import annotations

import math

import numpy as np

from . import builders
from .config import (ACTUATED_CONTRACT, ACTUATED_EXPAND, PASSIVE_SOFT)
from .entities import HandleSeq, Mass, Spring
from .vec import Vec


class Container:
    def __init__(self, sim):
        self._sim = sim
        self._mass_idx = np.zeros(0, dtype=np.int64)
        self._spring_idx = np.zeros(0, dtype=np.int64)

    @property
    def masses(self):
        return HandleSeq(self._sim, Mass, self._mass_idx)

    @property
    def springs(self):
        return HandleSeq(self._sim, Spring, self._spring_idx)

    @property
    def mass_indices(self) -> np.ndarray:
        return self._mass_idx

    @property
    def spring_indices(self) -> np.ndarray:
        return self._spring_idx

    # -- membership (reference object.cu:164-180) ------------------------------
    def add(self, obj) -> None:
        if isinstance(obj, Mass):
            self._mass_idx = np.append(self._mass_idx, obj._i)
        elif isinstance(obj, Spring):
            self._spring_idx = np.append(self._spring_idx, obj._i)
        elif isinstance(obj, Container):
            self._mass_idx = np.concatenate([self._mass_idx, obj._mass_idx])
            self._spring_idx = np.concatenate([self._spring_idx, obj._spring_idx])
        else:
            raise TypeError(type(obj))

    # -- bulk transforms (reference object.cu:146-233) --------------------------
    def translate(self, displ) -> None:
        d = Vec(displ).numpy() if isinstance(displ, Vec) else np.asarray(displ)
        self._sim._store.pos[self._mass_idx] += d
        self._sim._touch_mass(self._mass_idx, "pos")

    def rotate(self, axis, angle: float) -> None:
        """Rotate all masses about ``axis`` through the center of mass.

        Reference Container::rotate (object.cu:207-233): COM-relative
        positions are decomposed into axial + radial parts; the radial part
        is rotated by ``angle`` in the plane spanned by (axis x y_hat, y_hat).
        Masses within 1e-4 of the axis are left in place.
        """
        st = self._sim._store
        idx = self._mass_idx
        pos = st.pos[idx]                                  # [n, 3]
        m = st.m[idx]                                      # [n]
        com = (pos * m[:, None]).sum(axis=0) / m.sum()
        a = np.asarray(Vec(axis).numpy() if isinstance(axis, Vec) else axis,
                       dtype=np.float64)
        a = a / math.sqrt(float(np.dot(a, a)))
        temp = pos - com
        axial = (temp @ a)[:, None] * a                    # [n, 3]
        y = temp - axial
        y_norm = np.sqrt(np.sum(y * y, axis=1))
        on_axis = y_norm < 1e-4
        safe = np.where(on_axis, 1.0, y_norm)
        y_hat = y / safe[:, None]
        x_hat = np.cross(np.broadcast_to(a, y_hat.shape), y_hat)
        planar_x = -math.sin(angle) * y_norm
        planar_y = math.cos(angle) * y_norm
        spatial = (planar_x[:, None] * x_hat + planar_y[:, None] * y_hat
                   + axial + com)
        st.pos[idx] = np.where(on_axis[:, None], pos, spatial)
        self._sim._touch_mass(idx, "pos")

    def setMassValues(self, m: float) -> None:
        """NOTE: the reference *adds* (object.cu:146-150: ``mass->m += m``)."""
        self._sim._store.m[self._mass_idx] += m
        self._sim._touch_mass(self._mass_idx, "m")

    def setSpringConstants(self, k: float) -> None:
        self._sim._store.k[self._spring_idx] = k
        self._sim._touch_spring(self._spring_idx)

    def setRestLengths(self, length: float) -> None:
        self._sim._store.rest[self._spring_idx] = length
        self._sim._touch_spring(self._spring_idx, rest=True)

    def defaultRestLengths(self) -> None:
        st = self._sim._store
        idx = self._spring_idx
        d = st.pos[st.right[idx]] - st.pos[st.left[idx]]
        st.rest[idx] = np.sqrt(np.sum(d * d, axis=1))
        self._sim._touch_spring(idx, rest=True)

    def fix(self) -> None:
        self._sim._store.fixed[self._mass_idx] = True
        self._sim._touch_mass(self._mass_idx)

    def setColor(self, c) -> None:
        """Color every member mass (beyond-reference convenience; the
        reference only exposes per-mass ``color`` and RobotLink::setColor).
        Host-side graphics data -- no device push needed."""
        v = Vec(c).numpy() if isinstance(c, Vec) else np.asarray(c)
        self._sim._store.color[self._mass_idx] = v

    def addConstraint(self, ctype: int, v, d: float) -> None:
        """Reference Container::addConstraint (object.cu:32-36)."""
        for m in self.masses:
            m.addConstraint(ctype, v, d)

    def clearConstraints(self) -> None:
        for m in self.masses:
            m.clearConstraints()


class Cube(Container):
    """8 corner masses + 28 all-pair springs (reference object.cu:182-199)."""

    def __init__(self, sim, center, side_length: float = 1.0):
        super().__init__(sim)
        self._center = Vec(center)
        self._side_length = side_length
        pos = builders.cube_positions(Vec(center).numpy(), side_length)
        self._mass_idx = sim._store.add_masses_bulk(pos, m=0.1)
        left, right = builders.cube_springs()
        rest = builders.rest_lengths(pos, left, right)
        self._spring_idx = sim._store.add_springs_bulk(
            self._mass_idx[left], self._mass_idx[right], k=10000.0, rest=rest)


class Lattice(Container):
    """nx*ny*nz lattice with the 13-family/26-neighborhood spring topology
    (reference object.cu:235-296); mass order k + j*nz + i*ny*nz."""

    def __init__(self, sim, center, dims, nx: int = 10, ny: int = 10,
                 nz: int = 10):
        super().__init__(sim)
        self.nx, self.ny, self.nz = nx, ny, nz
        self._center, self._dims = Vec(center), Vec(dims)
        pos = builders.lattice_positions(
            Vec(center).numpy(), Vec(dims).numpy(), nx, ny, nz)
        self._mass_idx = sim._store.add_masses_bulk(pos, m=0.1)
        left, right = builders.lattice_springs(nx, ny, nz)
        rest = builders.rest_lengths(pos, left, right)
        self._spring_idx = sim._store.add_springs_bulk(
            self._mass_idx[left], self._mass_idx[right], k=10000.0, rest=rest)


class Beam(Container):
    """Lattice with the i==0 face fixed (reference object.cu:299-363)."""

    def __init__(self, sim, center, dims, nx: int = 10, ny: int = 10,
                 nz: int = 10):
        super().__init__(sim)
        self.nx, self.ny, self.nz = nx, ny, nz
        self._center, self._dims = Vec(center), Vec(dims)
        pos = builders.lattice_positions(
            Vec(center).numpy(), Vec(dims).numpy(), nx, ny, nz)
        fixed = builders.beam_fixed_mask(nx, ny, nz)
        self._mass_idx = sim._store.add_masses_bulk(pos, m=0.1, fixed=fixed)
        left, right = builders.lattice_springs(nx, ny, nz)
        rest = builders.rest_lengths(pos, left, right)
        self._spring_idx = sim._store.add_springs_bulk(
            self._mass_idx[left], self._mass_idx[right], k=10000.0, rest=rest)


class RobotLink(Container):
    """Magnet truss actuator: two magnetic masses + one actuated spring
    (reference object.h:290-330, object.cu:368-464)."""

    def __init__(self, sim, pos1, pos2, mass: float, max_exp_length: float,
                 min_exp_length: float, expansion_rate: float, k: float,
                 magnetic_force: float, radius: float = 0.015):
        super().__init__(sim)
        self.max_length = max_exp_length
        self.min_length = min_exp_length
        self.k_link = k
        self.max_mag_force = magnetic_force
        self.exp_rate = expansion_rate
        st = sim._store
        il = st.add_mass(Vec(pos1).numpy(), m=mass, fixed=False, rad=radius,
                         stiffness=5000.0, max_mag_force=magnetic_force,
                         mag_scale_factor=1.0)
        ir = st.add_mass(Vec(pos2).numpy(), m=mass, fixed=False, rad=radius,
                         stiffness=5000.0, max_mag_force=magnetic_force,
                         mag_scale_factor=1.0)
        isp = st.add_spring(il, ir, k=k, rest=min_exp_length,
                            s_type=PASSIVE_SOFT, omega=0.0,
                            l_max=max_exp_length, l_min=min_exp_length,
                            rate=expansion_rate)
        self._mass_idx = np.array([il, ir], dtype=np.int64)
        self._spring_idx = np.array([isp], dtype=np.int64)
        self.ml = Mass(sim, il)
        self.mr = Mass(sim, ir)
        self.s = Spring(sim, isp)

    def expand(self) -> bool:
        """Reference object.cu:388-397."""
        if self.max_length <= self.s._rest:
            self.s._type = PASSIVE_SOFT
            return False
        self.s._type = ACTUATED_EXPAND
        self.attach()  # expanding links are always attached
        return True

    def contract(self) -> bool:
        """Reference object.cu:399-407."""
        if self.min_length >= self.s._rest:
            self.s._type = PASSIVE_SOFT
            return False
        self.s._type = ACTUATED_CONTRACT
        return True

    def setLength(self, length: float) -> bool:
        """Reference object.cu:408-420."""
        if length - self.s._rest > 0.01 * self.min_length:
            self.s._type = ACTUATED_EXPAND
            return True
        if length - self.s._rest < -0.01 * self.min_length:
            self.s._type = ACTUATED_CONTRACT
            return True
        self.s._type = PASSIVE_SOFT
        return False

    def detach(self) -> bool:
        """Reference object.cu:423-434: demagnetize once fully contracted."""
        if not self.contract():
            if self.ml.isMagnetic():
                self.ml.max_mag_force = 0.0
            if self.mr.isMagnetic():
                self.mr.max_mag_force = 0.0
            return True
        return False

    def attach(self) -> bool:
        """Reference object.cu:436-444."""
        if not self.ml.isMagnetic():
            self.ml.max_mag_force = self.max_mag_force
        if not self.mr.isMagnetic():
            self.mr.max_mag_force = self.max_mag_force
        return False

    def setExpansionRate(self, exp_rate: float) -> None:
        self.exp_rate = exp_rate
        self.s._rate = exp_rate

    def setRobotMass(self, mass: float) -> None:
        self.ml.m = mass / 2
        self.mr.m = mass / 2

    def setColor(self, c) -> None:
        """Color the two link masses (reference object.cu:455-459)."""
        v = Vec(c).numpy() if isinstance(c, Vec) else np.asarray(c)
        self._sim._store.color[self.ml._i] = v
        self._sim._store.color[self.mr._i] = v

    def setStiffness(self, k: float) -> None:
        self.k_link = k
        self.s._k = k
