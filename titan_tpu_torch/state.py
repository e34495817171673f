"""Device-resident simulation state: dataclasses of torch tensors.

The counterpart of ``titan_tpu/state.py`` in the same ``[3, N]``
component-major layout, with N padded to a multiple of 128 (``pad_to``), so
that the two packages' marshalled states compare field by field.  Masses are
rows of ``[3, N]`` tensors; springs reference masses by int32 index;
"deleted" entities are rows with ``valid=False`` (the reference's soft-delete
flag, mass.h:120, which doubles as the padding mask).

The state is treated as immutable: every step and chunk returns fresh
tensors and never writes into its input, so a snapshot handed to a reader
(``Simulation.getAll``) is never overwritten under it.

``state_from_numpy`` / ``shape_from_fields`` carry a marshalled state of the
JAX package (the output of ``titan_tpu.state.state_to_numpy``, read by
attribute name, duck-typed) into this package: it is how the tests feed both
packages the identical state.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .config import SimConfig


@dataclasses.dataclass
class MassState:
    """Per-mass state; N is the padded mass capacity (reference CUDA_MASS,
    mass.h:89-126).  ``extern_force`` is the persistent user force."""

    pos: torch.Tensor            # [3, N]
    vel: torch.Tensor            # [3, N]
    acc: torch.Tensor            # [3, N] (carried for Verlet + acceleration())
    extern_force: torch.Tensor   # [3, N]
    m: torch.Tensor              # [N]
    T: torch.Tensor              # [N] per-mass local time (reference mass.h:23)
    fixed: torch.Tensor          # [N] bool
    valid: torch.Tensor          # [N] bool soft-delete / padding mask
    drag: torch.Tensor           # [N]
    mag_rad: torch.Tensor        # [N] magnet shell radius
    mag_stiffness: torch.Tensor  # [N]
    mag_maxf: torch.Tensor       # [N]
    mag_scale: torch.Tensor      # [N]


@dataclasses.dataclass
class SpringState:
    """Remainder (non-stencil) springs; S is the padded capacity (reference
    CUDA_SPRING, spring.h:77-97).  ``rest`` is state (actuators)."""

    left: torch.Tensor     # [S] int32
    right: torch.Tensor    # [S] int32
    valid: torch.Tensor    # [S] bool
    k: torch.Tensor        # [S]
    rest: torch.Tensor     # [S]
    damping: torch.Tensor  # [S]
    type: torch.Tensor     # [S] int8 (SpringType codes, config.py)
    omega: torch.Tensor    # [S]
    l_max: torch.Tensor    # [S]
    l_min: torch.Tensor    # [S]
    rate: torch.Tensor     # [S]


@dataclasses.dataclass
class GlobalConstraints:
    """Global contact planes and balls (reference CUDA_GLOBAL_CONSTRAINTS,
    object.h:171-177)."""

    plane_normal: torch.Tensor  # [P, 3] unit normals
    plane_offset: torch.Tensor  # [P]
    plane_fk: torch.Tensor      # [P] kinetic friction coefficient
    plane_fs: torch.Tensor      # [P] static friction coefficient
    ball_center: torch.Tensor   # [B, 3]
    ball_radius: torch.Tensor   # [B]


@dataclasses.dataclass
class LocalConstraints:
    """Per-mass local constraint slots (reference CUDA_LOCAL_CONSTRAINTS,
    object.h:203-220; applied at sim.cu:1311-1326).  Fixed per-type
    capacities (the shape's ``cap_*``) with per-mass counts: slot j is
    active iff j < count.  The steps read them as one stacked [L, N] array
    (``ops/forces.py::stage_local``)."""

    cp_normal: torch.Tensor    # [N, Ccp, 3]
    cp_offset: torch.Tensor    # [N, Ccp]
    cp_fk: torch.Tensor        # [N, Ccp]
    cp_fs: torch.Tensor        # [N, Ccp]
    cp_count: torch.Tensor     # [N] int32
    ball_center: torch.Tensor  # [N, Cb, 3]
    ball_radius: torch.Tensor  # [N, Cb]
    ball_count: torch.Tensor   # [N] int32
    pl_normal: torch.Tensor    # [N, Cpl, 3]
    pl_friction: torch.Tensor  # [N, Cpl]
    pl_count: torch.Tensor     # [N] int32
    dir_tangent: torch.Tensor  # [N, Cd, 3]
    dir_friction: torch.Tensor  # [N, Cd]
    dir_count: torch.Tensor    # [N] int32


@dataclasses.dataclass
class StencilState:
    """Offset-bucketed ("stencil") spring families.

    Family f connects left mass n to right mass n + deltas[f] for a
    constant index offset (the 13 lattice families, reference
    object.cu:250-291).  All arrays are [F, N] indexed by (family, left
    mass); ``mask`` marks where a spring exists; ``rest`` is state.
    """

    mask: torch.Tensor     # [F, N] bool
    k: torch.Tensor        # [F, N]
    rest: torch.Tensor     # [F, N]
    damping: torch.Tensor  # [F, N]
    type: torch.Tensor     # [F, N] int8
    omega: torch.Tensor    # [F, N]
    l_max: torch.Tensor    # [F, N]
    l_min: torch.Tensor    # [F, N]
    rate: torch.Tensor     # [F, N]


@dataclasses.dataclass
class Topology:
    """Remainder spring -> mass incidence for gather-mode accumulation:
    ``inc_idx[n, d]`` is a spring index (S = padding, reads zero) and
    ``inc_sign[n, d]`` is +1 at the right endpoint, -1 at the left."""

    inc_idx: torch.Tensor   # [N, D] int32 in [0, S]
    inc_sign: torch.Tensor  # [N, D]
    seg_perm: torch.Tensor  # [2S] int32 (SEGMENT mode)
    seg_ids: torch.Tensor   # [2S] int32


@dataclasses.dataclass
class SimState:
    """Everything the step function reads and writes."""

    t: torch.Tensor   # [] sim time
    dt: torch.Tensor  # [] timestep
    g: torch.Tensor   # [3] global acceleration
    masses: MassState
    springs: SpringState
    stencil: StencilState
    gcon: GlobalConstraints
    lcon: LocalConstraints
    topo: Topology


@dataclasses.dataclass(frozen=True)
class SceneShape:
    """Static (hashable) scene descriptor that selects the step variant;
    the same fields as ``titan_tpu.state.SceneShape``."""

    n_masses: int          # padded N
    n_springs: int         # padded S (remainder springs only)
    max_degree: int        # D (incidence degree of the remainder topology)
    stencil_deltas: tuple  # index offsets, one per stencil family
    has_remainder: bool    # any springs outside the stencil families
    n_planes: int
    n_balls: int
    plane_friction: tuple  # per-plane flag: any friction coefficient set
    cap_cp: int            # local constraint capacities
    cap_ball: int
    cap_pl: int
    cap_dir: int
    has_magnets: bool
    has_drag: bool
    has_breathing: bool    # any ACTIVE_*/ACTUATED_* springs
    has_actuated: bool     # any ACTUATED_* springs (rest length mutates)
    has_damping: bool      # any spring with damping != 0
    all_valid: bool        # no soft-deleted masses
    config: SimConfig
    magnet_binned: tuple = ()
    magnet_grid: bool = False
    magnet_receivers: int = 0
    remainder_span: int = 0
    stencil_uniform: tuple = (False, False, False, False, False)


def xla_only_shape(shape: SceneShape) -> SceneShape:
    """The shape with ``magnet_grid`` cleared, so that a step built from it
    never reaches the grid field kernel (``csrc/magnets_grid.cu``), which
    has no backward.  The gradient paths (``diff.py``) build their eager
    steps from it, as ``titan_tpu/state.py::xla_only_shape`` keeps Pallas
    out of the JAX package's autodiff; the name is kept so that the two
    can be found side by side."""
    if not shape.magnet_grid:
        return shape
    return dataclasses.replace(shape, magnet_grid=False)


def pad_to(n: int, mult: int = 128) -> int:
    """Round up to a multiple of 128 (the JAX package's lane width; kept so
    that both packages' arrays have the same shapes)."""
    return max(mult, ((n + mult - 1) // mult) * mult)


def _tensors(cls, src, device) -> object:
    """Build dataclass ``cls`` from the like-named attributes of ``src``."""
    return cls(**{
        f.name: torch.from_numpy(np.array(getattr(src, f.name))).to(device)
        for f in dataclasses.fields(cls)})


def state_from_numpy(np_state, device) -> SimState:
    """The port's ``SimState`` from a marshalled state whose leaves are
    numpy arrays (e.g. ``titan_tpu.state.state_to_numpy(sim._state)``),
    read by attribute name.  Dtypes are kept as they are."""
    as_t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    return SimState(
        t=as_t(np_state.t), dt=as_t(np_state.dt), g=as_t(np_state.g),
        masses=_tensors(MassState, np_state.masses, device),
        springs=_tensors(SpringState, np_state.springs, device),
        stencil=_tensors(StencilState, np_state.stencil, device),
        gcon=_tensors(GlobalConstraints, np_state.gcon, device),
        lcon=_tensors(LocalConstraints, np_state.lcon, device),
        topo=_tensors(Topology, np_state.topo, device),
    )


def state_to_numpy(state: SimState) -> dict:
    """Nested dict of numpy arrays (host copies) keyed like the dataclasses;
    the inverse direction of ``state_from_numpy`` for comparisons."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        else:
            out[f.name] = {g.name: getattr(v, g.name).detach().cpu().numpy()
                           for g in dataclasses.fields(v)}
    return out


def _config_from_fields(cfg, device) -> SimConfig:
    vals = {}
    for f in dataclasses.fields(SimConfig):
        if f.name == "device":
            continue
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            # enums map by value (the two packages' enum classes differ)
            v = type(f.default)(v.value)
        vals[f.name] = v
    return SimConfig(device=str(device), **vals)


def shape_from_fields(shape, device) -> SceneShape:
    """The port's ``SceneShape`` from another package's scene shape (read by
    attribute name), with its config's enums mapped by value and
    ``config.device`` set to ``device``."""
    vals = {f.name: getattr(shape, f.name)
            for f in dataclasses.fields(SceneShape) if f.name != "config"}
    return SceneShape(config=_config_from_fields(shape.config, device), **vals)


def _register_pytrees() -> None:
    """Register the state dataclasses as pytrees (``torch.utils._pytree``),
    so that ``torch.func.vmap`` maps over a ``SimState``
    (``parallel/batched.py``), as JAX maps over the JAX package's state."""
    import torch.utils._pytree as pytree
    for cls in (MassState, SpringState, GlobalConstraints, LocalConstraints,
                StencilState, Topology, SimState):
        names = tuple(f.name for f in dataclasses.fields(cls))
        pytree.register_pytree_node(
            cls,
            lambda x, names=names: ([getattr(x, n) for n in names], None),
            lambda leaves, _, cls=cls, names=names: cls(
                **dict(zip(names, leaves))),
            serialized_type_name=f"titan_tpu_torch.state.{cls.__name__}")


_register_pytrees()
