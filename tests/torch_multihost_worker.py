"""Worker of the port's 2-process test (test_torch_multihost.py): each
process holds 2 of the 4 CPU shards of one global mesh over gloo.

Both processes build the same scene (the replicated control plane) and run
``run_all``: the distributed tiled chunk, ``Simulation.distribute`` from
start to a pause, and a gradient through the distributed adjoint.  Rank 0
writes the results to an .npz file; the parent holds them bitwise against
``run_all`` in one process over 4 shards.  Imports neither JAX nor the JAX
package.

Run:  python torch_multihost_worker.py <port> <n_procs> <rank> <out.npz>
"""

import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import titan_tpu_torch as tt  # noqa: E402
from titan_tpu_torch.ops.adjoint import leaves_of, with_leaves  # noqa: E402
from titan_tpu_torch.parallel import multihost  # noqa: E402
from titan_tpu_torch.parallel.halo_adjoint import (  # noqa: E402
    halo_adjoint_rollout)
from titan_tpu_torch.parallel.halo_tiled import (  # noqa: E402
    build_halo_tiled_chunk)
from titan_tpu_torch.parallel.sharded import DistributedChunk  # noqa: E402


def scene(device="cpu"):
    """A long lattice (deltas up to 21, 128-mass blocks over 4 shards)
    with damping, a friction plane and two remainder springs (the glue)."""
    sim = tt.Simulation(tt.SimConfig(device=device, velocity_clamp=False))
    sim.createLattice(tt.Vec(0, 0, 3), tt.Vec(8, 1, 1), 32, 4, 4)
    sim.setAllSpringConstantValues(500.0)
    for base, d in ((10, 23), (200, 31)):
        sp = sim.createSpring(sim.masses[base], sim.masses[base + d])
        sp._k = 800.0
        sp.defaultLength()
    st = sim._store
    st.damping[:st.n_springs] = 0.3
    sim.createPlane(tt.Vec(0, 0, 1), 0, 0.2, 0.3)
    sim.setGlobalAcceleration(tt.Vec(0, 0, -9.8))
    sim.setTimeStep(1e-4)
    return sim


def run_all(mesh, device="cpu"):
    """The three legs over ``mesh``; a dict of host arrays."""
    out = {}
    sim = scene(device)
    sim._T = 0.0
    sim._marshal()
    shape, state = sim._shape, sim._state
    run = build_halo_tiled_chunk(shape, mesh)
    fwd = DistributedChunk("halo_tiled", shape, mesh, "shard", run.b,
                           run)(state, 12)
    out["tiled_pos"] = fwd.masses.pos.cpu().numpy()
    out["tiled_vel"] = fwd.masses.vel.cpu().numpy()

    live = scene(device)
    live.distribute(mesh)
    live.start()
    live.pause(0.001)
    live.getAll()
    out["sim_pos"] = live._store.pos.copy()
    out["sim_route"] = np.array(live._chunk.route)
    live.stop()

    leaves = [x.detach().clone().requires_grad_() for x in leaves_of(state)]
    final = halo_adjoint_rollout(shape, with_leaves(state, leaves), mesh, 6,
                                 segment=3)
    w = torch.linspace(-1.0, 1.0, final.masses.pos.numel()).reshape(
        final.masses.pos.shape)
    loss = (final.masses.pos * w).sum() + (final.masses.vel ** 2).sum()
    grads = torch.autograd.grad(loss, [leaves[0], state_leaf(leaves, "k"),
                                       state_leaf(leaves, "springs.k")])
    for name, g in zip(("g_pos", "g_k", "g_springs_k"), grads):
        out[name] = g.cpu().numpy()
    return out


def state_leaf(leaves, name):
    from titan_tpu_torch.ops.adjoint import LEAVES
    return leaves[LEAVES.index(name)]


def main():
    port, n_procs, rank, path = sys.argv[1:5]
    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", int(n_procs), int(rank))
    mesh = multihost.make_global_mesh(
        ("shard",), devices=[torch.device("cpu")] * (4 // int(n_procs)))
    out = run_all(mesh)
    multihost.assert_replicated_control_plane(float(out["tiled_pos"].sum()),
                                              "final positions")
    if int(rank) == 0:
        np.savez(path, **out)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"WORKER {rank} OK", flush=True)


if __name__ == "__main__":
    main()
