"""The port's sharded solves (``rbdtpu_torch.distrib``) on two gloo ranks
against rbdtpu's on its 8-device mesh, in float64 on the CPU.

Two processes join one gloo group through a ``file://`` rendezvous under
the test's temporary directory, run every case of
tests/make_distrib_fixture.py (``sharded_rollouts``, ``sharded_ddp_solve``
plain, with ``fused=True`` and over the 2-D ("host", "batch") mesh,
``sharded_mppi_step`` over one and two axes on rbdtpu's recorded draws: the
rank at shard r takes the draws of rbdtpu's devices 4r..4r+3) and write
what they return.  Tolerances: rollouts, J, mean J and MPPI 1e-9 (relative
where the value exceeds 1), controls 1e-6.  The ranks' results must equal
each other bit for bit, and the sharded solves a single-process
``ddp_solve`` of the same problems.  rbdtpu's results are recorded in
tests/data/distrib_refs.npz, so this file runs no JAX computation."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from make_distrib_fixture import (
    DDP, DDP_DT, DEVICES, GOAL_Q, MPPI, PATH,
)
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import DDPConfig, ddp_solve, quadratic_tracking_cost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2

# one rank: join the group, run every case, write the results
CHILD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, init, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
from make_distrib_fixture import DDP, DDP_DT, DEVICES, GOAL_Q, MPPI, MPPI_DT, PATH, ROLL_DT
from rbdtpu_torch.distrib import (
    make_mesh, replicate, shard_batch, sharded_ddp_solve, sharded_mppi_step,
    sharded_rollouts)
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import (
    DDPConfig, MPPIConfig, quadratic_tracking_cost)

dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
ref = dict(np.load(PATH))
T = lambda k: torch.tensor(ref[k], dtype=torch.float64)
mesh1 = make_mesh(device="cpu")
mesh2 = make_mesh(axis_names=("host", "batch"), shape=(2, 1), device="cpu")
arm = replicate(mesh1, load_asset("arm7", device="cpu", dtype=torch.float64))
out = {}
out["rollouts/X"] = sharded_rollouts(mesh1, arm, T("rollouts/x0"),
                                     T("rollouts/U"), ROLL_DT)
goal = torch.cat([torch.full((arm.nq,), GOAL_Q, dtype=torch.float64),
                  torch.zeros(arm.nv, dtype=torch.float64)])
cost = quadratic_tracking_cost(arm, goal)
for name, (B, H, iters, alphas, fused) in DDP.items():
    mesh, axis = ((mesh2, ("host", "batch")) if name.endswith("2d")
                  else (mesh1, "batch"))
    cfg = DDPConfig(iters=iters, dt=DDP_DT, n_alphas=alphas, fused=fused)
    J, U, mean_J = sharded_ddp_solve(mesh, arm, cost, T(name + "/x0"),
                                     T(name + "/U0"), cfg, axis=axis)
    out[name + "/J"], out[name + "/U"], out[name + "/mean_J"] = J, U, mean_J
mcost = quadratic_tracking_cost(arm, torch.zeros(arm.nx, dtype=torch.float64))
for name, (S, sigma, H, _) in MPPI.items():
    mesh, axis = ((mesh2, ("host", "batch")) if name.endswith("2d")
                  else (mesh1, "batch"))
    per = DEVICES // mesh.axis_size(axis)
    k = mesh.axis_index(axis)
    noise = T(name + "/noise")[k * per:(k + 1) * per].flatten(0, 1)
    cfg = MPPIConfig(n_samples=S, sigma=sigma, dt=MPPI_DT)
    U1, J1 = sharded_mppi_step(mesh, arm, mcost, T(name + "/x0"),
                               T(name + "/U0"), config=cfg, axis=axis,
                               noise=noise)
    out[name + "/U"], out[name + "/J_mean"] = U1, J1


def refuses(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


out["refused/odd_batch"] = refuses(
    lambda: shard_batch(mesh1, torch.zeros(3, 2), "batch"))
out["refused/n_devices"] = refuses(lambda: make_mesh(3, device="cpu"))
out["refused/shape"] = refuses(
    lambda: make_mesh(axis_names=("host", "batch"), shape=(2, 2),
                      device="cpu"))
out["refused/axis"] = refuses(lambda: mesh2.axis_size("model"))
out["refused/backend"] = refuses(
    lambda: make_mesh(device="cpu", backend="nccl"))
np.savez(f"{out_dir}/rank{rank}.npz",
         **{k: np.asarray(v) for k, v in out.items()})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small batched solves: one thread runs them as fast as eight and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two gloo ranks returned."""
    d = tmp_path_factory.mktemp("distrib")
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    init = f"file://{d}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), init, str(d),
         os.path.join(REPO, "tests")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    out = []
    for r in range(RANKS):
        with np.load(d / f"rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


def close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale)


@pytest.fixture(scope="module")
def arm():
    return load_asset("arm7", device="cpu", dtype=torch.float64)


def test_ranks_return_the_same_global_results(ranks):
    """Every rank holds the gathered batch and the reduced scalars, bit for
    bit the same on both."""
    a, b = ranks
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_rollouts_match_rbdtpu(ranks, ref):
    for r in ranks:
        close(r["rollouts/X"], ref["rollouts/X"], 1e-9)


@pytest.mark.parametrize("name", list(DDP))
def test_sharded_ddp_matches_rbdtpu(ranks, ref, name):
    """rbdtpu's 8 shards against the port's 2, on the same problems: J and
    mean J within 1e-9, controls within 1e-6."""
    for r in ranks:
        close(r[f"{name}/J"], ref[f"{name}/J"], 1e-9)
        close(r[f"{name}/mean_J"], ref[f"{name}/mean_J"], 1e-9)
        close(r[f"{name}/U"], ref[f"{name}/U"], 1e-6)


@pytest.mark.parametrize("name", list(DDP))
def test_sharded_ddp_matches_one_process(ranks, ref, arm, name):
    """The sharded solve against one process's ``ddp_solve`` of the whole
    batch (rbdtpu's launcher check: within 1e-9; here the per-problem
    arithmetic is the same, so J and U agree to rounding of the batch)."""
    B, H, iters, alphas, fused = DDP[name]
    goal = torch.cat([torch.full((arm.nq,), GOAL_Q, dtype=torch.float64),
                      torch.zeros(arm.nv, dtype=torch.float64)])
    cfg = DDPConfig(iters=iters, dt=DDP_DT, n_alphas=alphas, fused=fused)
    state, _ = ddp_solve(arm, quadratic_tracking_cost(arm, goal),
                         torch.tensor(ref[f"{name}/x0"]),
                         torch.tensor(ref[f"{name}/U0"]), cfg)
    for r in ranks:
        close(r[f"{name}/J"], state.J.numpy(), 1e-12)
        close(r[f"{name}/U"], state.U.numpy(), 1e-12)
        close(r[f"{name}/mean_J"], state.J.mean().item(), 1e-12)


@pytest.mark.parametrize("name", list(MPPI))
def test_sharded_mppi_matches_rbdtpu(ranks, ref, name):
    """rbdtpu's population over 8 devices against the port's over 2 ranks
    on the same draws: the update and the weighted cost within 1e-9."""
    assert ref[f"{name}/noise"].shape[0] == DEVICES
    for r in ranks:
        close(r[f"{name}/U"], ref[f"{name}/U"], 1e-9)
        close(r[f"{name}/J_mean"], ref[f"{name}/J_mean"], 1e-9)


@pytest.mark.parametrize("what", ["odd_batch", "n_devices", "shape", "axis",
                                  "backend"])
def test_mesh_refuses(ranks, what):
    """ValueError on a batch that does not divide over the shards, a mesh
    that does not match the world size (``n_devices``, ``shape``), an axis
    the mesh lacks, and a backend the process group does not run."""
    for r in ranks:
        assert bool(r[f"refused/{what}"]), what
