"""One rank of a CPU world over gloo for ``tests/test_torch_mesh.py``, and
the cases it runs.

    python tests/torch_mesh_worker.py <host:port> <world> <rank> <out_dir>

Each rank brings the process group up through the port's
``initialize_distributed`` (gloo, CPU ranks), runs every ``sharded_*`` entry
point and ``TinyMPCFleet.solve_adaptive_rho(mesh=)`` on the inputs that
:func:`inputs` builds from fixed seeds, and writes its outputs and the
reduced stats to ``<out_dir>/rank<r>.npz`` (keys ``case/field``). The test
imports this module to build the same inputs and the port's unsharded calls
(:data:`UNSHARDED`) on them. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import os
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import accelerated_tinympc_tpu_torch as atm  # noqa: E402
from accelerated_tinympc_tpu_torch import parallel as par  # noqa: E402
from accelerated_tinympc_tpu_torch.ops import (  # noqa: E402
    FusedCarry, HeteroCarry, StreamCarry, fused_rollout, fused_solve,
    hetero_solve, hstream_solve, pad_cones, pad_problem, pad_stream_problem,
    rollout_ops, stream_solve,
)
from accelerated_tinympc_tpu_torch.solver import (  # noqa: E402
    Cone, ConeSet, block_sweeps, cascade_solve, init_state_batched,
    solve_adaptive_rho_hetero, solve_batched,
)

DEV = "cpu"
B = 16          # the quadrotor cases (8 a rank)
BF = 8          # the 12/4/10 fleet of perturbed quadrotors
BL, NL = 8, 32  # the 8/3 long-horizon plant
B_ADAPT, N_ADAPT = 12, 10   # the fleet adaptive-rho case (JAX's test_fleet)

SOLVE_SETS = dict(abs_pri_tol=0.05, abs_dua_tol=0.05, max_iter=150,
                  check_termination=1)
CASCADE_SETS = dict(max_iter=60, check_termination=5, abs_pri_tol=0.2,
                    abs_dua_tol=0.2)
CASCADE_KW = dict(segment_iters=10, segment_growth=1.0, min_bucket=2)
FLEET_ADAPT_SETS = dict(abs_pri_tol=0.02, abs_dua_tol=0.02,
                        check_termination=1)
FLEET_ADAPT_KW = dict(chunk=25, max_rounds=40, riccati="vmap")
ADAPT_KW = dict(chunk=10, max_rounds=6)
THRUST_CONE = ConeSet(input_cones=(Cone(ball=(0, 1), axis=2, mu=0.8,
                                        shift=0.2),))


def quad_x0s(n: int, seed: int = 3, scale=0.1) -> np.ndarray:
    _p, _c, x0 = atm.models.quadrotor_hovering_setup(device=DEV)
    rng = np.random.default_rng(seed)
    scale = np.broadcast_to(np.asarray(scale, np.float64), (n,))[:, None]
    return (x0[None] + scale * rng.standard_normal((n, 12))).astype(
        np.float32)


def inputs() -> dict:
    """Every case's global inputs, from fixed seeds (the same in every
    process)."""
    problem, cache, _x0 = atm.models.quadrotor_hovering_setup(device=DEV)
    ops = atm.condensed_operators(cache, problem.A, problem.B,
                                  problem.horizon, device=DEV)
    pp = pad_problem(problem, cache, ops, device=DEV)
    x0s = torch.as_tensor(quad_x0s(B))
    st = init_state_batched(B, 12, 4, 10, device=DEV)
    x = st.x.clone()
    x[:, 0, :] = x0s
    cascade_x0 = torch.as_tensor(quad_x0s(
        B, seed=5, scale=np.r_[np.full(B // 2, 0.01), np.full(B // 2, 1.5)]))

    # the 12/4/10 fleet: the quadrotor's plant, its input matrix scaled per
    # instance (a mass spread)
    rng = np.random.default_rng(11)
    Bf = problem.B.numpy()[None] * (
        1.0 + 0.1 * rng.uniform(-1, 1, (BF, 1, 1)))
    rep = lambda a: np.repeat(a.numpy()[None], BF, axis=0)
    fleet = atm.TinyMPCFleet.setup(
        rep(problem.A), Bf, rep(problem.Q), rep(problem.R), float(cache.rho),
        10, u_min=-0.5, u_max=0.5, x_min=-5.0, x_max=5.0, polish=False,
        device=DEV)
    hstream = atm.TinyMPCFleet.setup(
        *_lti_plants(BL, NL), 1.0, NL, u_min=-3.0, u_max=3.0,
        tier="hstream", polish=False, device=DEV)
    lp, _rho = atm.models.random_lti_problem(seed=803, nx=8, nu=3,
                                             horizon=NL, device=DEV)
    lcache = atm.riccati_cache(lp.A, lp.B, lp.Q, lp.R, 1.0, device=DEV)
    rng = np.random.default_rng(12)
    return {
        "problem": problem, "cache": cache, "pp": pp,
        "rops": rollout_ops(problem, pp, device=DEV), "x0s": x0s,
        "state": st.replace(x=x), "cascade_x0": cascade_x0,
        "fleet": fleet, "xf": torch.as_tensor(quad_x0s(BF, seed=13)),
        "rho_fleet": fleet.cache.rho.reshape(-1).expand(BF).contiguous()
        * torch.as_tensor(np.r_[np.ones(BF // 2), np.full(BF // 2, 20.0)],
                          dtype=torch.float32),
        "sp": pad_stream_problem(lp, lcache), "hsp": hstream._hp,
        "xl": torch.as_tensor(
            (0.5 * rng.standard_normal((BL, 8))).astype(np.float32)),
    }


def _lti_plants(n: int, N: int):
    """``n`` random 8/3 plants (JAX's ``test_fleet`` recipe) as numpy."""
    As, Bs, Qs, Rs = [], [], [], []
    for seed in range(n):
        p, _rho = atm.models.random_lti_problem(seed=seed, nx=8, nu=3,
                                                horizon=N, device=DEV)
        As.append(p.A.numpy())
        Bs.append(p.B.numpy())
        Qs.append(p.Q.numpy())
        Rs.append(p.R.numpy())
    return np.stack(As), np.stack(Bs), np.stack(Qs), np.stack(Rs)


def adapt_fleet():
    """JAX ``test_fleet_adaptive_rho_mesh``'s fleet: 12 random 8/3 plants,
    rho mis-scaled over six decades for half of them."""
    A, Bm, Q, R = _lti_plants(B_ADAPT, N_ADAPT)
    rho0 = np.asarray([1.0] * 6 + [1e-3] * 3 + [1e3] * 3, np.float32)
    f = atm.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=rho0, horizon=N_ADAPT,
        settings=atm.Settings(**FLEET_ADAPT_SETS), tier="hetero",
        polish=False, device=DEV)
    f.set_x0((0.4 * np.random.default_rng(1).standard_normal(
        (B_ADAPT, 8))).astype(np.float32))
    return f


def _adapt_args(d):
    f = d["fleet"]
    p = f.problem
    return (d["xf"], p, p.A, p.B, p.Q, p.R, d["rho_fleet"])


def _fleet_settings(d):
    return d["fleet"].settings.replace(max_iter=100, check_termination=2)


# The port's unsharded calls, one per case: name -> fn(inputs) -> outputs.
UNSHARDED = {
    "solve": lambda d: solve_batched(d["state"], d["problem"], d["cache"],
                                     atm.Settings(**SOLVE_SETS)),
    "block": lambda d: solve_batched(
        d["state"], d["problem"], d["cache"],
        atm.Settings(max_iter=15, check_termination=1),
        **dict(zip(("forward", "backward"), block_sweeps(
            d["cache"], d["problem"].A, d["problem"].B, 10, 4)))),
    "fused_fixed": lambda d: fused_solve(
        d["x0s"], FusedCarry.zeros(B, d["pp"], device=DEV), d["pp"],
        max_iter=20),
    "fused_adaptive": lambda d: fused_solve(
        d["cascade_x0"], FusedCarry.zeros(B, d["pp"], device=DEV), d["pp"],
        max_iter=60, check_termination=2, abs_pri_tol=0.05,
        abs_dua_tol=0.05),
    "fused_cones": lambda d: fused_solve(
        d["x0s"], FusedCarry.zeros(B, d["pp"], device=DEV), d["pp"],
        max_iter=20, cone_ops=pad_cones(d["pp"], THRUST_CONE)),
    "rollout": lambda d: fused_rollout(
        d["x0s"], FusedCarry.zeros(B, d["pp"], device=DEV), d["pp"],
        d["rops"], 4, max_iter=15, check_termination=1),
    "hetero": lambda d: hetero_solve(
        d["xf"], HeteroCarry.zeros(d["fleet"]._hp), d["fleet"]._hp,
        max_iter=20),
    "adaptive_hetero": lambda d: solve_adaptive_rho_hetero(
        *_adapt_args(d), _fleet_settings(d), **ADAPT_KW),
    "stream_fixed": lambda d: stream_solve(
        d["xl"], StreamCarry.zeros(BL, d["sp"]), d["sp"], max_iter=30),
    "stream_adaptive": lambda d: stream_solve(
        d["xl"], StreamCarry.zeros(BL, d["sp"]), d["sp"], max_iter=60,
        check_termination=5),
    "hstream_fixed": lambda d: hstream_solve(
        d["xl"], StreamCarry.zeros(BL, d["hsp"]), d["hsp"], max_iter=30),
    "hstream_adaptive": lambda d: hstream_solve(
        d["xl"], StreamCarry.zeros(BL, d["hsp"]), d["hsp"], max_iter=60,
        check_termination=5),
    "cascade_one_call": lambda d: fused_solve(
        d["cascade_x0"], FusedCarry.zeros(B, d["pp"], device=DEV), d["pp"],
        **CASCADE_SETS),
    "cascade": lambda d: cascade_solve(
        d["cascade_x0"], FusedCarry.zeros(B, d["pp"], device=DEV), d["pp"],
        segment_iters=10, segment_growth=1.0, **CASCADE_SETS),
}


def sharded(mesh, d: dict) -> dict:
    """Every sharded entry point on this rank: case -> (outputs, stats);
    the cascade and the fleet return global results."""
    sh = lambda t: par.shard_batch(t, mesh)
    rep = lambda t: par.replicate(t, mesh)
    pp = d["pp"]
    cold = lambda n: FusedCarry.zeros(n, pp, device=DEV)
    fwd, bwd = block_sweeps(d["cache"], d["problem"].A, d["problem"].B, 10, 4)
    block_sets = atm.Settings(max_iter=15, check_termination=1)
    out = {
        "solve": par.sharded_solve(mesh, atm.Settings(**SOLVE_SETS))(
            sh(d["state"]), rep(d["problem"]), rep(d["cache"])),
        "block": par.sharded_solve(
            mesh, block_sets, solver=lambda s, p, c: solve_batched(
                s, p, c, block_sets, forward=fwd, backward=bwd))(
            sh(d["state"]), rep(d["problem"]), rep(d["cache"])),
        "fused_fixed": par.sharded_fused_solve(mesh, pp, max_iter=20)(
            sh(d["x0s"]), sh(cold(B))),
        "fused_adaptive": par.sharded_fused_solve(
            mesh, pp, max_iter=60, check_termination=2, abs_pri_tol=0.05,
            abs_dua_tol=0.05)(sh(d["cascade_x0"]), sh(cold(B))),
        "fused_cones": par.sharded_fused_solve(
            mesh, pp, max_iter=20, cone_ops=pad_cones(pp, THRUST_CONE))(
            sh(d["x0s"]), sh(cold(B))),
        "rollout": par.sharded_fused_rollout(
            mesh, pp, d["rops"], 4, max_iter=15, check_termination=1)(
            sh(d["x0s"]), sh(cold(B))),
        "hetero": par.sharded_hetero_solve(mesh, max_iter=20)(
            sh(d["xf"]), sh(HeteroCarry.zeros(d["fleet"]._hp)),
            sh(d["fleet"]._hp)),
        "adaptive_hetero": par.sharded_adaptive_hetero(
            mesh, _fleet_settings(d), **ADAPT_KW)(
            *(sh(a) for a in _adapt_args(d))),
        "stream_fixed": par.sharded_stream_solve(mesh, max_iter=30)(
            sh(d["xl"]), sh(StreamCarry.zeros(BL, d["sp"])), d["sp"]),
        "stream_adaptive": par.sharded_stream_solve(
            mesh, max_iter=60, check_termination=5)(
            sh(d["xl"]), sh(StreamCarry.zeros(BL, d["sp"])), d["sp"]),
        "hstream_fixed": par.sharded_hstream_solve(mesh, max_iter=30)(
            sh(d["xl"]), sh(StreamCarry.zeros(BL, d["hsp"])),
            sh(d["hsp"])),
        "hstream_adaptive": par.sharded_hstream_solve(
            mesh, max_iter=60, check_termination=5)(
            sh(d["xl"]), sh(StreamCarry.zeros(BL, d["hsp"])),
            sh(d["hsp"])),
    }
    log: list = []
    out["cascade"] = (par.sharded_cascade_solve(
        mesh, pp, segment_log=log, **CASCADE_KW, **CASCADE_SETS)(
        d["cascade_x0"], cold(B)), {"segment_log": torch.tensor(log)})
    f = adapt_fleet()
    res = f.solve_adaptive_rho(mesh=mesh, **FLEET_ADAPT_KW)
    out["fleet"] = ({**{k: torch.as_tensor(v) for k, v in res.items()},
                     "Kinf": f.cache.Kinf, "U": f.get_u()}, {})
    return out


def flatten(tree, prefix: str, into: dict) -> dict:
    """``{prefix/field...: numpy}`` for every tensor of a result pytree."""
    if isinstance(tree, torch.Tensor):
        into[prefix] = tree.detach().cpu().numpy()
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            flatten(getattr(tree, k), f"{prefix}/{k}", into)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            flatten(v, f"{prefix}/{k}", into)
    elif hasattr(tree, "tensors"):
        for k, v in tree.tensors().items():
            flatten(v, f"{prefix}/{k}", into)
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            flatten(getattr(tree, k), f"{prefix}/{k}", into)
    return into


def main() -> int:
    addr, world, rank, out_dir = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    par.initialize_distributed(addr, world, rank, device=DEV)
    mesh = par.make_batch_mesh(world, device=DEV)
    assert (mesh.size, mesh.rank, mesh.backend) == (world, rank, "gloo")
    flat: dict = {}
    for case, (res, stats) in sharded(mesh, inputs()).items():
        flatten(res, case, flat)
        flatten(stats, f"{case}/stats", flat)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **flat)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
