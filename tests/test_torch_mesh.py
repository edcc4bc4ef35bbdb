"""The port's batch mesh over ``torch.distributed``
(``accelerated_tinympc_tpu_torch.parallel``), on the CPU.

One module fixture launches a two-rank gloo world once
(``tests/torch_mesh_worker.py``, free port, under a timeout that kills both
ranks): every ``sharded_*`` entry point and
``TinyMPCFleet.solve_adaptive_rho(mesh=)``. The ranks' shards, stitched, are
held to the port's unsharded calls on the same inputs, and the reduced stats
to values recomputed from the unsharded outputs. ``sharded_solve`` is also
held to the JAX package's ``sharded_solve`` on a two-device mesh of the
conftest's CPU devices, at ``tests/test_parallel.py``'s bar.

Equality is exact except where stated: the plain versions run the same
per-instance arithmetic on half the batch, and where the CPU's BLAS groups a
product's sums by the batch's shape (``ROADMAP.md``, gotchas) a float32
field may move by a few ulp: ``ULP_TOL`` (1e-6 of the field's largest
entry), with iteration counts and flags exact.
"""

import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_mesh_worker as w
from torch_parity_utils import DEV

import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu_torch import parallel as par

WORKER = pathlib.Path(__file__).parent / "torch_mesh_worker.py"
WORLD = 2
TIMEOUT_S = 240
ULP_TOL = 1e-6
GLOBAL_CASES = ("cascade", "fleet")   # every rank holds the global result
TICK_MAJOR = ("rollout/us", "rollout/iters")
GROUPS = {
    "scan": ("solve", "block"),
    "fused": ("fused_fixed", "fused_adaptive", "fused_cones", "rollout"),
    "fleet_kernels": ("hetero", "adaptive_hetero"),
    "long_horizon": ("stream_fixed", "stream_adaptive", "hstream_fixed",
                     "hstream_adaptive"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out: pathlib.Path) -> list:
    """Both ranks; a rank that fails (or the timeout) kills the other."""
    addr = f"127.0.0.1:{_free_port()}"
    logs = [open(out / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), addr, str(WORLD), str(r), str(out)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (exit {procs[r].returncode}):\n"
                    + f.read()[-3000:])
        f.close()
    assert all(p.returncode == 0 for p in procs), "\n".join(text)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' outputs, stitched: shard outputs concatenated on the
    batch axis, global ones and stats checked equal on both ranks."""
    ranks = _launch(tmp_path_factory.mktemp("mesh"))
    stitched = {}
    for key in ranks[0]:
        parts = [r[key] for r in ranks]
        if "/stats/" in key or key.split("/")[0] in GLOBAL_CASES:
            np.testing.assert_array_equal(parts[0], parts[1], err_msg=key)
            stitched[key] = parts[0]
        else:
            stitched[key] = np.concatenate(
                parts, axis=1 if key in TICK_MAJOR else 0)
    return stitched


@pytest.fixture(scope="module")
def unsharded():
    d = w.inputs()
    return d, {case: w.flatten(fn(d), case, {})
               for case, fn in w.UNSHARDED.items()}


def _assert_same(got: np.ndarray, want: np.ndarray, key: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, key
    if np.issubdtype(want.dtype, np.floating):
        tol = ULP_TOL * max(1.0, float(np.abs(want).max(initial=0.0)))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


def _expected_stats(case: str, ref: dict, n: int) -> dict:
    """The stats recomputed from a case's outputs (``case/field`` keys),
    with JAX's dtypes."""
    f32 = np.float32
    if case in ("solve", "block"):
        it = ref[f"{case}/iter"]
        return {
            "n_total": f32(n),
            "n_converged": f32((ref[f"{case}/status"] == 1).sum()),
            "iterations_sum": f32(it.sum()), "iterations_max": it.max(),
            **{f"{k}_max": ref[f"{case}/{k}"].max() for k in (
                "primal_residual_state", "primal_residual_input",
                "dual_residual_state", "dual_residual_input")}}
    if case == "rollout":
        it = ref["rollout/iters"]
        return {"n_total": f32(n), "iterations_sum": it.sum(dtype=np.int32),
                "iterations_max": it.max(),
                "last_tick_iterations_mean": f32(it[-1].mean())}
    if case == "adaptive_hetero":
        return {"n_total": f32(n),
                "n_solved": f32(ref[f"{case}/solved"].sum()),
                "iterations_max": ref[f"{case}/total_iter"].max()}
    st = ref[f"{case}/stats"]
    res = {"primal_residual_state_max": st[:, 2].max(),
           "dual_residual_state_max": st[:, 3].max(),
           "primal_residual_input_max": st[:, 4].max(),
           "dual_residual_input_max": st[:, 5].max()}
    if case.startswith("fused"):
        return {"n_total": f32(n), "n_converged": f32(st[:, 1].sum()),
                "iterations_sum": f32(st[:, 0].sum()),
                "iterations_max": st[:, 0].max(), **res}
    if case == "hetero":
        return {"n_total": f32(n), "iterations_max": st[:, 0].max(), **res}
    return {"n_total": f32(n), **res}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_sharded_matches_unsharded(world, unsharded, group):
    """Every sharded entry point, stitched from the two ranks, equals the
    port's unsharded call on the same inputs; its stats equal the values
    recomputed from the unsharded outputs, dtype for dtype."""
    d, refs = unsharded
    for case in GROUPS[group]:
        ref = refs[case]
        for key, want in ref.items():
            if key in world:
                _assert_same(world[key], want, key)
        assert any(k in world for k in ref), case
        n = next(v for k, v in ref.items()
                 if k not in TICK_MAJOR).shape[0]
        stats = {k.rsplit("/", 1)[1]: v for k, v in world.items()
                 if k.startswith(f"{case}/stats/")}
        # exactly the reduction of the stitched outputs, and within a few
        # ulp of the iterates of the unsharded outputs' (counts exact)
        mine = _expected_stats(case, world, n)
        want = _expected_stats(case, ref, n)
        if case == "adaptive_hetero":
            rounds = w.UNSHARDED[case](d).rounds
            assert stats.pop("rounds_max") == rounds
            assert stats["n_solved"] < n, "premise: some instances unsolved"
        assert list(stats) == list(want), case
        for k, v in want.items():
            assert stats[k].dtype == np.asarray(v).dtype, (case, k)
            np.testing.assert_array_equal(stats[k], mine[k],
                                          err_msg=f"{case} {k}")
            if k.endswith("residual_state_max") or k.endswith(
                    "residual_input_max"):
                np.testing.assert_allclose(stats[k], v, rtol=0,
                                           atol=ULP_TOL, err_msg=case + k)
            else:
                np.testing.assert_array_equal(stats[k], v,
                                              err_msg=f"{case} {k}")


def test_uneven_convergence_stats(world):
    """JAX's ``test_uneven_convergence_stats``: the ranks converge
    differently and the reduced fraction is the global one."""
    status = world["solve/status"]
    per_rank = (status == atm_t.SOLVED).reshape(WORLD, -1).mean(axis=1)
    assert per_rank[0] != per_rank[1], per_rank
    s = par.summarize_stats({k.rsplit("/", 1)[1]: v for k, v in world.items()
                             if k.startswith("solve/stats/")})
    assert s["n_total"] == w.B
    assert s["converged_fraction"] == pytest.approx(
        float(np.mean(status == atm_t.SOLVED)))
    assert s["iterations_mean"] == pytest.approx(
        float(world["solve/iter"].mean()), rel=1e-6)


def test_sharded_solve_matches_jax(world):
    """``sharded_solve`` + ``summarize_stats`` against the JAX package's
    ``sharded_solve`` on a two-device mesh (``tests/test_parallel.py``'s
    bar: equal ``iter`` and ``status``, ``u`` within 1e-4)."""
    import jax
    import jax.numpy as jnp

    import accelerated_tinympc_tpu as atm_j
    from accelerated_tinympc_tpu.parallel import mesh as jmesh
    from accelerated_tinympc_tpu.solver.batched import init_state_batched

    problem, cache, _x0 = atm_j.models.quadrotor_hovering_setup()
    x0s = jnp.asarray(w.quad_x0s(w.B))
    st = init_state_batched(w.B, 12, 4, 10)
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    m = jmesh.make_batch_mesh(WORLD)
    got_j, stats_j = jmesh.sharded_solve(m, atm_j.Settings(**w.SOLVE_SETS))(
        jmesh.shard_batch(st, m), jmesh.replicate(problem, m),
        jmesh.replicate(cache, m))
    np.testing.assert_array_equal(world["solve/iter"], np.asarray(got_j.iter))
    np.testing.assert_array_equal(world["solve/status"],
                                  np.asarray(got_j.status))
    np.testing.assert_allclose(world["solve/u"], np.asarray(got_j.u),
                               rtol=0, atol=1e-4)
    ours = {k.rsplit("/", 1)[1]: v for k, v in world.items()
            if k.startswith("solve/stats/")}
    assert sorted(ours) == sorted(stats_j)   # jit returns its keys sorted
    for k, v in stats_j.items():
        assert ours[k].dtype == np.asarray(v).dtype, k
    s_t, s_j = par.summarize_stats(ours), jmesh.summarize_stats(stats_j)
    for k in ("n_total", "converged_fraction", "iterations_mean",
              "iterations_max"):
        assert s_t[k] == s_j[k], k
    for k in s_j:
        assert s_t[k] == pytest.approx(s_j[k], abs=1e-4), k
    del jax


def test_sharded_block_solver_hook(world, unsharded):
    """JAX's ``test_sharded_block_solver_hook``: ``sharded_solve``'s
    ``solver=`` hook with the block-condensed sweeps."""
    _d, refs = unsharded
    np.testing.assert_array_equal(world["block/iter"], refs["block"]["block/iter"])
    _assert_same(world["block/u"], refs["block"]["block/u"], "block/u")
    assert float(world["block/stats/n_total"]) == w.B


def test_cascade_iteration_exact_and_reclaims(world, unsharded):
    """JAX's ``test_iteration_exact_and_reclaims``: schedules exactly the
    one-call adaptive solve's, every rank holding the global result; the
    controls at that test's 1e-4 (the survivors run at other batch shapes),
    and the port's unsharded cascade's values; buckets shrank below a
    rank's share once the easy rank converged."""
    _d, refs = unsharded
    one, casc = refs["cascade_one_call"], refs["cascade"]
    for col in (0, 1):
        np.testing.assert_array_equal(
            world["cascade/stats"][:, col],
            one["cascade_one_call/stats"][:, col])
    for f in ("U", "carry/D"):
        np.testing.assert_allclose(world[f"cascade/{f}"],
                                   one[f"cascade_one_call/{f}"], rtol=0,
                                   atol=1e-4)
    for key, want in casc.items():
        _assert_same(world[key], want, key)
    log = world["cascade/stats/segment_log"]
    assert len(log), "no compactions happened"
    assert log[:, 1].min() < w.B // WORLD, log


def test_fleet_adaptive_rho_mesh(world):
    """JAX's ``test_fleet_adaptive_rho_mesh``: ``solve_adaptive_rho(mesh=)``
    against the unsharded ``engine="hetero"`` loop; every rank's fleet
    adopts the global caches and controls."""
    f0 = w.adapt_fleet()
    want = f0.solve_adaptive_rho(engine="hetero", **w.FLEET_ADAPT_KW)
    np.testing.assert_array_equal(world["fleet/solved"], want["solved"])
    assert world["fleet/solved"].all()
    assert int(world["fleet/rounds"]) == want["rounds"]
    np.testing.assert_array_equal(world["fleet/iterations"],
                                  want["iterations"])
    for key, v in (("fleet/rho", want["rho"]),
                   ("fleet/Kinf", f0.cache.Kinf.numpy()),
                   ("fleet/U", f0.get_u().numpy())):
        _assert_same(world[key], v, key)


def test_world_of_one_is_the_unsharded_call(unsharded):
    """Without a process group the mesh is a world of one: the sharded
    calls are the unsharded calls, bit for bit, and the cascade keeps the
    one-call schedule."""
    d, refs = unsharded
    mesh = par.make_batch_mesh(device=DEV)
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, None)
    assert par.make_batch_mesh(1, device=DEV) == mesh
    par.initialize_distributed(None, 1, 0)   # a single process: nothing
    assert not torch.distributed.is_initialized()
    pp, sh = d["pp"], lambda t: par.shard_batch(t, mesh)
    cold = w.FusedCarry.zeros(w.B, pp, device=DEV)
    got = {
        "fused_fixed": par.sharded_fused_solve(mesh, pp, max_iter=20)(
            sh(d["x0s"]), sh(cold))[0],
        "rollout": par.sharded_fused_rollout(
            mesh, pp, d["rops"], 4, max_iter=15, check_termination=1)(
            sh(d["x0s"]), sh(cold))[0],
        "hetero": par.sharded_hetero_solve(mesh, max_iter=20)(
            sh(d["xf"]), sh(w.HeteroCarry.zeros(d["fleet"]._hp)),
            sh(d["fleet"]._hp))[0],
        "stream_fixed": par.sharded_stream_solve(mesh, max_iter=30)(
            sh(d["xl"]), sh(w.StreamCarry.zeros(w.BL, d["sp"])),
            d["sp"])[0],
    }
    for case, res in got.items():
        for key, v in w.flatten(res, case, {}).items():
            np.testing.assert_array_equal(v, refs[case][key], err_msg=key)
    casc = par.sharded_cascade_solve(mesh, pp, **w.CASCADE_KW,
                                     **w.CASCADE_SETS)(d["cascade_x0"], cold)
    np.testing.assert_array_equal(
        casc.stats[:, :2].numpy(),
        refs["cascade_one_call"]["cascade_one_call/stats"][:, :2])
    # examples/torch_multichip_sharded.py, a world of one on the CPU
    from chip_smoke import run_example

    lines, failed = run_example("torch_multichip_sharded.py", "--cpu",
                                "--batch-per-device", "4")
    assert failed is None and lines[0].startswith("1 devices (cpu"), lines
    assert "  n_total: 4.0000" in lines, lines


def test_shard_batch_layout_and_refusals():
    """``shard_batch`` takes rank r's rows ``[r B/n, (r+1) B/n)`` (JAX's
    ``P(BATCH_AXIS)``) of every leaf and keeps other leaves; a batch that
    does not divide, a 0-d leaf, a device count that is not the world size
    and a backend this torch lacks are refused."""
    mesh = par.BatchMesh(size=4, rank=2, device=torch.device("cpu"))
    x = torch.arange(24.0).reshape(8, 3)
    carry = w.FusedCarry(*(x + k for k in range(5)))
    got = par.shard_batch({"x": x, "carry": carry, "n": 3, "s": "keep"}, mesh)
    assert torch.equal(got["x"], x[4:6]) and got["n"] == 3
    assert isinstance(got["carry"], w.FusedCarry)
    assert torch.equal(got["carry"].V, x[4:6] + 4)
    with pytest.raises(ValueError, match="batch 6 must divide by mesh size 4"):
        par.shard_batch(torch.zeros(6, 2), mesh)
    with pytest.raises(ValueError, match="0-d"):
        par.shard_batch(torch.zeros(()), mesh)
    with pytest.raises(ValueError, match="world has 1"):
        par.make_batch_mesh(2, device=DEV)
    assert par.BATCH_AXIS == "batch"
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="'nccl' is not available"):
            par.initialize_distributed("127.0.0.1:1", 2, 0, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_fleet_mesh_refuses_cone_overrides():
    """Per-instance cone parameters are single-device only under a mesh, as
    in the JAX package (``api/fleet.py:738-744``)."""
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    A, Bm, Q, R = w._lti_plants(4, 6)
    f = atm_t.TinyMPCFleet.setup(
        A, Bm, Q, R, 1.0, 6, u_min=-2.0, u_max=2.0, polish=False,
        cones=ConeSet(input_cones=(Cone(ball=(0, 1), axis=2, mu=1.0),)),
        cone_mu=np.full((1, 4), 0.5), device=DEV)
    f.set_x0(np.zeros((4, 8), np.float32))
    with pytest.raises(ValueError, match="single-device only"):
        f.solve_adaptive_rho(mesh=par.make_batch_mesh(device=DEV))
