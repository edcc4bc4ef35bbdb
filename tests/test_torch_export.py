"""PyTorch port, AOT export (``api/export.py``) against the live port and
the JAX package on the CPU: the scan tier's artifact equals the live
``solve_batched`` bit for bit and the JAX package's exported solve within
the float32 parity bar (batch 2, 10 iterations, as ``tests/test_api.py``);
an adaptive
artifact keeps the live solve's iteration counts and bits, with or
without cones baked in; the fused tier's artifact goes through the
``atm_torch::fused_solve`` op and equals ``fused_solve_plain`` bit for bit,
and the launch both routes of that op share checks the operands an
artifact bakes in. One export per kind: each traces the solve (seconds on
the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
from accelerated_tinympc_tpu.api import export as export_j
from accelerated_tinympc_tpu.models import quadrotor_hovering_setup as hover_j
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu_torch.models import random_lti_problem
from accelerated_tinympc_tpu_torch.api import (
    export_batched_solve, export_fused_solve, load_exported, save_exported,
)
from accelerated_tinympc_tpu_torch.ops import (
    FusedCarry, fused_solve, fused_solve_plain, pad_problem,
)
from accelerated_tinympc_tpu_torch.solver.batched import (
    init_state_batched, solve_batched,
)

from torch_parity_utils import (
    DEV, assert_fields_close, lander_pair, perturbed_x0, to_np,
)

OUTPUTS = ("x", "u", "iterations", "status", "primal_residual_state",
           "primal_residual_input", "dual_residual_state",
           "dual_residual_input")
LIVE_NAMES = dict(iterations="iter")
# The two packages' float32 scan tiers after 10 iterations from the
# quadrotor's x0: |du| 1.97e-6 (max |u| 1.12), |dx| 3.49e-5 (max |x| 4.2);
# held at the float32 parity bar of tests/test_torch_admm.py, relative to
# each output's largest entry, counts and status equal.
F32_ATOL = 1e-4


def _live(problem, cache, settings, x0s):
    st = init_state_batched(x0s.shape[0], problem.nx, problem.nu,
                            problem.horizon, device=DEV)
    x = st.x.clone()
    x[:, 0, :] = x0s
    return solve_batched(st.replace(x=x), problem, cache, settings)


def _assert_equals_live(out, live):
    for k in OUTPUTS:
        want = getattr(live, LIVE_NAMES.get(k, k))
        assert out[k].dtype == want.dtype, k
        assert torch.equal(out[k], want), k


def test_scan_artifact_equals_live_solve_and_jax_export(tmp_path):
    """export_batched_solve (fixed, batch 2, 10 iterations): saved, loaded
    and called, it gives the live solve_batched's bits on every output,
    and the JAX package's exported solve within the float32 parity bar."""
    problem, cache, x0 = atm_t.models.quadrotor_hovering_setup(device=DEV)
    settings = atm_t.Settings(max_iter=10, check_termination=0)
    f = tmp_path / "solve.pt2"
    save_exported(f, export_batched_solve(problem, cache, settings, batch=2))
    solve = load_exported(f)
    x0s = torch.as_tensor(np.tile(np.asarray(x0, np.float32), (2, 1)))
    out = solve(x0s)
    assert set(out) == set(OUTPUTS)
    _assert_equals_live(out, _live(problem, cache, settings, x0s))

    pj, cj, _ = hover_j()
    ej = export_j.export_batched_solve(
        pj, cj, atm_j.Settings(max_iter=10, check_termination=0), batch=2)
    fj = tmp_path / "solve.jaxexport"
    export_j.save_exported(fj, ej)
    out_j = export_j.load_exported(fj)(jnp.asarray(to_np(x0s)))
    assert_fields_close(out, dict(out_j), atol=F32_ATOL, scaled=True,
                        names=OUTPUTS, label="jax export: ")
    with pytest.raises(ValueError, match="one platform"):
        export_batched_solve(problem, cache, settings, 2,
                             platforms=("cpu", "cuda"))


def test_adaptive_artifact_keeps_the_iteration_counts():
    """An adaptive artifact (check every iteration) stops and freezes as the
    live solve does: the same per-instance counts (4, 5, 5 and two at the
    cap of 20 on a random 4/2/5 plant) and the same bits."""
    problem, rho = random_lti_problem(0, 4, 2, 5, device=DEV)
    cache = atm_t.riccati_cache(problem.A, problem.B, problem.Q, problem.R,
                                rho, device=DEV)
    settings = atm_t.Settings(max_iter=20, check_termination=1)
    rng = np.random.default_rng(1)
    scale = np.asarray([0.1, 0.3, 1.0, 3.0, 6.0])[:, None]
    x0s = torch.as_tensor(rng.standard_normal((5, 4)) * scale,
                          dtype=torch.float32)
    # Called as exported (the coned test below saves and loads an adaptive
    # artifact).
    out = export_batched_solve(problem, cache, settings, batch=5).module()(x0s)
    live = _live(problem, cache, settings, x0s)
    _assert_equals_live(out, live)
    assert to_np(live.iter).tolist() == [4, 5, 5, 20, 20]
    assert to_np(live.status).tolist() == [atm_t.SOLVED] * 3 + [
        atm_t.UNSOLVED] * 2


def test_coned_artifact_equals_live_solve(tmp_path):
    """Cones baked in (the lander's thrust-tilt and glideslope cones,
    adaptive, box bounds off, as ``tests/test_cones.py``'s export test):
    the artifact gives the live coned solve's bits and counts."""
    from accelerated_tinympc_tpu_torch.solver.cones import cone_slack_update

    *_, problem, cache, cones = lander_pair(15)
    settings = atm_t.Settings(max_iter=120, check_termination=2,
                              en_input_bound=False, en_state_bound=False)
    f = tmp_path / "coned.pt2"
    save_exported(f, export_batched_solve(problem, cache, settings, batch=3,
                                          cones=cones))
    x0s = torch.as_tensor(perturbed_x0([3.0, -2.0, 4.0, -1.0, 1.0, -1.5], 3,
                                       seed=4, spread=0.3),
                          dtype=torch.float32)
    out = load_exported(f)(x0s)
    st = init_state_batched(3, 6, 3, 15, device=DEV)
    x = st.x.clone()
    x[:, 0, :] = x0s
    live = solve_batched(st.replace(x=x), problem, cache, settings,
                         project=cone_slack_update(cones))
    _assert_equals_live(out, live)
    assert to_np(live.iter).tolist() == [56, 44, 64]
    assert (live.status == atm_t.SOLVED).all()


@pytest.mark.parametrize("check", [0, 1], ids=["fixed", "adaptive"])
def test_fused_artifact_runs_the_custom_op(tmp_path, check):
    """export_fused_solve traces the atm_torch::fused_solve op (its fake
    gives the shapes); on the CPU the loaded artifact runs the op's plain
    version and equals fused_solve_plain (and fused_solve) bit for bit."""
    problem, cache, x0 = atm_t.models.quadrotor_hovering_setup(device=DEV)
    ops = atm_t.condensed_operators(cache, problem.A, problem.B,
                                    problem.horizon, device=DEV)
    pp = pad_problem(problem, cache, ops, device=DEV)
    kw = dict(max_iter=30, check_termination=check)
    ep = export_fused_solve(pp, 4, **kw)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert any("atm_torch.fused_solve" in t for t in targets), targets
    f = tmp_path / "fused.pt2"
    save_exported(f, ep)
    x0s = torch.as_tensor(perturbed_x0(x0, 4, seed=2, spread=0.05),
                          dtype=torch.float32)
    carry = FusedCarry.zeros(4, pp, device=DEV)
    out = load_exported(f)(x0s, *carry)
    for want in (fused_solve_plain(x0s, carry, pp, **kw),
                 fused_solve(x0s, carry, pp, **kw)):
        got = dict(U=want.U, X=want.X, stats=want.stats,
                   **want.carry._asdict())
        assert set(out) == set(got)
        for k, v in got.items():
            assert torch.equal(out[k], v), k


@pytest.mark.parametrize("fault", ["device", "dtype", "shape"])
def test_the_shared_launch_checks_the_baked_operands(fault):
    """``fused_solve`` and the op's CUDA kernel launch through one function,
    which checks ``W_f``/``W_b``/``W_x``/``lo``/``hi`` against ``dims`` and
    the inputs' device before it sizes the launch: an artifact exported on
    one device and called with tensors on another raises, and no operand
    reaches the kernel at a wrong type or size."""
    from accelerated_tinympc_tpu_torch.ops import fused_admm

    problem, cache, x0 = atm_t.models.quadrotor_hovering_setup(device=DEV)
    ops = atm_t.condensed_operators(cache, problem.A, problem.B,
                                    problem.horizon, device=DEV)
    pp = pad_problem(problem, cache, ops, device=DEV)
    W_f = {"device": pp.W_f.to("meta"), "dtype": pp.W_f.double(),
           "shape": pp.W_f[:, :-4]}[fault]
    err = TypeError if fault == "dtype" else ValueError
    with pytest.raises(err, match="W_f"):
        fused_admm._launch_solve(
            torch.zeros((4, 12)), FusedCarry.zeros(4, pp, device=DEV), W_f,
            pp.W_b, pp.W_x, fused_admm.fold_const_d(pp), pp.lo, pp.hi,
            pp.dims, pp.rho_f, max_iter=1, check_termination=0,
            warmup_iters=0, abs_pri_tol=1e-3, abs_dua_tol=1e-3, alpha=1.0,
            batch_tile=None, threads=None, placement=None, register_tile=None)
