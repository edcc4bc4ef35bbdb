"""PyTorch port, the long-horizon tensor tiers and entry points against the
JAX package on the CPU: ``solver/assoc_scan.py`` (``solve_assoc``),
``solver/block_condensed.py`` (``solve_block``, ``solve_block_batched``),
``TinyMPC(tier="block")`` (solve and rollout), and ``TinyMPCFleet`` on
``tier="block"`` and ``tier="hstream"`` (held against the JAX fleet's scan
tier: no JAX hstream kernel runs here). Plus the port's
``examples/torch_long_horizon.py`` at a small size.

Bars: float64 at 1e-9 with equal iteration counts; float32 at 1e-4
relative to each field's largest entry."""

import contextlib
import io
import pathlib
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
from accelerated_tinympc_tpu.models import random_lti_problem
from accelerated_tinympc_tpu.precompute import riccati_cache as riccati_j
from accelerated_tinympc_tpu.solver.assoc_scan import solve_assoc as assoc_j
from accelerated_tinympc_tpu.solver.block_condensed import (
    solve_block as block_j, solve_block_batched as block_batched_j,
)
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu_torch.solver.assoc_scan import solve_assoc
from accelerated_tinympc_tpu_torch.solver.block_condensed import (
    solve_block, solve_block_batched,
)

from torch_parity_utils import (
    DEV, assert_fields_close, cache_to_torch, problem_to_torch,
    settings_to_torch, state_to_torch, to_np,
)

NX, NU, N = 5, 2, 24
BLOCK = 5            # N-1 = 23 = 4 blocks of 5 + a tail of 3
ROOT = pathlib.Path(__file__).resolve().parents[1]
STATE_FIELDS = ("x", "u", "d", "y", "g", "z", "v", "p",
                "primal_residual_state", "dual_residual_state",
                "primal_residual_input", "dual_residual_input")


@pytest.fixture(scope="module")
def f64_single():
    """One instance in float64: the JAX assoc and block tiers, adaptive
    (the loop's freeze and every stage), computed once."""
    out = {}
    with jax.enable_x64(True):
        p, rho = random_lti_problem(seed=0, nx=NX, nu=NU, horizon=N)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p)
        c = riccati_j(np.asarray(p.A), np.asarray(p.B), np.asarray(p.Q),
                      np.asarray(p.R), rho, dtype=np.float64)
        x0 = np.random.default_rng(0).standard_normal(NX) * 0.8
        st = atm_j.init_state(NX, NU, N, jnp.float64)
        st = st.replace(x=st.x.at[0].set(jnp.asarray(x0)))
        for mode, s in (("adaptive", atm_j.Settings(max_iter=80,
                                                    check_termination=3)),):
            out[mode, "assoc"] = jax.tree.map(np.asarray, jax.jit(
                lambda q, s=s: assoc_j(q, p, c, s))(st))
            out[mode, "block"] = jax.tree.map(np.asarray, jax.jit(
                lambda q, s=s: block_j(q, p, c, s, block=BLOCK))(st))
            out[mode, "settings"] = s
        out["parts"] = (problem_to_torch(p, torch.float64),
                        cache_to_torch(c, torch.float64),
                        state_to_torch(st, torch.float64))
    return out


@pytest.mark.parametrize("mode", ["adaptive"])
@pytest.mark.parametrize("tier", ["assoc", "block"])
def test_single_instance_f64_exact(f64_single, tier, mode):
    """``solve_assoc`` and ``solve_block`` (with a tail block) against the
    JAX functions: every state field to 1e-9, equal counts and status."""
    pt, ct, stt = f64_single["parts"]
    s = settings_to_torch(f64_single[mode, "settings"])
    got = (solve_assoc(stt, pt, ct, s) if tier == "assoc"
           else solve_block(stt, pt, ct, s, block=BLOCK))
    want = f64_single[mode, tier]
    assert int(got.iter) == int(want.iter) and int(got.status) == int(
        want.status)
    assert_fields_close(got, want, atol=1e-9, scaled=True,
                        names=STATE_FIELDS)
    if mode == "adaptive":
        assert int(want.iter) < 80


def test_block_batched_per_instance_f64():
    """``solve_block_batched`` (per-instance operators built on the device)
    against the JAX function with per-instance plants, float64, adaptive."""
    Bn, n = 3, 12
    with jax.enable_x64(True):
        parts = [random_lti_problem(seed=s, nx=NX, nu=NU, horizon=n)
                 for s in range(Bn)]
        pj = jax.tree.map(lambda *a: jnp.stack([jnp.asarray(x, jnp.float64)
                                                for x in a]),
                          *[p for p, _ in parts])
        cjs = [riccati_j(np.asarray(p.A), np.asarray(p.B), np.asarray(p.Q),
                         np.asarray(p.R), 1.0 + k, dtype=np.float64)
               for k, (p, _) in enumerate(parts)]
        cj = jax.tree.map(lambda *a: jnp.stack([jnp.asarray(x) for x in a]),
                          *cjs)
        s = atm_j.Settings(max_iter=60, check_termination=2)
        from accelerated_tinympc_tpu.solver.batched import init_state_batched

        st = init_state_batched(Bn, NX, NU, n, jnp.float64)
        x0 = np.random.default_rng(2).standard_normal((Bn, NX)) * 0.8
        st = st.replace(x=st.x.at[:, 0].set(jnp.asarray(x0)))
        want = jax.tree.map(np.asarray, jax.jit(
            lambda q: block_batched_j(q, pj, cj, s, block=4))(st))
        pt = problem_to_torch(pj, torch.float64)
        ct = cache_to_torch(cj, torch.float64)
        stt = state_to_torch(st, torch.float64)
    got = solve_block_batched(stt, pt, ct, settings_to_torch(s), block=4)
    np.testing.assert_array_equal(to_np(got.iter), want.iter)
    assert_fields_close(got, want, atol=1e-9, scaled=True,
                        names=STATE_FIELDS)


def _tinympc_pair(batch, **kw):
    pj, rho = random_lti_problem(seed=3, nx=NX, nu=NU, horizon=N)
    cj = riccati_j(np.asarray(pj.A), np.asarray(pj.B), np.asarray(pj.Q),
                   np.asarray(pj.R), rho)
    sets = dict(max_iter=25, check_termination=0)
    mj = atm_j.TinyMPC.from_parts(pj, cj, settings=atm_j.Settings(**sets),
                                  batch=batch, tier="block", block=BLOCK,
                                  **kw)
    mt = atm_t.TinyMPC.from_parts(
        problem_to_torch(pj), cache_to_torch(cj),
        settings=atm_t.Settings(**sets), batch=batch, tier="block",
        block=BLOCK, device=DEV, **kw)
    x0 = np.random.default_rng(4).standard_normal(
        (NX,) if batch is None else (batch, NX)).astype(np.float32) * 0.8
    mj.set_x0(x0)
    mt.set_x0(x0)
    return mj, mt


@pytest.mark.parametrize("batch", [3], ids=["batch3"])
def test_tinympc_block_tier_matches_jax(batch):
    """``TinyMPC(tier="block")``: solve() and a 3-tick rollout (warm
    continuation) against the JAX object, float32 at 1e-4."""
    mj, mt = _tinympc_pair(batch)
    sj, st = mj.solve(), mt.solve()
    assert set(st) == set(sj)
    np.testing.assert_allclose(mt.get_u(), mj.get_u(), atol=1e-4)
    np.testing.assert_allclose(mt.get_x(), mj.get_x(), atol=2e-4)
    xf_j, us_j = mj.rollout(3)
    xf_t, us_t = mt.rollout(3)
    np.testing.assert_allclose(to_np(us_t), np.asarray(us_j), atol=1e-4)
    np.testing.assert_allclose(to_np(xf_t), np.asarray(xf_j), atol=1e-4)


def _plants(Bn=5, n=16):
    As, Bs, Qs, Rs = [], [], [], []
    for seed in range(Bn):
        p, _ = random_lti_problem(seed=seed, nx=NX, nu=NU, horizon=n)
        As.append(np.asarray(p.A))
        Bs.append(np.asarray(p.B))
        Qs.append(np.asarray(p.Q))
        Rs.append(np.asarray(p.R))
    x0s = (0.8 * np.random.default_rng(1).standard_normal((Bn, NX))).astype(
        np.float32)
    return np.stack(As), np.stack(Bs), np.stack(Qs), np.stack(Rs), x0s, n


FLEET_SETS = dict(max_iter=80, check_termination=2, abs_pri_tol=5e-3,
                  abs_dua_tol=5e-3)
FLEET_KW = dict(rho=1.0, u_min=-0.5, u_max=0.5, host_precompute=True)


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX fleet's scan tier (which the JAX package holds its hstream
    and block tiers to): controls, counts and flags of a cold adaptive solve
    and of a warm one after a dual reset, computed once."""
    A, Bm, Q, R, x0s, n = _plants()
    fj = atm_j.TinyMPCFleet.setup(A, Bm, Q, R, horizon=n, tier="scan",
                                  settings=atm_j.Settings(**FLEET_SETS),
                                  **FLEET_KW)
    out = []
    for _ in range(2):
        fj.set_x0(x0s)
        info = fj.solve()
        out.append((info["iterations"], info["solved"], to_np(fj.get_u())))
        fj.reset_duals()
    return out


@pytest.mark.parametrize("tier", ["block", "hstream"])
def test_fleet_long_horizon_tiers_match_jax(jax_fleet, tier):
    """``TinyMPCFleet`` on the block and hstream tiers against the JAX
    fleet's scan tier: adaptive solves with equal counts and flags, controls
    at 1e-4, cold and then warm after a dual reset; the hstream tier also
    through its compaction cascade, which equals its one-call solve."""
    A, Bm, Q, R, x0s, n = _plants()
    mk = lambda **kw: atm_t.TinyMPCFleet.setup(
        A, Bm, Q, R, horizon=n, settings=atm_t.Settings(**FLEET_SETS),
        tier=tier, block=5, device=DEV, **FLEET_KW, **kw)
    ft = mk()
    for iters, solved, u in jax_fleet:  # cold, then warm after a dual reset
        ft.set_x0(x0s)
        it = ft.solve()
        np.testing.assert_array_equal(it["iterations"], iters)
        np.testing.assert_array_equal(it["solved"], solved)
        np.testing.assert_allclose(to_np(ft.get_u()), u, atol=1e-4)
        ft.reset_duals()
    if tier == "hstream":
        ft2 = mk(compaction_segment=3)
        ft2.set_x0(x0s)
        ft.set_x0(x0s)
        ft._carry = ft2._carry
        assert np.array_equal(ft2.solve()["iterations"],
                              ft.solve()["iterations"])
        assert torch.equal(ft2.get_u(), ft.get_u())


def test_fleet_hstream_per_instance_cones_reach_the_cascade():
    """The fleet's per-instance cone geometry is honoured on the hstream
    tier with and without compaction (the JAX fleet drops it there:
    ROADMAP.md section 3), and binds (static cones give other controls)."""
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    A, Bm, Q, R, x0s, n = _plants()
    Bn = A.shape[0]
    sets = atm_t.Settings(max_iter=80, check_termination=2, abs_pri_tol=5e-3,
                          abs_dua_tol=5e-3)
    cones = ConeSet(input_cones=(Cone((0,), 1, 0.8, 0.5),))
    kw = dict(rho=1.0, horizon=n, u_min=-0.5, u_max=0.5,
              host_precompute=True, settings=sets, tier="hstream",
              cones=cones, device=DEV)
    mu = np.linspace(0.3, 1.2, Bn)[None]
    us = {}
    for name, extra in (("plain", dict(cone_mu=mu)),
                        ("cascade", dict(cone_mu=mu, compaction_segment=4)),
                        ("static", {})):
        f = atm_t.TinyMPCFleet.setup(A, Bm, Q, R, **kw, **extra)
        f.set_x0(x0s)
        f.solve()
        us[name] = f.get_u()
    assert torch.equal(us["plain"], us["cascade"])
    assert float((us["plain"] - us["static"]).abs().max()) > 1e-3


def test_public_names_match_jax_package():
    """The long-horizon names exist in both packages."""
    for name in ("StreamCarry", "StreamProblem", "StreamResult",
                 "pad_stream_problem", "stream_solve", "HStreamProblem",
                 "gather_hstream", "hstream_carry_zeros", "hstream_solve",
                 "pad_hstream_from_plants", "pad_hstream_problem"):
        assert hasattr(atm_j.ops, name) and hasattr(atm_t.ops, name), name
    for name in ("solve_assoc", "block_ops_batched", "block_sweeps",
                 "solve_block", "solve_block_batched", "stream_cascade_solve",
                 "hstream_cascade_solve"):
        assert hasattr(atm_j.solver, name) and hasattr(atm_t.solver, name), \
            name
    assert "block" in atm_t.api.solver.TIERS


def test_torch_long_horizon_example_runs():
    """``examples/torch_long_horizon.py --cpu`` at a short horizon runs and
    prints its verdict."""
    argv = sys.argv
    out = io.StringIO()
    try:
        sys.argv = ["torch_long_horizon.py", "--cpu", "--horizon", "32",
                    "--batch", "6", "--iters", "20"]
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(ROOT / "examples" / "torch_long_horizon.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    lines = out.getvalue().splitlines()
    assert lines[-1] == "LONG HORIZON OK", lines
