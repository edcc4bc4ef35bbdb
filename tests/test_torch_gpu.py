"""PyTorch port: the CUDA kernels against their plain versions. These tests
need an NVIDIA GPU and ``nvcc``; without a card they skip. Run them on the
card with ``python -m pytest tests/test_torch_gpu.py -m gpu``
(``chip_smoke.py`` makes the same comparisons at full width)."""

import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.ops import (
    FusedCarry, fused_rollout, fused_rollout_plain, fused_solve,
    fused_solve_plain, pad_problem, rollout_ops,
)
from accelerated_tinympc_tpu_torch.ops import fused_admm

pytestmark = pytest.mark.gpu
ATOL = 1e-4  # kernel vs plain: same arithmetic, sums in another order


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    ops = atm.condensed_operators(cache, problem.A, problem.B, problem.horizon)
    pp = pad_problem(problem, cache, ops)
    rng = np.random.default_rng(0)
    B = 133  # ragged for every tile
    x0s = torch.as_tensor(x0[None] + 0.05 * rng.standard_normal((B, 12)),
                          dtype=torch.float32, device="cuda")
    return problem, pp, x0s, FusedCarry.zeros(B, pp)


def test_fixed_kernel_matches_plain(card):
    _problem, pp, x0s, cold = card
    before = fused_admm.LAUNCH_COUNTS["fused_solve_fixed"]
    got = fused_solve(x0s, cold, pp, max_iter=50)
    want = fused_solve_plain(x0s, cold, pp, max_iter=50)
    assert fused_admm.LAUNCH_COUNTS["fused_solve_fixed"] == before + 1
    assert float((got.U - want.U).abs().max()) <= ATOL
    assert float((got.carry.D - want.carry.D).abs().max()) <= ATOL


def test_adaptive_kernel_matches_plain(card):
    _problem, pp, x0s, cold = card
    kw = dict(max_iter=200, check_termination=1, abs_pri_tol=0.05,
              abs_dua_tol=0.05)
    got = fused_solve(x0s, cold, pp, **kw)
    want = fused_solve_plain(x0s, cold, pp, **kw)
    same = got.stats[:, 0] == want.stats[:, 0]
    assert float(same.float().mean()) >= 0.99
    assert float((got.U - want.U)[same].abs().max()) <= ATOL


def test_rollout_kernel_matches_plain(card):
    problem, pp, x0s, cold = card
    rops = rollout_ops(problem, pp)
    got = fused_rollout(x0s, cold, pp, rops, 10, max_iter=30)
    want = fused_rollout_plain(x0s, cold, pp, rops, 10, max_iter=30)
    assert float((got.us - want.us).abs().max()) <= ATOL
    assert float((got.x_final - want.x_final).abs().max()) <= ATOL


def test_float64_on_the_card_raises(card):
    _problem, pp, x0s, cold = card
    with pytest.raises(TypeError, match="float32"):
        fused_solve(x0s.double(), cold, pp, max_iter=5)


# ------------------------------------------- cones in the fused kernels ----

def _lander(horizon=15, batch=133):
    """The powered-descent lander of examples/soc_landing.py (nx=6, nu=3:
    neither Dx nor a knot is a multiple of the kernels' float4 grid)."""
    from accelerated_tinympc_tpu_torch.ops import pad_cones
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    I3 = np.eye(3)
    A = np.block([[I3, 0.1 * I3], [0 * I3, I3]])
    Bm = np.vstack([0.005 * I3, 0.1 * I3])
    Q = np.concatenate([np.full(3, 10.0), np.full(3, 1.0)])
    R = np.full(3, 1.0)
    mpc = atm.TinyMPC.setup(A, Bm, Q, R, 1.0, horizon, u_min=-10.0,
                            u_max=10.0, x_min=-100.0, x_max=100.0)
    ops = atm.condensed_operators(mpc.cache, mpc.problem.A, mpc.problem.B,
                                  horizon)
    pp = pad_problem(mpc.problem, mpc.cache, ops)
    cones = ConeSet(input_cones=(Cone((0, 1), 2, 1.0, 3.0),),
                    state_cones=(Cone((0, 1), 2, 2.0, 0.1),))
    rng = np.random.default_rng(0)
    base = np.asarray([3.0, -2.0, 6.0, 1.0, 0.5, -1.0])
    x0s = torch.as_tensor(base[None] + 0.3 * rng.standard_normal((batch, 6)),
                          dtype=torch.float32, device="cuda")
    return mpc.problem, pp, pad_cones(pp, cones), cones, x0s


@pytest.fixture(scope="module")
def lander(card):
    return _lander()


def _assert_solve_close(got, want, min_agree=0.99):
    same = got.stats[:, 0] == want.stats[:, 0]
    assert float(same.float().mean()) >= min_agree
    assert float((got.U - want.U)[same].abs().max()) <= ATOL
    for k in ("D", "Z"):
        err = (getattr(got.carry, k) - getattr(want.carry, k))[same]
        assert float(err.abs().max()) <= ATOL, k
    for k in ("Y", "G", "V"):
        err = (getattr(got.carry, k) - getattr(want.carry, k))[same]
        assert float(err.abs().max()) <= 2 * ATOL, k


def test_lander_shape_box_only_matches_plain(lander):
    _problem, pp, _cops, _cones, x0s = lander
    cold = FusedCarry.zeros(x0s.shape[0], pp)
    for kw in (dict(max_iter=60), dict(max_iter=100, check_termination=2,
                                       abs_pri_tol=3e-2, abs_dua_tol=3e-2)):
        _assert_solve_close(fused_solve(x0s, cold, pp, **kw),
                            fused_solve_plain(x0s, cold, pp, **kw))


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("per_instance", [False, True])
def test_coned_kernel_matches_plain(lander, mode, per_instance):
    from accelerated_tinympc_tpu_torch.solver.cones import cone_violation

    _problem, pp, cops, cones, x0s = lander
    B = x0s.shape[0]
    cold = FusedCarry.zeros(B, pp)
    kw = dict(max_iter=60, cone_ops=cops)
    if mode == "adaptive":
        kw.update(max_iter=150, check_termination=2, abs_pri_tol=3e-2,
                  abs_dua_tol=3e-2)
    if per_instance:
        lin = lambda a, b: torch.linspace(a, b, B, device="cuda")[None]
        kw.update(cone_mu_u=lin(0.6, 1.4), cone_shift_x=lin(0.05, 0.2))
    name = "fused_solve_%s_cones" % mode
    before = fused_admm.LAUNCH_COUNTS[name]
    got = fused_solve(x0s, cold, pp, **kw)
    assert fused_admm.LAUNCH_COUNTS[name] == before + 1
    _assert_solve_close(got, fused_solve_plain(x0s, cold, pp, **kw))
    if not per_instance:
        Z = got.carry.Z.reshape(B, -1, 3)
        V = got.carry.V.reshape(B, -1, 6)
        assert float(cone_violation(Z, cones.input_cones[0])) <= 1e-5
        assert float(cone_violation(V, cones.state_cones[0])) <= 1e-5


def test_per_instance_rows_equal_to_static_change_nothing(lander):
    _problem, pp, cops, _cones, x0s = lander
    B = x0s.shape[0]
    cold = FusedCarry.zeros(B, pp)
    kw = dict(max_iter=40, check_termination=2, cone_ops=cops)
    a = fused_solve(x0s, cold, pp, **kw)
    b = fused_solve(x0s, cold, pp, cone_mu_u=torch.full((1, B), 1.0),
                    **kw)
    assert torch.equal(a.carry.Z, b.carry.Z) and torch.equal(a.stats, b.stats)


def test_coned_rollout_kernel_matches_plain(lander):
    problem, pp, cops, _cones, x0s = lander
    cold = FusedCarry.zeros(x0s.shape[0], pp)
    rops = rollout_ops(problem, pp)
    kw = dict(max_iter=40, cone_ops=cops)
    got = fused_rollout(x0s, cold, pp, rops, 8, **kw)
    want = fused_rollout_plain(x0s, cold, pp, rops, 8, **kw)
    assert float((got.us - want.us).abs().max()) <= ATOL
    assert float((got.x_final - want.x_final).abs().max()) <= ATOL


# ------------------------------------------------------ Riccati kernels ----

def _plants(batch, nx, nu, seed=0):
    """Random plants scaled to spectral radius 0.95 (open-loop stable, so
    K0 = 0 stabilises them), random positive cost diagonals and rho."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, nx, nx))
    A *= (0.95 / np.abs(np.linalg.eigvals(A)).max(axis=1))[:, None, None]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    return (t(A), t(rng.standard_normal((batch, nx, nu))),
            t(rng.uniform(0.5, 5.0, (batch, nx))),
            t(rng.uniform(0.5, 5.0, (batch, nu))),
            t(rng.uniform(0.5, 5.0, batch)))


def _ric_tol(cache, field, rows=slice(None)):
    """1e-4 relative to the field's largest entry; coeff_d2p = K'R1 - AmBKt P B
    vanishes at the fixed point, so its rounding is that of its two terms,
    which are of the size of Pinf's entries."""
    ref = cache.Pinf if field == "coeff_d2p" else getattr(cache, field)
    return 1e-4 * max(1.0, float(ref[rows].abs().max()))


@pytest.mark.parametrize("dims", [(12, 4), (6, 8), (16, 8), (1, 1)])
def test_riccati_fixed_point_kernel_matches_plain(card, dims):
    from accelerated_tinympc_tpu_torch.ops import riccati_kernel as rk

    plants = _plants(67, *dims)
    from accelerated_tinympc_tpu_torch.precompute import riccati_fixed_point

    before = rk.LAUNCH_COUNTS["riccati_fixed_point"]
    got, it_g = rk.riccati_fixed_point_kernel(*plants)
    assert rk.LAUNCH_COUNTS["riccati_fixed_point"] == before + 1
    want, it_w = riccati_fixed_point(*plants, max_iters=1000, tol=1e-5)
    assert float((it_g - it_w).abs().float().max()) <= 1
    for k, v in want.tensors().items():
        assert float((getattr(got, k) - v).abs().max()) <= _ric_tol(want, k), k
    warm, it_warm = rk.riccati_fixed_point_kernel(*plants, P0=got.Pinf,
                                                  K0=got.Kinf)
    assert int(it_warm.max()) <= 2
    assert float((warm.Kinf - got.Kinf).abs().max()) <= 1e-4


def test_riccati_newton_kernel_matches_plain_and_flags_bad_gain(card):
    from accelerated_tinympc_tpu_torch.ops import riccati_kernel as rk

    A, B, Q, R, rho = _plants(67, 12, 4, seed=1)
    K0 = rk.riccati_cache_kernel(A, B, Q, R, rho).Kinf.clone()
    rho2 = rho * 7.0
    K0[5] = -50.0 * K0[5] + 3.0          # does not stabilise plant 5
    got = rk.riccati_cache_newton(A, B, Q, R, rho2, K0)
    want = rk.riccati_cache_newton_plain(A, B, Q, R, rho2, K0)
    truth = rk.riccati_cache_kernel_plain(A, B, Q, R, rho2, tol=1e-7)
    ok = torch.ones(67, dtype=torch.bool, device="cuda")
    ok[5] = False
    assert not bool(torch.isfinite(got.Kinf[5]).all())
    for k, v in want.tensors().items():
        g = getattr(got, k)
        assert bool(torch.isfinite(g[ok]).all()), k
        assert float((g - v)[ok].abs().max()) <= _ric_tol(want, k, ok), k
    assert float((got.Kinf - truth.Kinf)[ok].abs().max()) <= 1e-3


def test_riccati_kernel_refuses_large_sizes(card):
    from accelerated_tinympc_tpu_torch.ops import riccati_kernel as rk

    A, B, Q, R, rho = _plants(3, 4, 2)
    big = torch.zeros((3, 17, 17), device="cuda")
    with pytest.raises(ValueError, match="nx <= 16"):
        rk.riccati_cache_kernel(big, torch.zeros((3, 17, 2), device="cuda"),
                                torch.ones((3, 17), device="cuda"), R, rho)


def test_auto_riccati_on_the_card_is_the_kernel_and_refuses_large_sizes(card):
    """``riccati="auto"`` on CUDA tensors launches the kernel; above the
    kernels' sizes it raises and does not take the batched tensor code."""
    from accelerated_tinympc_tpu_torch.ops import riccati_kernel as rk
    from accelerated_tinympc_tpu_torch.solver.batched_ops import (
        build_instance_ops_from_plants,
    )

    def bounds(A, B, Q, R, N=4):
        batch, nx, nu = B.shape
        full = lambda v, *s: torch.full((batch,) + s, v, device="cuda")
        return atm.Problem(
            A=A, B=B, Q=Q, R=R,
            u_min=full(-1.0, N - 1, nu), u_max=full(1.0, N - 1, nu),
            x_min=full(-9.0, N, nx), x_max=full(9.0, N, nx),
            Xref=full(0.0, N, nx), Uref=full(0.0, N - 1, nu))

    A, B, Q, R, rho = _plants(5, 4, 2)
    before = rk.LAUNCH_COUNTS["riccati_fixed_point"]
    ops, caches = build_instance_ops_from_plants(
        A, B, Q, R, rho, bounds(A, B, Q, R))
    assert rk.LAUNCH_COUNTS["riccati_fixed_point"] == before + 1
    want = rk.riccati_cache_kernel_plain(A, B, Q, R, rho)
    assert float((caches.Kinf - want.Kinf).abs().max()) <= ATOL
    assert bool(torch.isfinite(ops.W_q).all())
    A, B, Q, R, rho = _plants(3, 17, 2)
    with pytest.raises(ValueError, match="riccati='vmap'"):
        build_instance_ops_from_plants(A, B, Q, R, rho, bounds(A, B, Q, R))
    ops, _ = build_instance_ops_from_plants(
        A, B, Q, R, rho, bounds(A, B, Q, R), riccati="vmap")
    assert bool(torch.isfinite(ops.W_q).all())


# ------------------------------------------------ heterogeneous plants ----

def _fleet(batch, nx, nu, horizon, seed=0):
    """Random per-instance plants (spectral radius 0.95), caches by the
    fixed-point kernel, per-knot bounds, a small reference."""
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha

    A, Bm, Q, R, rho = _plants(batch, nx, nu, seed)
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    lim = t(0.5 + rng.random((batch, horizon - 1, nu)))
    prob = atm.Problem(
        A=A, B=Bm, Q=Q, R=R, u_min=-lim, u_max=lim,
        x_min=t(np.full((batch, horizon, nx), -5.0)),
        x_max=t(np.full((batch, horizon, nx), 5.0)),
        Xref=t(0.1 * rng.standard_normal((batch, horizon, nx))),
        Uref=t(np.zeros((batch, horizon - 1, nu))))
    hp, _ = ha.pad_hetero_from_plants(A, Bm, Q, R, rho, prob)
    x0 = t(rng.standard_normal((batch, nx)))
    return hp, x0


def _assert_hetero_close(got, want, min_agree=0.99):
    same = got.stats[:, 0] == want.stats[:, 0]
    assert float(same.float().mean()) >= min_agree
    assert torch.equal(got.stats[same, 1], want.stats[same, 1])
    assert float((got.U - want.U)[same].abs().max()) <= ATOL
    for k in ("d", "z"):
        err = (getattr(got.carry, k) - getattr(want.carry, k))[same]
        assert float(err.abs().max()) <= ATOL, k
    for k in ("y", "g", "v"):
        err = (getattr(got.carry, k) - getattr(want.carry, k))[same]
        assert float(err.abs().max()) <= 2 * ATOL, k
    assert float((got.X - want.X)[same].abs().max()) <= 2 * ATOL


@pytest.mark.parametrize("dims", [(12, 4, 10), (8, 3, 10), (5, 2, 7),
                                  (20, 6, 5), (1, 1, 3)])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_hetero_kernels_match_plain(card, dims, mode):
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha

    hp, x0 = _fleet(133, *dims)
    kw = dict(max_iter=60)
    if mode == "adaptive":
        kw.update(check_termination=2, abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    name = "hetero_solve_" + mode
    before = ha.LAUNCH_COUNTS[name]
    cold = ha.HeteroCarry.zeros(hp)
    got = ha.hetero_solve(x0, cold, hp, **kw)
    assert ha.LAUNCH_COUNTS[name] == before + 1
    _assert_hetero_close(got, ha.hetero_solve_plain(x0, cold, hp, **kw))


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_hetero_kernels_with_per_instance_cones(card, mode):
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    B = 133
    hp, x0 = _fleet(B, 8, 3, 10, seed=4)
    cones = ConeSet(input_cones=(Cone((0, 1), 2, 1.0, 2.0),),
                    state_cones=(Cone((0, 1), 2, 2.0, 1.0),))
    ball = np.zeros((B, 3), np.float32)
    ball[: B // 2, [0, 1]] = 1.0
    ball[B // 2:, [1, 2]] = 1.0
    axis = np.where(np.arange(B) < B // 2, 2, 0)
    cp = ha.pad_hetero_cone_params(
        cones, B, mu_u=np.linspace(0.6, 1.4, B)[None], device="cuda")
    cm = ha.pad_hetero_cone_masks(cones, B, 8, 3, ball_u=[ball],
                                  axis_u=[axis], device="cuda")
    kw = dict(max_iter=80, cones=cones, cone_params=cp, cone_masks=cm)
    if mode == "adaptive":
        kw.update(check_termination=1, abs_pri_tol=1e-2, abs_dua_tol=1e-2)
    cold = ha.HeteroCarry.zeros(hp)
    _assert_hetero_close(ha.hetero_solve(x0, cold, hp, **kw),
                         ha.hetero_solve_plain(x0, cold, hp, **kw))


def test_hetero_cascade_is_bit_exact_on_the_card(card):
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
    from accelerated_tinympc_tpu_torch.solver.cascade import (
        hetero_cascade_solve,
    )

    hp, x0 = _fleet(1000, 12, 4, 10, seed=2)
    cold = ha.HeteroCarry.zeros(hp)
    kw = dict(check_termination=1, abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    one = ha.hetero_solve(x0, cold, hp, max_iter=100, **kw)
    U, X, stats, carry = hetero_cascade_solve(
        x0, cold, hp, max_iter=100, segment_iters=10, **kw)
    assert torch.equal(U, one.U) and torch.equal(stats, one.stats)
    assert all(torch.equal(a, b) for a, b in zip(carry, one.carry))


def test_hetero_kernel_refuses_large_sizes(card):
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha

    hp, x0 = _fleet(4, 3, 2, 5)
    big = hp.replace(dims=(33, 2, 5))
    with pytest.raises(ValueError, match="instance_ops"):
        ha.hetero_solve(x0, ha.HeteroCarry.zeros(hp), big)


# ------------------------------------------------------ long horizons ----

def _stream_parts(batch, nx, nu, horizon, seed=0, knot=False):
    """One random plant for the stream tier and a fleet of random plants for
    the hstream tier, with box bounds (per-knot schedules with ``knot``)
    and a small reference; x0 of three scales, so adaptive counts spread."""
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    A, Bm, Q, R, rho = _plants(batch, nx, nu, seed)
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    lim = np.full((batch, horizon - 1, nu), 0.8)
    if knot:
        lim = lim * np.linspace(1.5, 0.5, horizon - 1)[None, :, None]
    prob = atm.Problem(
        A=A, B=Bm, Q=Q, R=R, u_min=t(-lim), u_max=t(lim),
        x_min=t(np.full((batch, horizon, nx), -5.0)),
        x_max=t(np.full((batch, horizon, nx), 5.0)),
        Xref=t(0.1 * rng.standard_normal((batch, horizon, nx))),
        Uref=t(np.zeros((batch, horizon - 1, nu))))
    hsp, caches = hs.pad_hstream_from_plants(A, Bm, Q, R, rho, prob)
    one = atm.Problem(**{k: v[0] for k, v in prob.tensors().items()})
    sp = sa.pad_stream_problem(one, atm.Cache(**{
        k: v[0] for k, v in caches.tensors().items()}))
    scale = np.repeat([0.05, 0.5, 2.0], -(-batch // 3))[:batch, None]
    x0 = t(scale * rng.standard_normal((batch, nx)))
    return sp, hsp, x0


def _assert_stream_close(got, want, min_agree=0.98):
    same = got.stats[:, 0] == want.stats[:, 0]
    assert float(same.float().mean()) >= min_agree
    assert torch.equal(got.stats[same, 1], want.stats[same, 1])
    for k in ("U", "X"):
        err = (getattr(got, k) - getattr(want, k))[same].abs().max()
        assert float(err) <= 2 * ATOL, k
    for k in ("d", "y", "g", "z", "v"):
        err = (getattr(got.carry, k) - getattr(want.carry, k))[same]
        assert float(err.abs().max()) <= 2 * ATOL, k


@pytest.mark.parametrize("dims", [(8, 3, 64), (6, 3, 256), (12, 4, 33),
                                  (1, 1, 5)])
@pytest.mark.parametrize("tier", ["stream", "hstream"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_stream_kernels_match_plain(card, dims, tier, mode):
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    sp, hsp, x0 = _stream_parts(133, *dims, knot=dims[2] == 33)
    kw = dict(max_iter=40)
    if mode == "adaptive":
        kw.update(check_termination=5, abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    solve, plain, ops = ((sa.stream_solve, sa.stream_solve_plain, sp)
                         if tier == "stream" else
                         (hs.hstream_solve, hs.hstream_solve_plain, hsp))
    name = f"{tier}_solve_{mode}"
    before = sa.LAUNCH_COUNTS[name]
    cold = sa.StreamCarry.zeros(133, ops)
    got = solve(x0, cold, ops, **kw)
    assert sa.LAUNCH_COUNTS[name] == before + 1
    _assert_stream_close(got, plain(x0, cold, ops, **kw))
    if mode == "adaptive":  # knot_block changes no bit
        again = solve(x0, cold, ops, knot_block=7, **kw)
        assert torch.equal(again.U, got.U) and torch.equal(again.stats,
                                                           got.stats)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_stream_kernels_with_cones(card, mode):
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    B = 133
    sp, hsp, x0 = _stream_parts(B, 6, 3, 64, seed=4)
    cones = ConeSet(input_cones=(Cone((0, 1), 2, 1.0, 2.0),),
                    state_cones=(Cone((0, 1), 2, 2.0, 1.0),))
    ball = np.zeros((B, 3), np.float32)
    ball[: B // 2, [0, 1]] = 1.0
    ball[B // 2:, [1, 2]] = 1.0
    axis = np.where(np.arange(B) < B // 2, 2, 0)
    cp = ha.pad_hetero_cone_params(
        cones, B, mu_u=np.linspace(0.6, 1.4, B)[None], device="cuda")
    cm = ha.pad_hetero_cone_masks(cones, B, 6, 3, ball_u=[ball],
                                  axis_u=[axis], device="cuda")
    kw = dict(max_iter=60, cones=cones)
    if mode == "adaptive":
        kw.update(check_termination=2, abs_pri_tol=1e-2, abs_dua_tol=1e-2)
    cold = sa.StreamCarry.zeros(B, sp)
    _assert_stream_close(sa.stream_solve(x0, cold, sp, **kw),
                         sa.stream_solve_plain(x0, cold, sp, **kw))
    kw.update(cone_params=cp, cone_masks=cm)
    _assert_stream_close(hs.hstream_solve(x0, cold, hsp, **kw),
                         hs.hstream_solve_plain(x0, cold, hsp, **kw))


def test_stream_cascades_are_bit_exact_on_the_card(card):
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa
    from accelerated_tinympc_tpu_torch.solver.cascade import (
        hstream_cascade_solve, stream_cascade_solve,
    )

    sp, hsp, x0 = _stream_parts(1000, 8, 3, 128, seed=2)
    kw = dict(check_termination=5, abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    for solve, cascade, ops in ((sa.stream_solve, stream_cascade_solve, sp),
                                (hs.hstream_solve, hstream_cascade_solve,
                                 hsp)):
        cold = sa.StreamCarry.zeros(1000, ops)
        one = solve(x0, cold, ops, max_iter=100, **kw)
        U, X, stats, carry = cascade(x0, cold, ops, max_iter=100,
                                     segment_iters=10, **kw)
        assert torch.equal(U, one.U) and torch.equal(stats, one.stats)
        assert all(torch.equal(a, b) for a, b in zip(carry, one.carry))


def test_stream_kernels_refuse(card):
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    sp, hsp, x0 = _stream_parts(4, 3, 2, 5)
    cold = sa.StreamCarry.zeros(4, sp)
    with pytest.raises(ValueError, match="scan tier"):
        sa.stream_solve(x0, cold, sp.replace(dims=(33, 2, 5)))
    with pytest.raises(TypeError, match="float32"):
        sa.stream_solve(x0.double(), cold, sp)
