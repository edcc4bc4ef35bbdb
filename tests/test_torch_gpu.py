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
    fused_solve_plain, pad_problem, rollout_const_seq, rollout_ops,
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


@pytest.mark.parametrize("n", [133, 5, 1])   # 5, 1: fewer than the slots
def test_adaptive_kernel_matches_plain(card, n):
    _problem, pp, x0s, cold = card
    x0s, cold = x0s[:n], FusedCarry(*(t[:n] for t in cold))
    kw = dict(max_iter=200, check_termination=1, abs_pri_tol=0.05,
              abs_dua_tol=0.05)
    got = fused_solve(x0s, cold, pp, **kw)
    want = fused_solve_plain(x0s, cold, pp, **kw)
    same = got.stats[:, 0] == want.stats[:, 0]
    assert float(same.float().mean()) >= (0.99 if n > 100 else 1.0)
    assert float((got.U - want.U)[same].abs().max()) <= ATOL
    assert float((got.carry.D - want.carry.D)[same].abs().max()) <= ATOL


@pytest.mark.parametrize("check", [0, 1], ids=["fixed", "adaptive"])
def test_exported_fused_solve_is_bit_exact_with_fused_solve(card, tmp_path,
                                                            check):
    """``export_fused_solve`` saved and loaded: the artifact launches K1/K2
    through the ``atm_torch::fused_solve`` op (counted) and gives
    ``fused_solve``'s bits on every output."""
    from accelerated_tinympc_tpu_torch.api import (
        export_fused_solve, load_exported, save_exported,
    )

    _problem, pp, x0s, cold = card
    kw = dict(max_iter=60, check_termination=check)
    f = tmp_path / "fused.pt2"
    save_exported(f, export_fused_solve(pp, x0s.shape[0], **kw))
    solve = load_exported(f)
    name = "fused_solve_adaptive" if check else "fused_solve_fixed"
    before = fused_admm.LAUNCH_COUNTS[name]
    out = solve(x0s, *cold)
    assert fused_admm.LAUNCH_COUNTS[name] == before + 1
    want = fused_solve(x0s, cold, pp, **kw)
    for k, v in dict(U=want.U, X=want.X, stats=want.stats,
                     **want.carry._asdict()).items():
        assert torch.equal(out[k], v), k


def test_artifact_exported_on_the_cpu_refuses_cuda_inputs(card, tmp_path):
    """An artifact holds its operators on the device it was exported for:
    exported on the CPU and called with CUDA inputs, the op goes to its
    CUDA kernel, whose launch finds the operators on the host and raises
    before any launch."""
    from accelerated_tinympc_tpu_torch.api import (
        export_fused_solve, load_exported, save_exported,
    )

    _problem, pp, x0s, cold = card
    f = tmp_path / "fused_cpu.pt2"
    save_exported(f, export_fused_solve(pp, x0s.shape[0], max_iter=10,
                                        platforms=("cpu",)))
    solve = load_exported(f)
    before = dict(fused_admm.LAUNCH_COUNTS)
    with pytest.raises(ValueError, match="is on cpu"):
        solve(x0s, *cold)
    assert fused_admm.LAUNCH_COUNTS == before


def _tracking(batch=133):
    problem, cache, x0, Xref_total = atm.models.quadrotor_tracking_setup()
    ops = atm.condensed_operators(cache, problem.A, problem.B,
                                  problem.horizon)
    pp = pad_problem(problem, cache, ops)
    rng = np.random.default_rng(1)
    x0s = torch.as_tensor(x0[None] + 0.02 * rng.standard_normal((batch, 12)),
                          dtype=torch.float32, device="cuda")
    cs = rollout_const_seq(pp, problem.Q, cache.Pinf, Xref_total, 12)
    return problem, pp, x0s, cs


@pytest.mark.parametrize("tracking", [False, True])
def test_rollout_kernel_matches_plain(card, tracking):
    problem, pp, x0s, cold = card
    kw = dict(max_iter=30)
    if tracking:   # a const_d row per tick, per slot
        problem, pp, x0s, cs = _tracking()
        kw = dict(max_iter=100, check_termination=1, const_seq=cs[:10])
    rops = rollout_ops(problem, pp)
    # fixed and adaptive tick solves are two kernels, counted apart
    name = "fused_rollout" if tracking else "fused_rollout_fixed"
    before = dict(fused_admm.LAUNCH_COUNTS)
    got = fused_rollout(x0s, cold, pp, rops, 10, **kw)
    assert fused_admm.LAUNCH_COUNTS == {**before, name: before[name] + 1}
    want = fused_rollout_plain(x0s, cold, pp, rops, 10, **kw)
    # chip_smoke.py's mission bars: counts per instance-tick, values on the
    # instances whose whole schedule agrees, all controls within twice the
    # exit tolerance (1e-3)
    assert float((got.iters == want.iters).float().mean()) >= 0.95
    same = (got.iters == want.iters).all(dim=0)
    assert float((got.us - want.us)[:, same].abs().max()) <= ATOL
    assert float((got.x_final - want.x_final)[same].abs().max()) <= ATOL
    assert float((got.us - want.us).abs().max()) <= 2e-3


def _permuted_equal(run, tensors, batch, seed=5):
    """``run(*tensors)`` on a permuted batch, un-permuted, is bit for bit
    ``run(*tensors)``: each instance's arithmetic depends on its own data
    only, not on its slot, block or the order of claims."""
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(batch),
                           device="cuda")
    a = run(*tensors)
    b = run(*(t[perm] for t in tensors))
    inv = torch.argsort(perm)
    return all(torch.equal(x, y[inv]) for x, y in zip(a, b))


def _solve_fields(r):
    return (r.U, r.X, r.stats) + tuple(r.carry)


def _mission_fields(r):
    return (r.x_final, r.us.transpose(0, 1), r.iters.T) + _solve_fields(
        r.final)


@pytest.mark.parametrize("kind", ["solve", "mission", "tracking mission"])
def test_permuted_batch_is_bit_exact(card, kind):
    problem, pp, x0s, cold = card
    kw = dict(max_iter=100, check_termination=1)
    rops = rollout_ops(problem, pp)
    if kind == "solve":   # K2, warm after a short mission: exits spread
        lead = fused_rollout(x0s, cold, pp, rops, 6, **kw)
        x1, warm = lead.x_final, lead.final.carry.reset_duals()
        run = lambda x, *c: _solve_fields(
            fused_solve(x, FusedCarry(*c), pp, **kw))
        assert _permuted_equal(run, (x1,) + tuple(warm), x1.shape[0])
        # back to back: the work counter starts at zero in every launch
        first, second = run(x1, *warm), run(x1, *warm)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        return
    if kind == "tracking mission":   # K3 with a const_d row per slot
        problem, pp, x0s, cs = _tracking()
        kw["const_seq"] = cs
        rops = rollout_ops(problem, pp)
    run = lambda x, d, v: _mission_fields(fused_rollout(
        x, FusedCarry(d, d, v, d, v), pp, rops, 12, **kw))
    assert _permuted_equal(run, (x0s, cold.D, cold.V), x0s.shape[0])


def test_float64_on_the_card_raises(card):
    _problem, pp, x0s, cold = card
    with pytest.raises(TypeError, match="float32"):
        fused_solve(x0s.double(), cold, pp, max_iter=5)


# ------------------------------------------ operator placements ----

def _quadrotor(horizon, batch=133):
    problem, cache, x0 = atm.models.quadrotor_hovering_setup(horizon=horizon)
    ops = atm.condensed_operators(cache, problem.A, problem.B, horizon)
    pp = pad_problem(problem, cache, ops)
    rng = np.random.default_rng(horizon)
    x0s = torch.as_tensor(x0[None] + 0.05 * rng.standard_normal((batch, 12)),
                          dtype=torch.float32, device="cuda")
    return problem, cache, pp, x0s


@pytest.mark.parametrize("N", [10, 18])
def test_operator_placements_are_bit_identical(card, N):
    """Where the operators fit shared memory, reading them from device
    memory instead changes no bit at one launch geometry (every product
    sums in the same order; the backward product's depth split follows
    slots and threads)."""
    problem, _cache, pp, x0s = _quadrotor(N)
    assert fused_admm.choose_placement(pp.dims) == "shared"
    cold = FusedCarry.zeros(x0s.shape[0], pp)
    geo = dict(batch_tile=8, threads=128)
    for kw in (dict(max_iter=50), dict(max_iter=100, check_termination=1)):
        a, b = (fused_solve(x0s, cold, pp, placement=pl, **geo, **kw)
                for pl in ("shared", "device"))
        assert all(torch.equal(x, y)
                   for x, y in zip(_solve_fields(a), _solve_fields(b)))
    rops = rollout_ops(problem, pp)
    a, b = (fused_rollout(x0s, cold, pp, rops, 6, placement=pl, max_iter=30,
                          **geo) for pl in ("shared", "device"))
    assert all(torch.equal(x, y)
               for x, y in zip(_mission_fields(a), _mission_fields(b)))


def test_tinympc_fused_past_shared_memory_matches_the_plain_tiers(card):
    """N=20: the quadrotor's operators no longer fit shared memory; the
    fused tier reads them from device memory. Controls within 1e-4 of the
    fused plain version and of the scan and condensed tiers; states within
    2e-4 of the fused plain version (chip_smoke.py's bars)."""
    problem, cache, pp, x0s = _quadrotor(20)
    assert fused_admm.choose_placement(pp.dims) == "device"
    settings = atm.Settings(max_iter=100, check_termination=0)
    res = {}
    for tier in ("fused", "condensed", "scan"):
        mpc = atm.TinyMPC.from_parts(problem, cache, tier=tier,
                                     batch=x0s.shape[0], settings=settings)
        mpc.set_x0(x0s)
        mpc.solve()
        res[tier] = (mpc.get_u(), mpc.get_x())
    want = fused_solve_plain(x0s, FusedCarry.zeros(x0s.shape[0], pp), pp,
                             max_iter=100)
    u, x = res["fused"]
    assert np.abs(u.reshape(u.shape[0], -1) - want.U.cpu().numpy()).max() <= ATOL
    assert np.abs(x.reshape(x.shape[0], -1) - want.X.cpu().numpy()).max() <= 2 * ATOL
    for tier in ("condensed", "scan"):
        assert np.abs(u - res[tier][0]).max() <= ATOL, tier


def test_register_tiles_of_8_and_4_slots_are_bit_identical(card):
    """A slot's arithmetic does not depend on how many slots share its
    register tile: at N=40 (operators in device memory) tiles of 8 and of 4
    slots give the same bits for a fixed solve (K1), a warm adaptive solve
    (K2) and a 12-tick mission (K3), at one launch geometry (a block of one
    register tile, 128 threads: the same backward depth split)."""
    problem, _cache, pp, x0s = _quadrotor(40)
    assert fused_admm.choose_placement(pp.dims) == "device"
    assert fused_admm.choose_register_tile(pp.dims) == 8
    cold = FusedCarry.zeros(x0s.shape[0], pp)
    geo = lambda ri: dict(placement="device", register_tile=ri,
                          batch_tile=ri, threads=128)
    rops = rollout_ops(problem, pp)
    lead = fused_rollout(x0s, cold, pp, rops, 4, max_iter=100,
                         check_termination=1)
    x1, warm = lead.x_final, lead.final.carry.reset_duals()
    for run, fields in (
            (lambda ri: fused_solve(x0s, cold, pp, max_iter=100, **geo(ri)),
             _solve_fields),
            (lambda ri: fused_solve(x1, warm, pp, max_iter=100,
                                    check_termination=1, **geo(ri)),
             _solve_fields),
            (lambda ri: fused_rollout(x0s, cold, pp, rops, 12, max_iter=100,
                                      check_termination=1, **geo(ri)),
             _mission_fields)):
        a, b = run(8), run(4)
        assert all(torch.equal(x, y) for x, y in zip(fields(a), fields(b)))


# ------------------------------------- K1's own body (csrc/fixed_waves.cuh)

def _k1_shape(shape, batch):
    """``(pp, x0s)`` of a K1 shape at ``batch``: the quadrotor at N=10, 40
    or 129, or the lander (box-only)."""
    if shape == "lander":
        _problem, pp, _cops, _cones, x0s = _lander(batch=batch)
        return pp, x0s
    _problem, _cache, pp, x0s = _quadrotor(int(shape[1:]), batch=batch)
    return pp, x0s


@pytest.mark.parametrize("shape", ["N10", "lander", "N40", "N129"])
def test_fixed_kernel_matches_plain_at_every_batch(card, shape):
    """K1 fixed-100 cold against its plain version at batches 1, 37 and
    4,099 (the last two end on a partly filled wave, or slot round, of the
    launch): controls, D and Z within 1e-4, states, duals and V within
    2e-4, iteration counts and solved flags equal, residual columns within
    chip_smoke.py's bar (rtol 1e-3, plus 1e-6 and what the iterates'
    disagreement e moves a residual: 2 max(1, rho) e). The flagship and
    the lander run K1's own body, N=40 and N=129 the shared slot body
    (fused_admm.fixed_path)."""
    for batch in (1, 37, 4099):
        pp, x0s = _k1_shape(shape, batch)
        tile, threads, _smem, _pl, ri = fused_admm._geometry(
            pp.dims, batch, "cuda", None, None)
        path = fused_admm.fixed_path(pp.dims, tile, threads, ri)
        assert path == ("waves" if shape in ("N10", "lander") else "slots")
        cold = FusedCarry.zeros(batch, pp)
        got = fused_solve(x0s, cold, pp, max_iter=100)
        want = fused_solve_plain(x0s, cold, pp, max_iter=100)
        _assert_solve_close(got, want, min_agree=1.0)
        assert float((got.X - want.X).abs().max()) <= 2 * ATOL
        assert torch.equal(got.stats[:, :2], want.stats[:, :2])
        e = max(float((a - b).abs().max()) for a, b in zip(
            (got.U, got.X) + tuple(got.carry),
            (want.U, want.X) + tuple(want.carry)))
        rg, rw = got.stats[:, 2:].double(), want.stats[:, 2:].double()
        excess = float(((rg - rw).abs() - 1e-3 * rw.abs()).max())
        assert excess <= 1e-6 + 2 * max(1.0, pp.rho_f) * e


def test_fixed_kernel_is_bit_exact_under_a_permuted_batch(card):
    """K1's own body: each instance's arithmetic depends on its own data,
    not on its wave, slot or block, so a permuted batch gives the permuted
    result bit for bit (4,099 and 37: partly filled last waves; warm
    carries, so every input matters), and so does a second launch."""
    for shape, batch in (("N10", 4099), ("N10", 37), ("lander", 4099)):
        pp, x0s = _k1_shape(shape, batch)
        warm = fused_solve(x0s, FusedCarry.zeros(batch, pp), pp,
                           max_iter=7).carry
        run = lambda x, *c: _solve_fields(
            fused_solve(x, FusedCarry(*c), pp, max_iter=60))
        assert _permuted_equal(run, (x0s,) + tuple(warm), batch), shape
        first, second = run(x0s, *warm), run(x0s, *warm)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("case", ["N10_65536", "N10_4099", "N10_37",
                                  "lander", "N18_shared", "N18_device",
                                  "N19_37", "relaxed"])
def test_fixed_kernel_paths_give_the_same_bits(card, case, monkeypatch):
    """At a shape both bodies take, K1's own body and the shared slot body
    (``fused_admm.FIXED_WAVES = False``) give the same bits: the same sums
    in the same order at the same geometry. Warm carries, both
    placements; at 65,536 each block of the own body runs several waves
    (at 4,099 and 37 one); an over-relaxed solve takes the shared body
    (``fixed_path``), so its bits are the shared body's."""
    shape, batch = {"N10_65536": ("N10", 65536),
                    "N10_4099": ("N10", 4099), "N10_37": ("N10", 37),
                    "lander": ("lander", 4099), "N18_shared": ("N18", 133),
                    "N18_device": ("N18", 133), "N19_37": ("N19", 37),
                    "relaxed": ("N10", 4099)}[case]
    pp, x0s = _k1_shape(shape, batch)
    kw = dict(max_iter=50, alpha=1.6 if case == "relaxed" else 1.0)
    if case.startswith("N18"):
        kw.update(placement=case[4:], batch_tile=8, threads=128)
    warm = fused_solve(x0s, FusedCarry.zeros(batch, pp), pp,
                       max_iter=5).carry
    tile, threads, _smem, _pl, ri = fused_admm._geometry(
        pp.dims, batch, "cuda", kw.get("batch_tile"), kw.get("threads"),
        placement=kw.get("placement"))
    assert fused_admm.fixed_path(pp.dims, tile, threads, ri,
                                 alpha=kw["alpha"]) == (
        "slots" if case == "relaxed" else "waves")
    res = {}
    for flag in (True, False):
        monkeypatch.setattr(fused_admm, "FIXED_WAVES", flag)
        before = fused_admm.LAUNCH_COUNTS["fused_solve_fixed"]
        res[flag] = _solve_fields(fused_solve(x0s, warm, pp, **kw))
        assert fused_admm.LAUNCH_COUNTS["fused_solve_fixed"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(res[True], res[False]))


def test_fixed_kernel_smem_bytes_of_the_wrapper_are_the_kernels(card):
    """The wrapper's mirror of K1's own layout (fixed_smem_bytes) is the C
    entry's count, at both placements."""
    lib = fused_admm._library("f32")
    for dims in ((12, 4, 10), (6, 3, 15), (12, 4, 18), (12, 4, 30)):
        for tile in (8, 32, 48):
            for gops, pl in ((0, "shared"), (1, "device")):
                assert lib.atm_fused_fixed_smem_bytes(*dims, tile, gops) == \
                    fused_admm.fixed_smem_bytes(*dims, tile, pl)


@pytest.mark.parametrize("N", [100, 129])
def test_tinympc_fused_with_4_slot_tiles_matches_the_plain_version(card, N):
    """Past N=78 one register tile of 8 slots no longer fits shared memory
    and the fused tier runs tiles of 4 (N=129 is the JAX package's limit for
    the quadrotor). Through TinyMPC(tier="fused"): a fixed-100 solve
    (controls 1e-4, states 2e-4 of the fused plain version), an adaptive
    one (counts equal on >= 99 %, values on the equal ones) and a 20-tick
    in-kernel mission (counts per instance-tick on >= 95 %, values on the
    instances whose schedule agrees, every control within 2e-3):
    chip_smoke.py's bars."""
    problem, cache, pp, x0s = _quadrotor(N, batch=67)
    assert fused_admm.choose_register_tile(pp.dims) == 4
    B = x0s.shape[0]
    cold = FusedCarry.zeros(B, pp)
    for settings in (atm.Settings(max_iter=100, check_termination=0),
                     atm.Settings(max_iter=100, check_termination=1)):
        mpc = atm.TinyMPC.from_parts(problem, cache, tier="fused", batch=B,
                                     settings=settings)
        mpc.set_x0(x0s)
        mpc.solve()
        got = mpc._fused_result
        want = fused_solve_plain(x0s, cold, pp, max_iter=100,
                                 check_termination=settings.check_termination)
        same = got.stats[:, 0] == want.stats[:, 0]
        assert float(same.float().mean()) >= 0.99
        assert float((got.U - want.U)[same].abs().max()) <= ATOL
        assert float((got.X - want.X)[same].abs().max()) <= 2 * ATOL
    rops = rollout_ops(problem, pp)
    kw = dict(max_iter=100, check_termination=1)
    mpc = atm.TinyMPC.from_parts(problem, cache, tier="fused", batch=B,
                                 settings=atm.Settings(**kw))
    mpc.set_x0(x0s)
    xf, us = mpc.rollout(20, in_kernel=True)
    want = fused_rollout_plain(x0s, cold, pp, rops, 20, **kw)
    got = fused_rollout(x0s, cold, pp, rops, 20, **kw)
    assert torch.equal(us, got.us) and torch.equal(xf, got.x_final)
    assert float((got.iters == want.iters).float().mean()) >= 0.95
    same = (got.iters == want.iters).all(dim=0)
    assert float((got.us - want.us)[:, same].abs().max()) <= ATOL
    assert float((got.us - want.us).abs().max()) <= 2e-3


def test_coned_kernel_takes_any_number_of_cones(card):
    """Ten cones, one with a ten-entry ball (the kernels read a cone table
    sized at run time)."""
    from accelerated_tinympc_tpu_torch.ops import pad_cones
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    _problem, pp, x0s, cold = card
    cones = ConeSet(
        input_cones=tuple(Cone((i,), (i + 1) % 4, 2.0, 1.0) for i in range(4)),
        state_cones=(Cone(tuple(range(10)), 10, 5.0, 1.0),)
        + tuple(Cone((k,), k + 1, 3.0, 2.0) for k in range(5)))
    cops = pad_cones(pp, cones)
    before = fused_admm.LAUNCH_COUNTS["fused_solve_fixed_cones"]
    for kw in (dict(max_iter=50), dict(max_iter=100, check_termination=1,
                                       abs_pri_tol=1e-2, abs_dua_tol=1e-2)):
        _assert_solve_close(fused_solve(x0s, cold, pp, cone_ops=cops, **kw),
                            fused_solve_plain(x0s, cold, pp, cone_ops=cops,
                                              **kw))
    assert fused_admm.LAUNCH_COUNTS["fused_solve_fixed_cones"] == before + 1


# ------------------------------------------- cones in the fused kernels ----

def _lander(horizon=15, batch=133, dtype=torch.float32):
    """The powered-descent lander of examples/soc_landing.py (nx=6, nu=3:
    neither Dx nor a knot is a multiple of the kernels' float4 grid);
    ``dtype`` of the problem and its operators (x0 stays float32)."""
    from accelerated_tinympc_tpu_torch.ops import pad_cones
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    I3 = np.eye(3)
    A = np.block([[I3, 0.1 * I3], [0 * I3, I3]])
    Bm = np.vstack([0.005 * I3, 0.1 * I3])
    Q = np.concatenate([np.full(3, 10.0), np.full(3, 1.0)])
    R = np.full(3, 1.0)
    mpc = atm.TinyMPC.setup(A, Bm, Q, R, 1.0, horizon, u_min=-10.0,
                            u_max=10.0, x_min=-100.0, x_max=100.0,
                            dtype=dtype)
    ops = atm.condensed_operators(mpc.cache, mpc.problem.A, mpc.problem.B,
                                  horizon, dtype=dtype)
    pp = pad_problem(mpc.problem, mpc.cache, ops, dtype=dtype)
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
    if per_instance and mode == "adaptive":   # K4 b through the slots
        rows = {k: kw.pop(k) for k in ("cone_mu_u", "cone_shift_x")}
        run = lambda x, mu, sh, *c: _solve_fields(fused_solve(
            x, FusedCarry(*c), pp, cone_mu_u=mu[None], cone_shift_x=sh[None],
            **kw))
        assert _permuted_equal(run, (x0s, rows["cone_mu_u"][0],
                                     rows["cone_shift_x"][0]) + tuple(cold), B)
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
    before = dict(fused_admm.LAUNCH_COUNTS)
    got = fused_rollout(x0s, cold, pp, rops, 8, **kw)
    name = "fused_rollout_fixed_cones"
    assert fused_admm.LAUNCH_COUNTS == {**before, name: before[name] + 1}
    want = fused_rollout_plain(x0s, cold, pp, rops, 8, **kw)
    assert float((got.us - want.us).abs().max()) <= ATOL
    assert float((got.x_final - want.x_final).abs().max()) <= ATOL


# The coned float32 kernels run the cones in the forward stage's pass, each
# warp over whole knots (fused_admm.cone_items), or in three passes
# (fused_admm.FUSED_CONES off, the split kernels' path): the same bits.
CONED_GEOMETRIES = [dict(), dict(placement="device"),
                    dict(placement="device", register_tile=4)]


def _both_paths(run):
    fused = run()
    fused_admm.FUSED_CONES = False
    try:
        three = run()
    finally:
        fused_admm.FUSED_CONES = True
    return fused, three


def _coned_sets(card, lander):
    """(name, pp, cone ops, x0s): the lander's cones (input knot 12,
    columns 126-128, crosses the float4 group 31 | 32 and, in the dense
    items, a warp's boundary; knot 13 is the last group), overlapping input
    cones on the lander (the second's ball holds the first's axis, applied
    in order; the third at the last input column) and the ten cones on the
    quadrotor (a ten-entry ball; knots of 12 states over three groups)."""
    from accelerated_tinympc_tpu_torch.ops import pad_cones
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    _qproblem, qpp, qx0s, _cold = card
    _problem, lpp, lcops, _cones, lx0s = lander
    overlap = ConeSet(
        input_cones=(Cone((0, 1), 2, 1.0, 3.0), Cone((2,), 0, 0.8, 0.5),
                     Cone((1,), 2, 1.5, 2.0)),
        state_cones=(Cone((0, 1), 2, 2.0, 0.1),))
    ten = ConeSet(
        input_cones=tuple(Cone((i,), (i + 1) % 4, 2.0, 1.0) for i in range(4)),
        state_cones=(Cone(tuple(range(10)), 10, 5.0, 1.0),)
        + tuple(Cone((k,), k + 1, 3.0, 2.0) for k in range(5)))
    return [("lander", lpp, lcops, lx0s),
            ("overlapping", lpp, pad_cones(lpp, overlap), lx0s),
            ("ten cones", qpp, pad_cones(qpp, ten), qx0s)]


@pytest.mark.parametrize("geo", CONED_GEOMETRIES,
                         ids=["shared", "device", "device_ri4"])
def test_coned_paths_agree_and_match_plain_at_every_placement_and_tile(
        card, lander, geo):
    for name, pp, cops, x0s in _coned_sets(card, lander):
        B = x0s.shape[0]
        cold = FusedCarry.zeros(B, pp)
        tile, _t, _s, _p, ri = fused_admm._geometry(pp.dims, B, "cuda", None,
                                                    None, **geo)
        assert fused_admm.cone_path(pp.dims, tile, ri, cops) == "fused", name
        for kw in (dict(max_iter=40),
                   dict(max_iter=100, check_termination=2, abs_pri_tol=3e-2,
                        abs_dua_tol=3e-2)):
            kw.update(cone_ops=cops)
            fused, three = _both_paths(
                lambda: fused_solve(x0s, cold, pp, **geo, **kw))
            for a, b in zip(_solve_fields(fused), _solve_fields(three)):
                assert torch.equal(a, b), name
            _assert_solve_close(fused, fused_solve_plain(x0s, cold, pp, **kw),
                                min_agree=0.97)


@pytest.mark.parametrize("geo", CONED_GEOMETRIES,
                         ids=["shared", "device", "device_ri4"])
def test_coned_mission_paths_agree_at_every_placement_and_tile(lander, geo):
    problem, pp, cops, _cones, x0s = lander
    cold = FusedCarry.zeros(x0s.shape[0], pp)
    rops = rollout_ops(problem, pp)
    kw = dict(max_iter=60, check_termination=2, abs_pri_tol=3e-2,
              abs_dua_tol=3e-2, cone_ops=cops)
    fused, three = _both_paths(
        lambda: fused_rollout(x0s, cold, pp, rops, 6, **geo, **kw))
    for a, b in zip(_mission_fields(fused), _mission_fields(three)):
        assert torch.equal(a, b)
    want = fused_rollout_plain(x0s, cold, pp, rops, 6, **kw)
    assert float((fused.iters == want.iters).float().mean()) >= 0.95
    same = (fused.iters == want.iters).all(dim=0)
    assert float((fused.us - want.us)[:, same].abs().max()) <= ATOL


def test_coned_kernel_per_instance_rows_on_both_paths(lander):
    _problem, pp, cops, _cones, x0s = lander
    B = x0s.shape[0]
    cold = FusedCarry.zeros(B, pp)
    lin = lambda a, b: torch.linspace(a, b, B, device="cuda")[None]
    kw = dict(max_iter=80, check_termination=2, abs_pri_tol=3e-2,
              abs_dua_tol=3e-2, cone_ops=cops, cone_mu_u=lin(0.6, 1.4),
              cone_shift_u=lin(2.5, 3.5), cone_mu_x=lin(1.5, 2.5),
              cone_shift_x=lin(0.05, 0.2))
    fused, three = _both_paths(lambda: fused_solve(x0s, cold, pp, **kw))
    for a, b in zip(_solve_fields(fused), _solve_fields(three)):
        assert torch.equal(a, b)
    _assert_solve_close(fused, fused_solve_plain(x0s, cold, pp, **kw))


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


@pytest.mark.parametrize("dims", [(12, 4), (6, 8), (6, 3), (8, 3), (5, 2),
                                  (16, 8), (1, 1)])
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


@pytest.mark.parametrize("dims", [(17, 9), (24, 10), (32, 12)])
def test_riccati_kernel_refuses_large_sizes(card, dims):
    """Sizes past the lane-group list run the general kernel (both entry
    points, launches counted) and agree with the plain versions; only a
    plant whose working set outgrows a block's shared memory is refused."""
    from accelerated_tinympc_tpu_torch.ops import riccati_kernel as rk
    from accelerated_tinympc_tpu_torch.precompute import riccati_fixed_point

    A, B, Q, R, rho = _plants(67, *dims, seed=dims[0])
    assert rk.kernel_plan(*dims).group == 0
    before = dict(rk.LAUNCH_COUNTS)
    got, it_g = rk.riccati_fixed_point_kernel(A, B, Q, R, rho)
    want, it_w = riccati_fixed_point(A, B, Q, R, rho, max_iters=1000,
                                     tol=1e-5)
    assert float((it_g - it_w).abs().float().max()) <= 1
    for k, v in want.tensors().items():
        assert float((getattr(got, k) - v).abs().max()) <= _ric_tol(want, k), k
    rho2 = rho * 5.0
    newt = rk.riccati_cache_newton(A, B, Q, R, rho2, got.Kinf)
    wantn = rk.riccati_cache_newton_plain(A, B, Q, R, rho2, got.Kinf)
    for k, v in wantn.tensors().items():
        assert float((getattr(newt, k) - v).abs().max()) <= _ric_tol(wantn, k), k
    assert rk.LAUNCH_COUNTS["riccati_fixed_point"] == \
        before["riccati_fixed_point"] + 1
    assert rk.LAUNCH_COUNTS["riccati_newton"] == before["riccati_newton"] + 1
    big = torch.zeros((3, 110, 110), device="cuda")
    with pytest.raises(ValueError, match="bytes of shared memory"):
        rk.riccati_cache_kernel(big, torch.zeros((3, 110, 2), device="cuda"),
                                torch.ones((3, 110), device="cuda"),
                                R[:3, :2], rho[:3])


def test_auto_riccati_on_the_card_is_the_kernel_and_refuses_large_sizes(card):
    """``riccati="auto"`` on CUDA tensors launches the kernel at every size
    shared memory takes (17 states too); past that it raises and does not
    take the batched tensor code."""
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
    before = rk.LAUNCH_COUNTS["riccati_fixed_point"]
    ops, caches = build_instance_ops_from_plants(
        A, B, Q, R, rho, bounds(A, B, Q, R))
    assert rk.LAUNCH_COUNTS["riccati_fixed_point"] == before + 1
    want = rk.riccati_cache_kernel_plain(A, B, Q, R, rho)
    assert float((caches.Kinf - want.Kinf).abs().max()) <= _ric_tol(want, "Kinf")
    A, B, Q, R, rho = _plants(2, 110, 2)
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
                                  (20, 6, 5), (1, 1, 3), (40, 12, 10),
                                  (33, 33, 10)])
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
    """Any nx, nu run (a lane owns several rows past 32); the kernels refuse
    only where one instance outgrows a block's shared memory, naming the
    bytes and the tier that runs any size."""
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha

    hp, x0 = _fleet(4, 3, 2, 5)
    big = hp.replace(dims=(120, 60, 10))
    with pytest.raises(ValueError, match=r"need \d+ bytes.*instance_ops"):
        ha.hetero_solve(x0, ha.HeteroCarry.zeros(hp), big)


def _past_the_slots(nx, nu, N, seed):
    """A fleet a quarter past the instances the card holds at once, so
    slots retire and take new instances from the work counter."""
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha

    slots = ha.hetero_slots(nx, nu, N)
    hp, x0 = _fleet(slots + slots // 4, nx, nu, N, seed=seed)
    return hp, x0, slots


@pytest.mark.parametrize("dims", [(12, 4, 10), (8, 3, 10), (33, 33, 10)],
                         ids=["12/4/10", "8/3/10", "33/33/10"])
def test_hetero_kernels_are_bit_exact_under_a_permuted_batch(card, dims):
    """K7/K8's slots (the compiled 12/4 body and the run-time one), with a
    batch past the slots the card holds: a permuted batch gives the
    permuted result bit for bit, and so does a second launch (slots take
    other instances in another order)."""
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha

    hp, x0, slots = _past_the_slots(*dims, seed=8)
    B = x0.shape[0]
    assert B > slots
    cold = ha.HeteroCarry.zeros(hp)
    perm = torch.as_tensor(np.random.default_rng(9).permutation(B),
                           device="cuda")
    inv = torch.argsort(perm)
    hp_p, cold_p, x0_p, _cp, _cm = ha.gather_hetero(hp, cold, x0, perm)
    for kw in (dict(max_iter=30),
               dict(max_iter=60, check_termination=1, abs_pri_tol=1e-3,
                    abs_dua_tol=1e-3)):
        one = _solve_fields(ha.hetero_solve(x0, cold, hp, **kw))
        again = _solve_fields(ha.hetero_solve(x0_p, cold_p, hp_p, **kw))
        assert all(torch.equal(a, b[inv]) for a, b in zip(one, again))
        twice = _solve_fields(ha.hetero_solve(x0, cold, hp, **kw))
        assert all(torch.equal(a, b) for a, b in zip(one, twice))


def test_hetero_cascade_relaunch_is_bit_exact_with_refills(card):
    """The compaction cascade (segments of 10 iterations, survivors gathered
    and relaunched) against one adaptive call, on a batch past the slots:
    the same bits."""
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
    from accelerated_tinympc_tpu_torch.solver.cascade import (
        hetero_cascade_solve,
    )

    hp, x0, _slots = _past_the_slots(12, 4, 10, seed=3)
    cold = ha.HeteroCarry.zeros(hp)
    kw = dict(check_termination=1, abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    one = ha.hetero_solve(x0, cold, hp, max_iter=100, **kw)
    U, X, stats, carry = hetero_cascade_solve(
        x0, cold, hp, max_iter=100, segment_iters=10, **kw)
    assert torch.equal(U, one.U) and torch.equal(X, one.X)
    assert torch.equal(stats, one.stats)
    assert all(torch.equal(a, b) for a, b in zip(carry, one.carry))


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


@pytest.mark.parametrize("dims, tier", [
    (dims, tier) for dims in ((8, 3, 64), (6, 3, 256), (12, 4, 33), (1, 1, 5))
    for tier in ("stream", "hstream")] + [
    (dims, tier) for dims in ((40, 12, 64), (33, 33, 16))
    for tier in ("stream", "hstream")])
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
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    sp, hsp, x0 = _stream_parts(4, 3, 2, 5)
    cold = sa.StreamCarry.zeros(4, sp)
    # the per-instance plants only past shared memory (one instance a block,
    # a ring of two knots), naming the bytes and the scan tier
    need = sa.hstream_smem_bytes(120, 60, 2)
    with pytest.raises(ValueError, match=f'need {need} bytes.*tier="scan"'):
        hs.hstream_solve(x0, cold, hsp.replace(dims=(120, 60, 5)))
    with pytest.raises(TypeError, match="float32"):
        sa.stream_solve(x0.double(), cold, sp)
    # the shared plant only past shared memory, naming the bytes
    need = sa.shared_smem_bytes(120, 40, 1)
    with pytest.raises(ValueError, match=f"need {need} bytes"):
        sa.stream_solve(x0, cold, sp.replace(dims=(120, 40, 5)))


@pytest.mark.parametrize("dims", [(12, 4, 64), (8, 3, 64), (33, 33, 16)])
def test_hstream_kernels_are_bit_exact_under_permutation_and_knot_block(
        card, dims):
    """K11/K12 (the compiled 12/4 body and the run-time one): a permuted
    batch gives the permuted result bit for bit, and so do rings of 8, 16
    and 64 knots (knot_block up to the ring's cap)."""
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    B = 133
    _sp, hsp, x0 = _stream_parts(B, *dims, seed=7)
    cold = sa.StreamCarry.zeros(B, hsp)
    perm = torch.as_tensor(np.random.default_rng(9).permutation(B),
                           device="cuda")
    inv = torch.argsort(perm)
    hsp_p, cold_p, x0_p, _cp, _cm = hs.gather_hstream(hsp, cold, x0, perm)
    for kw in (dict(max_iter=30),
               dict(max_iter=60, check_termination=5, abs_pri_tol=1e-3,
                    abs_dua_tol=1e-3)):
        runs = [_solve_fields(hs.hstream_solve(x0, cold, hsp, knot_block=k,
                                               **kw)) for k in (8, 16, 64)]
        assert all(torch.equal(a, b) for r in runs[1:]
                   for a, b in zip(r, runs[0]))
        again = _solve_fields(hs.hstream_solve(x0_p, cold_p, hsp_p, **kw))
        assert all(torch.equal(a, b[inv]) for a, b in zip(runs[0], again))


@pytest.mark.parametrize("nx, nu", [(8, 3), (33, 33)])
def test_stream_slots_are_bit_exact_under_a_permuted_batch(card, nx, nu):
    """K10's slots: a batch a quarter past the slots the card holds at once
    (the compiled 8/3 body, and the run-time body at 33/33, one block an
    SM), so slots retire and take new instances from the work counter at
    their own iteration boundaries; the batch holds the bars against the
    plain version and a permuted batch gives the permuted result bit for
    bit."""
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    N = 16
    slots = sa.shared_slots(nx, nu, N)
    B = slots + slots // 4
    assert B > slots > 0
    sp, _hsp, _x0 = _stream_parts(3, nx, nu, N, seed=3)
    rng = np.random.default_rng(4)
    scale = np.array([0.05, 0.5, 2.0])[rng.integers(0, 3, B)][:, None]
    x0 = torch.as_tensor(scale * rng.standard_normal((B, nx)),
                         dtype=torch.float32, device="cuda")
    kw = dict(max_iter=60, check_termination=5, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3)
    cold = sa.StreamCarry.zeros(B, sp)
    got = sa.stream_solve(x0, cold, sp, **kw)
    _assert_stream_close(got, sa.stream_solve_plain(x0, cold, sp, **kw))
    run = lambda x, *c: _solve_fields(
        sa.stream_solve(x, sa.StreamCarry(*c), sp, **kw))
    assert _permuted_equal(run, (x0,) + tuple(cold), B)
    spread = got.stats[:, 0]
    assert float(spread.min()) < float(spread.max())   # exits spread


def _ten_cones(nu=4):
    """Ten cones, one with a ten-entry ball: four on the input knot, six on
    the state knot (nx >= 11)."""
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    return ConeSet(
        input_cones=tuple(Cone((i,), (i + 1) % nu, 2.0, 1.0)
                          for i in range(4)),
        state_cones=(Cone(tuple(range(10)), 10, 5.0, 1.0),)
        + tuple(Cone((k,), k + 1, 3.0, 2.0) for k in range(5)))


@pytest.mark.parametrize("kernel", ["stream", "hstream", "hetero"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_long_horizon_and_fleet_kernels_take_ten_cones(card, kernel, mode):
    """The stream, hstream and hetero kernels read a cone table sized at
    run time: ten cones, one with a ten-entry ball, against the plain
    versions."""
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    cones = _ten_cones()
    kw = dict(max_iter=40, cones=cones)
    if mode == "adaptive":
        kw.update(check_termination=2, abs_pri_tol=1e-2, abs_dua_tol=1e-2)
    if kernel == "hetero":
        hp, x0 = _fleet(133, 12, 4, 10, seed=6)
        cold = ha.HeteroCarry.zeros(hp)
        _assert_hetero_close(ha.hetero_solve(x0, cold, hp, **kw),
                             ha.hetero_solve_plain(x0, cold, hp, **kw))
        return
    sp, hsp, x0 = _stream_parts(133, 12, 4, 64, seed=6)
    ops, solve, plain = ((sp, sa.stream_solve, sa.stream_solve_plain)
                         if kernel == "stream" else
                         (hsp, hs.hstream_solve, hs.hstream_solve_plain))
    cold = sa.StreamCarry.zeros(133, ops)
    _assert_stream_close(solve(x0, cold, ops, **kw),
                         plain(x0, cold, ops, **kw))


@pytest.mark.parametrize("check", [0, 1], ids=["fixed", "adaptive"])
def test_world_of_one_sharded_fused_solve_is_fused_solve(card, check):
    """A world of one on the card (no process group): ``sharded_fused_solve``
    launches K1/K2 once on the whole batch and gives ``fused_solve``'s bits;
    its stats are the reduction of those outputs."""
    from accelerated_tinympc_tpu_torch.parallel import (
        make_batch_mesh, shard_batch, sharded_fused_solve,
    )

    _problem, pp, x0s, cold = card
    kw = dict(max_iter=60, check_termination=check)
    mesh = make_batch_mesh()
    assert mesh.size == 1 and mesh.device.type == "cuda"
    name = "fused_solve_adaptive" if check else "fused_solve_fixed"
    before = fused_admm.LAUNCH_COUNTS[name]
    got, stats = sharded_fused_solve(mesh, pp, **kw)(
        shard_batch(x0s, mesh), shard_batch(cold, mesh))
    assert fused_admm.LAUNCH_COUNTS[name] == before + 1
    want = fused_solve(x0s, cold, pp, **kw)
    for k, v in dict(U=want.U, X=want.X, stats=want.stats,
                     **want.carry._asdict()).items():
        g = got.carry._asdict()[k] if k in want.carry._fields else getattr(
            got, k)
        assert torch.equal(g, v), k
    assert float(stats["n_total"]) == x0s.shape[0]
    assert float(stats["iterations_sum"]) == float(want.stats[:, 0].sum())
    assert float(stats["dual_residual_input_max"]) == float(
        want.stats[:, 5].max())


# ------------------------------------------------ split-bf16 (algo="bf16x3")
# The kernels of csrc/fused_admm_bf16x3.cu against the plain version of the
# same schedule, by chip_smoke.py's checks of them: the split is
# discontinuous (an iterate one float32 ulp apart may split into other bf16
# pairs), so where the kernel misses the float32 kernels' bars the float64
# plain version of the same splits arbitrates (``arbitrate(rule="split")``),
# and the kernel must sit nearer the split plain version than the float32
# one (``split_closer``); short solves, where the arithmetics part, pin the
# schedule (``split_separation``).


def _pp64(problem, cache):
    f64 = torch.float64
    return pad_problem(problem.to(dtype=f64), cache.to(dtype=f64),
                       atm.condensed_operators(
                           cache, problem.A, problem.B, problem.horizon,
                           dtype=f64), dtype=f64)


def _split_close(name, got, pp, plain, kw):
    """``got`` (a split kernel's solve) by chip_smoke.py's checks:
    ``plain(dtype, device, **kw)`` runs the plain version on the inputs in
    that type on that device."""
    import chip_smoke as cs

    want = plain(torch.float32, "cuda", **kw)
    check = kw.get("check_termination", 0)
    case = cs.arbitrate(
        cs.compare_solve(name, got, want, check, pp.rho_f,
                         max_iter=kw["max_iter"]), got, want,
        lambda: plain(torch.float64, "cuda", **kw),
        lambda: plain(torch.float32, "cpu", **kw), max(check, 1),
        rule="split")
    f32 = {k: v for k, v in kw.items() if k != "algo"}
    cs.split_closer(case, got, want, lambda: plain(torch.float32, "cuda",
                                                   **f32),
                    lambda r: r.U, cs.solve_sched, kw)
    assert not case["failures"], case["failures"]


def _plain_of(x0s, cold, cones=None):
    """The plain quadrotor solve (or, with ``cones``, the lander's) of
    these inputs in a type on a device, for ``_split_close``."""
    from accelerated_tinympc_tpu_torch.ops import pad_cones

    def run(dtype, device, **kw):
        if cones is None:
            problem, cache, _x0 = atm.models.quadrotor_hovering_setup()
            pp = (_pp64(problem, cache) if dtype == torch.float64 else
                  pad_problem(problem, cache, atm.condensed_operators(
                      cache, problem.A, problem.B, problem.horizon)))
        else:
            pp = _lander(dtype=dtype)[1]
        pp = pp.to(device=device)
        extra = {} if cones is None else {"cone_ops": pad_cones(pp, cones)}
        kw = {k: (v.to(device=device) if isinstance(v, torch.Tensor) else v)
              for k, v in kw.items()}
        return fused_solve_plain(
            x0s.to(device=device, dtype=dtype),
            FusedCarry(*(t.to(device=device, dtype=dtype) for t in cold)),
            pp, **extra, **kw)
    return run


# chip_smoke.py's held cases at its comparison batch (4,099): K1 cold
# fixed-100 at polish 8 and 6, K2 warm at checks every 5 and tolerance 0.05.
# The arbiter's 0.99 quantile is a statistic of thousands of instances: at a
# hundred it is the second-largest error, which the split's flips set.
BF16X3 = {"fixed_polish8": dict(max_iter=100, check_termination=0, polish=8),
          "fixed_polish6": dict(max_iter=100, check_termination=0, polish=6),
          "adaptive_check5": None}


@pytest.mark.parametrize("case", list(BF16X3))
def test_bf16x3_kernels_match_plain(card, case):
    import chip_smoke as cs

    problem, _cache, pp, x0s = cs.flagship(cs.KERNEL_BATCH, "cuda")
    cy = FusedCarry.zeros(x0s.shape[0], pp, device="cuda")
    kw = BF16X3[case]
    if kw is None:
        x0s, cy = cs.warm_start(problem, pp, x0s, "cuda")
        kw = cs.BF16X3_ADAPTIVE
    name = fused_admm.kernel_name(
        "fused_solve_adaptive" if kw.get("check_termination") else
        "fused_solve_fixed", False, "bf16x3")
    before = fused_admm.LAUNCH_COUNTS[name]
    got = fused_solve(x0s, cy, pp, algo="bf16x3", **kw)
    assert fused_admm.LAUNCH_COUNTS[name] == before + 1
    _split_close(case, got, pp, _plain_of(x0s, cy),
                 dict(algo="bf16x3", **kw))


@pytest.mark.parametrize("case", ["K1_polish1", "K1_polish2",
                                  "K2_warmup2_check3", "K3_mission",
                                  "K4a_cones"])
def test_bf16x3_short_solves_separate_the_schedules(card, case):
    # a few iterations, where the split and float32 arithmetics part: per
    # instance, the kernel nearer the plain version of its own schedule
    # than the float32 plain version or a schedule one iteration off, and
    # the median distances apart by the smoke's bars
    # (chip_smoke.split_separation)
    import chip_smoke as cs

    problem, pp, x0s, cold = card
    run_k = lambda **a: fused_solve(x0s, cold, pp, **a)
    run_p = lambda **a: fused_solve_plain(x0s, cold, pp, **a)
    u, its = (lambda r: r.U), (lambda r: r.stats[:, 0])
    fixed, adaptive = cs.BF16X3_SHORT_FIXED, cs.BF16X3_SHORT_ADAPTIVE
    late = {"warmup=3": dict(warmup_iters=adaptive["warmup_iters"] + 1)}
    if case.startswith("K1"):
        p = int(case[-1])
        kw, alts = dict(fixed, polish=p), {
            f"polish={q}": dict(polish=q) for q in (p - 1, p + 1) if q >= 1}
    elif case == "K2_warmup2_check3":
        kw, alts = adaptive, late
    elif case == "K3_mission":
        rops = rollout_ops(problem, pp)
        run_k = lambda **a: fused_rollout(x0s, cold, pp, rops, 3, **a)
        run_p = lambda **a: fused_rollout_plain(x0s, cold, pp, rops, 3, **a)
        kw, alts = adaptive, late
        u, its = (lambda r: r.us.transpose(0, 1)), (lambda r: r.iters)
    else:
        _p, lpp, cops, _cones, lx0 = _lander()
        lcold = FusedCarry.zeros(lx0.shape[0], lpp)
        run_k = lambda **a: fused_solve(lx0, lcold, lpp, cone_ops=cops, **a)
        run_p = lambda **a: fused_solve_plain(lx0, lcold, lpp, cone_ops=cops,
                                              **a)
        kw, alts = dict(fixed, polish=1), {"polish=2": dict(polish=2)}
    row = cs.split_separation(
        case, run_k, run_p, kw, alts, u, its,
        cs.SPLIT_SEP_ADAPTIVE if kw.get("check_termination") else
        cs.SPLIT_SEP_FIXED)
    assert not row["failures"], row["failures"]


@pytest.mark.parametrize("check", [0, 1], ids=["polish_all", "check1"])
def test_bf16x3_without_split_iterations_is_the_f32_kernel(card, check):
    # polish >= max_iter (fixed) or checks every iteration (adaptive): no
    # split iteration, so the split kernels give the float32 kernels' bits
    # at one launch geometry
    _problem, pp, x0s, cold = card
    geo = dict(batch_tile=16, threads=256, placement="shared")
    kw = dict(max_iter=40, check_termination=check, **geo)
    a = fused_solve(x0s, cold, pp, algo="bf16x3", polish=40, **kw)
    b = fused_solve(x0s, cold, pp, **kw)
    for x, y in zip((a.U, a.X, a.stats) + tuple(a.carry),
                    (b.U, b.X, b.stats) + tuple(b.carry)):
        assert torch.equal(x, y)


def test_bf16x3_is_bit_exact_under_a_permuted_batch(card):
    problem, pp, x0s, cold = card
    perm = torch.randperm(x0s.shape[0], device="cuda",
                          generator=torch.Generator("cuda").manual_seed(3))
    inv = torch.argsort(perm)
    kw = dict(max_iter=60, check_termination=5, algo="bf16x3")
    a = fused_solve(x0s, cold, pp, **kw)
    b = fused_solve(x0s[perm], FusedCarry(*(t[perm] for t in cold)), pp, **kw)
    for x, y in zip((a.U, a.stats) + tuple(a.carry),
                    (b.U, b.stats) + tuple(b.carry)):
        assert torch.equal(x, y[inv])
    rops = rollout_ops(problem, pp)
    got = fused_rollout(x0s, cold, pp, rops, 6, max_iter=30, polish=4,
                        algo="bf16x3")
    want = fused_rollout_plain(x0s, cold, pp, rops, 6, max_iter=30,
                               polish=4, algo="bf16x3")
    assert float((got.us - want.us).abs().max()) <= ATOL


@pytest.mark.parametrize("case", ["horizon150", "per_instance_cones",
                                  "tracking", "alpha", "compaction"])
def test_bf16x3_takes_every_input_of_the_f32_tier(card, case):
    # each input the float32 kernels take, on the split kernels against the
    # plain version of the same schedule: controls on the instances whose
    # schedule agrees
    problem, pp, x0s, cold = card
    bf = dict(algo="bf16x3")
    if case == "horizon150":   # operators in device memory, 4-slot tiles
        problem, cache, _x0 = atm.models.quadrotor_hovering_setup(
            horizon=150)
        pp = pad_problem(problem, cache, atm.condensed_operators(
            cache, problem.A, problem.B, 150))
        assert fused_admm.choose_register_tile(pp.dims, split=True) == 4
        x0s, cold = x0s[:9], FusedCarry.zeros(9, pp)
        kw = dict(max_iter=20, polish=4, **bf)
    elif case == "per_instance_cones":
        from accelerated_tinympc_tpu_torch.ops import pad_cones

        problem, pp, cops, cones, x0s = _lander()
        cold = FusedCarry.zeros(x0s.shape[0], pp)
        rows = torch.linspace(0.6, 1.4, x0s.shape[0], device="cuda")[None]
        kw = dict(max_iter=100, check_termination=2, abs_pri_tol=1e-2,
                  abs_dua_tol=1e-2, cone_mu_u=rows, **bf)
        got = fused_solve(x0s, cold, pp, cone_ops=cops, **kw)
        _split_close(case, got, pp, _plain_of(x0s, cold, cones), kw)
        return
    elif case == "tracking":
        problem, pp, x0s, cs = _tracking()
        rops = rollout_ops(problem, pp)
        kw = dict(max_iter=60, check_termination=5, abs_pri_tol=1e-2,
                  abs_dua_tol=1e-2, const_seq=cs[:8], **bf)
        got = fused_rollout(x0s, cold, pp, rops, 8, **kw)
        want = fused_rollout_plain(x0s, cold, pp, rops, 8, **kw)
        assert float((got.iters == want.iters).float().mean()) >= 0.95
        same = (got.iters == want.iters).all(dim=0)
        assert float((got.us - want.us)[:, same].abs().max()) <= ATOL
        return
    elif case == "alpha":
        kw = dict(max_iter=100, check_termination=5, warmup_iters=3,
                  alpha=1.6, abs_pri_tol=1e-2, abs_dua_tol=1e-2, **bf)
    else:   # compaction: the cascade's launches against one launch
        from accelerated_tinympc_tpu_torch.solver.cascade import cascade_solve

        kw = dict(max_iter=100, check_termination=5, abs_pri_tol=1e-2,
                  abs_dua_tol=1e-2, **bf)
        got = cascade_solve(x0s, cold, pp, segment_iters=10, **kw)
        want = fused_solve(x0s, cold, pp, **kw)
        same = got.stats[:, 0] == want.stats[:, 0]
        assert float(same.float().mean()) >= 0.95
        assert float((got.U - want.U)[same].abs().max()) <= ATOL
        return
    got = fused_solve(x0s, cold, pp, **kw)
    want = fused_solve_plain(x0s, cold, pp, **kw)
    same = got.stats[:, 0] == want.stats[:, 0]
    assert float(same.float().mean()) >= 0.95
    assert float((got.U - want.U)[same].abs().max()) <= ATOL


# Every horizon, operator placement and register tile that the float32
# kernels take, on the split kernels (their fragments are read from device
# memory in both placements, so a split block holds the float32 block's
# slots): against the plain version of the same schedule, and bit for bit
# across placements and register tiles at one launch geometry.
SPLIT_SHAPES = [(10, "shared", 8), (10, "device", 8), (18, "shared", 8),
                (18, "device", 8), (40, "device", 8), (40, "device", 4),
                (100, "device", 4), (150, "device", 4)]


@pytest.mark.parametrize("N, placement, ri", SPLIT_SHAPES)
def test_bf16x3_takes_every_horizon_placement_and_tile(card, N, placement,
                                                       ri):
    # a short fixed solve (8 of 10 iterations split) against the plain
    # version of its schedule: nearer it than the float32 plain version
    # (chip_smoke.split_closer), and within 1e-3 (the split's flips move a
    # control of these 37 instances by up to 1.2e-4 at N=100; the float32
    # and split plain versions lie further apart)
    import chip_smoke as cs

    _problem, _cache, pp, x0s = _quadrotor(N, batch=37)
    cold = FusedCarry.zeros(x0s.shape[0], pp)
    kw = dict(max_iter=10, check_termination=0, polish=2, algo="bf16x3")
    got = fused_solve(x0s, cold, pp, placement=placement, register_tile=ri,
                      **kw)
    want = fused_solve_plain(x0s, cold, pp, **kw)
    assert float((got.U - want.U).abs().max()) <= 1e-3
    f32 = {k: v for k, v in kw.items() if k != "algo"}
    case = cs.split_closer(
        {"case": f"N={N} {placement} ri={ri}", "failures": []}, got, want,
        lambda: fused_solve_plain(x0s, cold, pp, **f32), lambda r: r.U,
        cs.solve_sched, kw)
    assert not case["failures"], case["failures"]


@pytest.mark.parametrize("N", [10, 40])
def test_bf16x3_placements_and_tiles_are_bit_identical(card, N):
    problem, _cache, pp, x0s = _quadrotor(N)
    cold = FusedCarry.zeros(x0s.shape[0], pp)
    geos = ([dict(placement=pl, batch_tile=8, threads=128)
             for pl in ("shared", "device")] if N == 10 else
            [dict(placement="device", register_tile=ri, batch_tile=ri,
                  threads=128) for ri in (8, 4)])
    rops = rollout_ops(problem, pp)
    for run, fields in (
            (lambda g: fused_solve(x0s, cold, pp, max_iter=50, polish=6,
                                   algo="bf16x3", **g), _solve_fields),
            (lambda g: fused_rollout(x0s, cold, pp, rops, 6, max_iter=30,
                                     check_termination=5, algo="bf16x3",
                                     **g), _mission_fields)):
        a, b = (run(g) for g in geos)
        assert all(torch.equal(x, y) for x, y in zip(fields(a), fields(b)))


@pytest.mark.parametrize("ri", [8, 4])
def test_bf16x3_long_horizon_passes_the_arbiter_at_the_kernel_batch(card,
                                                                    ri):
    # the float64 arbiter of chip_smoke.py (rule="split") on a long horizon
    # with the operators in device memory, at the batch where its 0.99
    # quantile of per-instance errors is not the largest of a few dozen
    import chip_smoke as cs

    N = 40
    problem, cache, pp, x0s = _quadrotor(N, batch=cs.KERNEL_BATCH)
    cold = FusedCarry.zeros(x0s.shape[0], pp)
    kw = dict(max_iter=20, check_termination=0, polish=4, algo="bf16x3")
    got = fused_solve(x0s, cold, pp, placement="device", register_tile=ri,
                      **kw)

    def plain(dtype, device, **kw):
        p = _pp64(problem, cache) if dtype == torch.float64 else pp
        return fused_solve_plain(
            x0s.to(device=device, dtype=dtype),
            FusedCarry(*(t.to(device=device, dtype=dtype) for t in cold)),
            p.to(device=device), **kw)

    _split_close(f"N={N} device ri={ri} batch {cs.KERNEL_BATCH}", got, pp,
                 plain, kw)
