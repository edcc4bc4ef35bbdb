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
