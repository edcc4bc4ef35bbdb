#!/usr/bin/env python3
"""The split-operand TF32 product (mma.sync m16n8k8, three passes) emulated
on the CPU, against the fused kernels' FP32 products.

    python3 tools/tf32x3_emulation.py

That product was built and timed on an H100 in the fused kernels' place and
lost (PERF.md); the kernels keep FP32 FMA products. This script gives
the arithmetic side of that finding. Each operand is split as x = hi + lo,
hi = tf32(x), lo = tf32(x - hi), with tf32 the round to nearest (ties away)
that keeps 10 mantissa bits, and A B ~ (Alo Bhi + Ahi Blo) + Ahi Bhi in
float32 sums of exact products. Prints one JSON object:

* ``products``: for the quadrotor's (nx=12, nu=4, N=10) forward and backward
  operators against 256 random rows, the largest error over the gamma_K
  bound of a K-term float32 dot product (K eps |A| |B|), for the split
  product and for one TF32 pass (<= 1: within float32 rounding).
* ``counts_agree``: K2's workload at 256 instances (warm after a 12-tick
  mission, check every iteration, tol 1e-3, 100 iterations at most) through
  the plain solve with every product swapped, once for the split product
  and once for an exactly rounded float32 product (float64, then rounded):
  the share of instances whose iteration count and exit agree with the
  float32 plain version (chip_smoke.py asks 99 % of a kernel), and the
  largest control difference on the instances that agree.

Needs only the CPU: a few seconds.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import accelerated_tinympc_tpu_torch as atm  # noqa: E402
from accelerated_tinympc_tpu_torch.ops import (  # noqa: E402
    FusedCarry, fused_rollout_plain, fused_solve_plain, pad_problem,
    rollout_ops,
)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, keeping 10
    mantissa bits (the low 13 of float32's become 0)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a, b, matmul=torch.matmul):
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (matmul(al, bh) + matmul(ah, bl)) + matmul(ah, bh)


def main():
    problem, cache, x0 = atm.models.quadrotor_hovering_setup(device="cpu")
    ops = atm.condensed_operators(cache, problem.A, problem.B,
                                  problem.horizon, device="cpu")
    pp = pad_problem(problem, cache, ops, device="cpu")
    rng = np.random.default_rng(3)
    products = {}
    for which, W in (("forward", pp.W_f), ("backward", pp.W_b)):
        A = torch.as_tensor(rng.standard_normal((256, W.shape[0])) * 3.0,
                            dtype=torch.float32)
        exact = A.double() @ W.double()
        bound = (W.shape[0] * 2.0 ** -24
                 * (A.double().abs() @ W.double().abs()))
        nz = bound > 0   # padding columns are zero in every product
        ratio = lambda got: float(
            ((got.double() - exact).abs()[nz] / bound[nz]).max())
        products[which] = {
            "split_err_over_bound": ratio(matmul_3xtf32(A, W)),
            "one_pass_err_over_bound": ratio(tf32(A) @ tf32(W))}

    B = 256
    rng = np.random.default_rng(0)
    xs = torch.as_tensor(x0[None] + 0.05 * rng.standard_normal((B, 12)),
                         dtype=torch.float32)
    kw = dict(max_iter=100, check_termination=1)
    lead = fused_rollout_plain(xs, FusedCarry.zeros(B, pp, device="cpu"),
                               pp, rollout_ops(problem, pp, device="cpu"),
                               12, **kw)
    x1, warm = lead.x_final, lead.final.carry.reset_duals()
    want = fused_solve_plain(x1, warm, pp, **kw)
    matmul = torch.matmul
    agree = {"iters_mean": float(want.stats[:, 0].mean())}
    for name, mm in (
            ("split", lambda a, b: matmul_3xtf32(a, b, matmul)),
            ("rounded", lambda a, b: matmul(a.double(), b.double()).float())):
        torch.matmul = mm
        try:
            got = fused_solve_plain(x1, warm, pp, **kw)
        finally:
            torch.matmul = matmul
        same = ((got.stats[:, 0] == want.stats[:, 0])
                & (got.stats[:, 1] == want.stats[:, 1]))
        agree[name] = {
            "share": float(same.float().mean()),
            "u_err_same_schedule": float((got.U - want.U)[same].abs().max())}
    print(json.dumps({"products": products, "counts_agree": agree}))


if __name__ == "__main__":
    main()
