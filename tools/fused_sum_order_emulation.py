#!/usr/bin/env python3
"""The fused kernels' float32 summation orders, emulated on the CPU.

    python3 tools/fused_sum_order_emulation.py [--horizon 40] [--batch 96]
        [--lanes 2] [--block 32] [--fine 4]

A cold fixed-100 solve of the quadrotor (nx=12, nu=4) at ``--horizon``,
from x0 spread by 0.05 (seeded with the horizon), run three ways in float32
and held against the float64 plain version (``ops.fused_admm.
fused_solve_plain``): the products by numpy's float32 matmul (a BLAS, as
the plain version on either device), and by the kernels' FMA chains
(``csrc/admm_iteration.cuh``): the forward product one chain per output
over its depth (in blocks as the backward's past 64 float4 steps on 4-slot
tiles, FWD_CHAIN there), the backward product's depth split over
``--lanes`` adjacent lanes (float4 steps h, h + lanes, ...) that meet in a
butterfly, each lane's part summed in one chain ("chain") or in blocks of
``--block`` float4 steps added to a running sum ("blocked", BWD_BLOCK
there; blocks of ``--fine`` steps, BWD_FINE, where a lane has more than 4
blocks, as the 4-slot register tiles past the quadrotor's N=78 sum; 0 keeps
``--block``). An FMA is emulated exactly: the product in float64 (exact for
float32 operands), the sum rounded once to float32 (so at worst a double
rounding). Prints the largest state and control error against float64 of
each. Seconds at the defaults; no GPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def fma_chain(X, W, order):
    """sum_k X[:, k] W[k] in ``order``, one float32 FMA per term."""
    acc = np.zeros((X.shape[0], W.shape[1]), np.float32)
    for k in order:
        acc = (acc.astype(np.float64)
               + X[:, k:k + 1].astype(np.float64) * W[k]).astype(np.float32)
    return acc


def kernel_product(X, W, lanes=1, block=None, fine=0):
    """The kernels' order: float4 steps split over ``lanes`` (butterfly),
    each lane's steps in one chain or in blocks of ``block`` steps (of
    ``fine`` steps where a lane has more than 4 blocks, unless 0)."""
    K = X.shape[1]
    parts = []
    for h in range(lanes):
        steps = list(range(h, -(-K // 4), lanes))
        size = len(steps) if block is None else (
            fine if fine and len(steps) > 4 * block else block)
        total = None
        for b0 in range(0, len(steps), size):
            order = [4 * q + kk for q in steps[b0:b0 + size] for kk in range(4)
                     if 4 * q + kk < K]
            part = fma_chain(X, W, order)
            total = part if total is None else (total + part).astype(
                np.float32)
        parts.append(total)
    while len(parts) > 1:
        parts = [(parts[i] + parts[i + 1]).astype(np.float32)
                 for i in range(0, len(parts), 2)]
    return parts[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--fine", type=int, default=4)
    args = ap.parse_args()
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_solve_plain, pad_problem,
    )
    from accelerated_tinympc_tpu_torch.ops.fused_admm import fold_const_d

    N, B, f64 = args.horizon, args.batch, torch.float64
    prob, cch, x0 = atm.models.quadrotor_hovering_setup(
        horizon=N, device="cpu")
    ops = lambda dt: atm.condensed_operators(cch, prob.A, prob.B, N,
                                             dtype=dt, device="cpu")
    pp64 = pad_problem(prob.to(dtype=f64), cch.to(dtype=f64), ops(f64),
                       dtype=f64, device="cpu")
    pp = pad_problem(prob, cch, ops(torch.float32), device="cpu")
    rng = np.random.default_rng(N)
    xs = x0[None] + 0.05 * rng.standard_normal((B, 12))
    ref = fused_solve_plain(torch.as_tensor(xs), FusedCarry.zeros(
        B, pp64, f64, "cpu"), pp64, max_iter=100)
    Dx, Du = N * 12, (N - 1) * 4
    Wf, Wb, Wx = (t.numpy() for t in (   # the kernels' padding dropped
        pp.W_f[:Du, :Dx + Du], pp.W_b[:Dx + Du, :Du], pp.W_x[:, :Dx + Du]))
    lo, hi, cd = pp.lo.numpy(), pp.hi.numpy(), fold_const_d(pp).numpy()
    F = np.float32
    for label, fwd, bwd in (
            ("blas", lambda X: X @ Wf, lambda S: S @ Wb),
            ("chain", lambda X: kernel_product(X, Wf),
             lambda S: kernel_product(S, Wb, args.lanes)),
            ("blocked", lambda X: kernel_product(
                X, Wf, 1, args.block if -(-Du // 4) > 64 else None),
             lambda S: kernel_product(S, Wb, args.lanes, args.block,
                                      args.fine))):
        x32 = xs.astype(F)
        Xb = (x32 @ Wx).astype(F) if label == "blas" else kernel_product(
            x32, Wx)
        D = np.zeros((B, Du), F)
        Y = np.zeros((B, Dx + Du), F)
        for it in range(100):
            XU = (Xb + fwd(D)).astype(F)
            t = (XU + Y).astype(F)
            z = np.minimum(np.maximum(t, lo), hi).astype(F)
            Y = (t - z).astype(F)
            if it < 99:
                D = (bwd((z - Y).astype(F)) + cd).astype(F)
        print(f"{label:8s} N={N} lanes={args.lanes} block={args.block} "
              f"fine={args.fine}: "
              f"max|X - X64| {np.abs(XU[:, :Dx] - ref.X.numpy()).max():.3e}"
              f"  max|U - U64| {np.abs(XU[:, Dx:] - ref.U.numpy()).max():.3e}")


if __name__ == "__main__":
    main()
