#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, drives the port's main path
(batched fused MPC on the quadrotor, nx=12, nu=4, N=10) through ``TinyMPC``
at batch 65,536, and checks two batch-1 missions against the golden
trajectories of the compiled C++ reference. Every phase prints one JSON line;
the last line is ``{"ok": true, "device": {...}}``. Any failed check raises,
so the exit code is non-zero and no result line is printed. Without a CUDA
device the script exits non-zero at once.

Imports the port only (``accelerated_tinympc_tpu_torch``), never JAX.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"

# Published peaks of one H100 SXM (NVIDIA data sheet): FP32 outside the
# tensor cores, and HBM3 bandwidth. The kernels are FP32-FMA work.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

VAL_TOL = 1e-4   # controls and what warm-starts them (U, D, Z, us, x_final)
                 # kernel vs plain, and u0 vs the golden CSVs
# States, their slacks and the duals (X, V, G, Y): states reach 5 and the
# duals integrate the slack error, so 100 cold float32 iterations leave each
# of two float32 implementations ~8e-5 from the float64 result (measured,
# field "err_vs_float64_plain") and up to twice that from each other. The
# JAX package's own tests hold states at 2e-4 (tests/test_fused.py).
STATE_TOL = 2e-4
STATE_FIELDS = ("X", "V", "G", "Y")
RES_RTOL, RES_ATOL = 1e-3, 1e-6   # residual columns of the stats
AGREE_SOLVE = 0.99     # share of instances with equal iteration counts
AGREE_MISSION = 0.95   # share of instance-ticks, over a whole mission
MAIN_BATCH = 65536
KERNEL_BATCH = 4099  # 4096 plus a ragged edge


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn`` by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_err(a: torch.Tensor, b: torch.Tensor, rows=None) -> float:
    if rows is not None:
        a, b = a[rows], b[rows]
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


# ------------------------------------------------------------ comparisons --

def _bars(name, errs, agree, worst, block, extra=(), min_agree=AGREE_SOLVE):
    """Failures of one case against the stated bars (empty when it passes)."""
    fails = list(extra)
    if agree < min_agree:
        fails.append(
            f"{name}: iteration counts agree on {agree:.4f} < {min_agree}")
    if worst > block:
        fails.append(f"{name}: iteration counts off by {worst} > {block}")
    for k, e in errs.items():
        tol = STATE_TOL if k in STATE_FIELDS else VAL_TOL
        if not (np.isfinite(e) and e <= tol):
            fails.append(f"{name}: {k} max-abs err {e} > {tol}")
    return fails


def compare_solve(name, got, want, check_every, rho, ref64=None):
    """Kernel result vs plain result of one solve. Values are compared on
    the instances whose iteration counts agree: FMA contraction and
    summation order differ between nvcc and the plain products, so an
    instance whose residual sits on the tolerance can freeze one check
    later, and then returns a different (equally valid) iterate."""
    it_g, it_w = got.stats[:, 0], want.stats[:, 0]
    same = it_g == it_w
    agree = float(same.float().mean())
    worst = float((it_g - it_w).abs().max())
    errs = {"U": max_err(got.U, want.U, same), "X": max_err(got.X, want.X, same)}
    for k in ("D", "Y", "G", "Z", "V"):
        errs[k] = max_err(getattr(got.carry, k), getattr(want.carry, k), same)
    extra = []
    if not bool((got.stats[:, 1] == want.stats[:, 1])[same].all()):
        extra.append(f"{name}: solved flags disagree")
    # Residual columns: rtol 1e-3 + atol 1e-6 of their own, plus what the
    # iterates' measured disagreement e allows: a residual is max|a - b| of
    # two iterates (times rho for the dual ones), so it may move by
    # 2 * max(1, rho) * e.
    rg, rw = got.stats[same][:, 2:].double(), want.stats[same][:, 2:].double()
    res_abs = float((rg - rw).abs().max()) if rg.numel() else 0.0
    res_excess = float(((rg - rw).abs() - RES_RTOL * rw.abs()).max()) \
        if rg.numel() else 0.0
    res_bar = RES_ATOL + 2.0 * max(1.0, rho) * max(errs.values())
    if not res_excess <= res_bar:
        extra.append(f"{name}: residual columns off by {res_abs} "
                     f"(excess over rtol {res_excess} > {res_bar})")
    vs64 = {}
    if ref64 is not None:
        ok = same & (ref64.stats[:, 0] == it_g)
        for label, r in (("kernel", got), ("plain_f32", want)):
            vs64[label] = max(
                [max_err(r.U, ref64.U, ok), max_err(r.X, ref64.X, ok)]
                + [max_err(getattr(r.carry, k), getattr(ref64.carry, k), ok)
                   for k in ("D", "Y", "G", "Z", "V")])
    for label, e in vs64.items():
        if label == "kernel" and not e <= STATE_TOL:
            extra.append(f"{name}: kernel is {e} from the float64 plain version")
    return {"case": name, "max_abs_err": max(errs.values()), "errs": errs,
            "err_vs_float64_plain": vs64,
            "res_abs_err": res_abs, "res_excess": res_excess,
            "iters_agree": agree, "iters_worst": worst,
            "iters_mean": float(it_g.mean()),
            "failures": _bars(name, errs, agree, worst,
                              max(check_every, 1), extra)}


def compare_rollout(name, got, want, check_every, tol=1e-3):
    """Kernel mission vs plain mission. One shifted check changes that
    tick's iterate, and through the warm start the schedule of the ticks
    after it, so disagreements compound over a mission: the count bars are
    held per instance-tick as for one solve, but with AGREE_MISSION and
    three check blocks, and the controls of *all* instances must agree to
    2 * tol (an early exit only promises its tolerance)."""
    it_g, it_w = got.iters, want.iters
    agree = float((it_g == it_w).float().mean())
    worst = int((it_g - it_w).abs().max())
    # An instance with one shifted check differs in that tick's iterate and
    # is pulled back by the next ticks; values are held on the instances
    # whose whole schedule agrees.
    same = (it_g == it_w).all(dim=0)
    errs = {
        "us": max_err(got.us[:, same], want.us[:, same]),
        "x_final": max_err(got.x_final, want.x_final, same),
        "U": max_err(got.final.U, want.final.U, same),
        "X": max_err(got.final.X, want.final.X, same),
    }
    for k in ("D", "Y", "G", "Z", "V"):
        errs[k] = max_err(
            getattr(got.final.carry, k), getattr(want.final.carry, k), same)
    us_all = max_err(got.us, want.us)
    extra = []
    if check_every > 0 and not us_all <= 2 * tol:
        extra.append(f"{name}: controls of all instances off by {us_all}")
    return {"case": name, "max_abs_err": max(errs.values()),
            "us_err_all_instances": us_all,
            "iters_agree": agree, "iters_worst": worst,
            "instances_same_schedule": float(same.float().mean()),
            "iters_mean": float(it_g.float().mean()),
            "failures": _bars(name, errs, agree, worst,
                              3 * max(check_every, 1), extra,
                              min_agree=AGREE_MISSION)}


def raise_failures(cases) -> None:
    fails = [f for c in cases for f in c["failures"]]
    if fails:
        raise AssertionError("; ".join(fails))


# ----------------------------------------------------------------- bounds --

def solve_bound(dims, iters_total: float, n_solves: float, batch: int,
                ticks: int = 0):
    """Least time the card could take: the larger of bytes / memory rate
    (each input read once, each output written once) and operations / FP32
    peak. ``iters_total`` is the sum over instances (and ticks) of the
    iterations this run's data needed; ``n_solves`` counts the hoisted x0
    products."""
    nx, nu, N = dims
    Dx, Du = N * nx, (N - 1) * nu
    flops = iters_total * 2 * (Du * Dx + Du * Du + Dx * Du + Du * Du)
    flops += n_solves * 2 * nx * (Dx + Du)
    flops += n_solves * 2 * nx * (nx + nu) if ticks else 0
    carry_in = nx + 3 * Du + 2 * Dx if not ticks else nx + 2 * Du + Dx
    out = 4 * Du + 3 * Dx + 6 + (ticks * (nu + 1) + nx if ticks else 0)
    operators = 2 * Du * (Dx + Du) + nx * (Dx + Du) + 2 * (Dx + Du) + Du
    nbytes = 4 * (batch * (carry_in + out) + operators + ticks * Du)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device: "
                 "torch.cuda.is_available() is False")
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.ops import _build, fused_admm
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_rollout, fused_rollout_plain, fused_solve,
        fused_solve_plain, pad_problem, rollout_const_seq, rollout_ops,
    )

    t_start = time.perf_counter()
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", kind=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---------------------------------------------------------------- build
    _build.build_all()
    ptxas = [ln.strip() for ln in _build.build_log("fused_admm").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(_build.last_build_seconds, 2), ptxas=ptxas)

    # -------------------------------------------------------------- kernels
    def flagship(batch, seed=0, spread=0.05):
        problem, cache, x0 = atm.models.quadrotor_hovering_setup(device=dev)
        ops = atm.condensed_operators(
            cache, problem.A, problem.B, problem.horizon, device=dev)
        pp = pad_problem(problem, cache, ops, device=dev)
        rng = np.random.default_rng(seed)
        x0s = torch.as_tensor(
            x0[None] + spread * rng.standard_normal((batch, 12)),
            dtype=torch.float32, device=dev)
        return problem, cache, pp, x0s

    cases = []
    problem, cache, pp, x0s = flagship(KERNEL_BATCH)
    B = KERNEL_BATCH
    cold = FusedCarry.zeros(B, pp, device=dev)

    f64 = torch.float64
    pp64 = pad_problem(problem.to(dtype=f64), cache.to(dtype=f64),
                       atm.condensed_operators(
                           cache, problem.A, problem.B, problem.horizon,
                           dtype=f64, device=dev), dtype=f64, device=dev)

    def plain64(xs, cy, **kw):
        return fused_solve_plain(
            xs.double(), FusedCarry(*(t.double() for t in cy)), pp64, **kw)

    kw = dict(max_iter=100, check_termination=0)
    k1 = fused_solve(x0s, cold, pp, **kw)
    cases.append(compare_solve(
        "K1 fixed-100 cold", k1, fused_solve_plain(x0s, cold, pp, **kw), 0,
        pp.rho_f, plain64(x0s, cold, **kw)))
    # Warm start: measurement and carried slacks after a 12-tick mission,
    # where the early exit really ends solves at different iterations.
    rops = rollout_ops(problem, pp, device=dev)
    lead = fused_rollout(x0s, cold, pp, rops, 12, max_iter=100,
                         check_termination=1)
    x1, warm = lead.x_final, lead.final.carry.reset_duals()
    for check in (1, 10):
        for label, xs, cy in (("cold", x0s, cold), ("warm", x1, warm)):
            kw = dict(max_iter=100, check_termination=check,
                      abs_pri_tol=1e-3, abs_dua_tol=1e-3)
            cases.append(compare_solve(
                f"K2 adaptive check={check} {label}",
                fused_solve(xs, cy, pp, **kw),
                fused_solve_plain(xs, cy, pp, **kw), check, pp.rho_f,
                plain64(xs, cy, **kw)))
    kw = dict(max_iter=100, check_termination=5, warmup_iters=7, alpha=1.6)
    cases.append(compare_solve(
        "K2 adaptive check=5 warmup=7 alpha=1.6",
        fused_solve(x0s, cold, pp, **kw),
        fused_solve_plain(x0s, cold, pp, **kw), 5, pp.rho_f,
        plain64(x0s, cold, **kw)))

    for label, kw in (
            ("fixed-50", dict(max_iter=50, check_termination=0)),
            ("adaptive", dict(max_iter=100, check_termination=1))):
        got = fused_rollout(x0s, cold, pp, rops, 70, **kw)
        want = fused_rollout_plain(x0s, cold, pp, rops, 70, **kw)
        cases.append(compare_rollout(
            f"K3 70 ticks hovering {label}", got, want,
            kw["check_termination"]))
    # The float64 plain mission as arbiter of the adaptive schedule: the
    # kernel may not stray from it further than the float32 plain version.
    ref64 = fused_rollout_plain(
        x0s.double(), FusedCarry.zeros(B, pp64, f64, dev), pp64,
        rollout_ops(problem, pp64, f64, dev), 70, **kw)
    agree_k = float((got.iters == ref64.iters).float().mean())
    agree_p = float((want.iters == ref64.iters).float().mean())
    cases.append({
        "case": "K3 adaptive schedule vs float64 plain",
        "kernel_agree": agree_k, "plain_f32_agree": agree_p,
        "failures": [] if agree_k >= agree_p - 0.02 else [
            f"kernel agrees with the float64 schedule on {agree_k}, "
            f"the float32 plain version on {agree_p}"]})

    tproblem, tcache, tx0, Xref_total = atm.models.quadrotor_tracking_setup(
        device=dev)
    tops = atm.condensed_operators(
        tcache, tproblem.A, tproblem.B, tproblem.horizon, device=dev)
    tpp = pad_problem(tproblem, tcache, tops, device=dev)
    rng = np.random.default_rng(1)
    tx0s = torch.as_tensor(
        tx0[None] + 0.02 * rng.standard_normal((B, 12)),
        dtype=torch.float32, device=dev)
    cs = rollout_const_seq(tpp, tproblem.Q, tcache.Pinf, Xref_total, 70)
    trops = rollout_ops(tproblem, tpp, device=dev)
    kw = dict(max_iter=100, check_termination=1, const_seq=cs)
    cases.append(compare_rollout(
        "K3 70 ticks tracking adaptive",
        fused_rollout(tx0s, cold, tpp, trops, 70, **kw),
        fused_rollout_plain(tx0s, cold, tpp, trops, 70, **kw), 1))

    # A non-flagship shape: nx=6, nu=8, N=12 (Du=88).
    rproblem, rrho = atm.models.random_lti_problem(3, 6, 8, 12, device=dev)
    rcache = atm.riccati_cache(
        rproblem.A, rproblem.B, rproblem.Q, rproblem.R, rrho, device=dev)
    rops_c = atm.condensed_operators(rcache, rproblem.A, rproblem.B, 12,
                                     device=dev)
    rpp = pad_problem(rproblem, rcache, rops_c, device=dev)
    rng = np.random.default_rng(2)
    rB = 1027
    rx0 = torch.as_tensor(rng.standard_normal((rB, 6)), dtype=torch.float32,
                          device=dev)
    rcold = FusedCarry.zeros(rB, rpp, device=dev)
    kw = dict(max_iter=60, check_termination=0)
    cases.append(compare_solve(
        "K1 random_lti 6/8/12 fixed-60", fused_solve(rx0, rcold, rpp, **kw),
        fused_solve_plain(rx0, rcold, rpp, **kw), 0, rpp.rho_f))
    kw = dict(max_iter=100, check_termination=1)
    cases.append(compare_solve(
        "K2 random_lti 6/8/12 adaptive", fused_solve(rx0, rcold, rpp, **kw),
        fused_solve_plain(rx0, rcold, rpp, **kw), 1, rpp.rho_f))
    rrops = rollout_ops(rproblem, rpp, device=dev)
    cases.append(compare_rollout(
        "K3 random_lti 6/8/12 12 ticks adaptive",
        fused_rollout(rx0, rcold, rpp, rrops, 12, **kw),
        fused_rollout_plain(rx0, rcold, rpp, rrops, 12, **kw), 1))
    torch.cuda.synchronize()
    emit("kernels", batch=B, cases=cases)
    raise_failures(cases)

    # Each kernel at the main path's shapes: error, time, plain time, bound.
    problem, cache, pp, x0s = flagship(MAIN_BATCH)
    rops = rollout_ops(problem, pp, device=dev)
    cold = FusedCarry.zeros(MAIN_BATCH, pp, device=dev)
    dims = pp.dims
    kernels = []

    def kernel_row(name, replaces, run_kernel, run_plain, compare, iters_of,
                   n_solves, ticks=0):
        got, want = run_kernel(), run_plain()
        cmp_ = compare(got, want)
        emit("kernel_at_main_shape", **cmp_)
        raise_failures([cmp_])
        ms = cuda_ms(run_kernel)
        plain_ms = cuda_ms(run_plain, reps=1)
        bound_ms, bound_by = solve_bound(
            dims, float(iters_of(got)), n_solves, MAIN_BATCH, ticks)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "accelerated_tinympc_tpu_torch/ops/csrc/fused_admm.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": cmp_["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "iters_mean": cmp_["iters_mean"],
        })

    kw1 = dict(max_iter=100, check_termination=0)
    kernel_row(
        "fused_solve_fixed",
        "accelerated_tinympc_tpu/ops/fused_admm.py:672",
        lambda: fused_solve(x0s, cold, pp, **kw1),
        lambda: fused_solve_plain(x0s, cold, pp, **kw1),
        lambda g, w: compare_solve("K1 main shape", g, w, 0, pp.rho_f),
        lambda g: g.stats[:, 0].sum(), MAIN_BATCH)
    kw2 = dict(max_iter=100, check_termination=1)
    lead = fused_rollout(x0s, cold, pp, rops, 12, **kw2)
    x1, warm = lead.x_final, lead.final.carry.reset_duals()
    kernel_row(
        "fused_solve_adaptive",
        "accelerated_tinympc_tpu/ops/fused_admm.py:740",
        lambda: fused_solve(x1, warm, pp, **kw2),
        lambda: fused_solve_plain(x1, warm, pp, **kw2),
        lambda g, w: compare_solve("K2 main shape", g, w, 1, pp.rho_f),
        lambda g: g.stats[:, 0].sum(), MAIN_BATCH)
    kernel_row(
        "fused_rollout",
        "accelerated_tinympc_tpu/ops/fused_rollout.py:125",
        lambda: fused_rollout(x0s, cold, pp, rops, 70, **kw2),
        lambda: fused_rollout_plain(x0s, cold, pp, rops, 70, **kw2),
        lambda g, w: compare_rollout("K3 main shape", g, w, 1),
        lambda g: g.iters.sum(), 70 * MAIN_BATCH, ticks=70)

    # ------------------------------------------------------------ main path
    def solver():
        prob, cch, x0 = atm.models.quadrotor_hovering_setup()
        mpc = atm.TinyMPC.from_parts(
            prob, cch, tier="fused", batch=MAIN_BATCH,
            settings=atm.Settings(max_iter=100, check_termination=0))
        rng = np.random.default_rng(0)
        mpc.set_x0(x0[None] + 0.05 * rng.standard_normal((MAIN_BATCH, 12)))
        return mpc

    def timed(fn):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn()
        t1.record()
        torch.cuda.synchronize()
        return out, t0.elapsed_time(t1)

    solver().solve()  # warm-up: operators on the card, library loaded
    fused_admm.reset_launch_counts()
    steps = {}

    def step(name, fn, n_solves):
        out, ms = timed(fn)
        steps[name] = {"ms": ms, "solves_per_s": n_solves / ms * 1e3}
        return out

    mpc = solver()
    step("solve_fixed100", mpc.solve, MAIN_BATCH)
    u_fixed = mpc.get_u()
    mpc.settings = mpc.settings.replace(check_termination=1)
    first = step("solve_adaptive_after_fixed", mpc.solve, MAIN_BATCH)
    mpc.reset_duals()
    xf_k, us_k = step("rollout70_in_kernel",
                      lambda: mpc.rollout(70, in_kernel=True), 70 * MAIN_BATCH)
    xf_l, us_l = step("rollout10_tick_loop",
                      lambda: mpc.rollout(10, in_kernel=False), 10 * MAIN_BATCH)
    mpc.reset_duals()
    stats_adapt = step("solve_adaptive_warm", mpc.solve, MAIN_BATCH)
    u_adapt, x_adapt = mpc.get_u(), mpc.get_x()
    for name, st in (("solve_adaptive_after_fixed", first),
                     ("solve_adaptive_warm", stats_adapt)):
        steps[name]["converged_fraction"] = st["converged_fraction"]
        steps[name]["iterations_mean"] = st["iterations_mean"]
    counts = dict(fused_admm.LAUNCH_COUNTS)

    for name, arr in (("u_fixed", u_fixed), ("u_adapt", u_adapt),
                      ("x_adapt", x_adapt), ("xf_k", xf_k.cpu().numpy()),
                      ("us_k", us_k.cpu().numpy()),
                      ("xf_l", xf_l.cpu().numpy()),
                      ("us_l", us_l.cpu().numpy())):
        assert np.isfinite(arr).all(), f"main path: {name} not finite"
    assert u_fixed.shape == (MAIN_BATCH, 9, 4)
    assert x_adapt.shape == (MAIN_BATCH, 10, 12)
    assert us_k.shape == (70, MAIN_BATCH, 4) and us_l.shape == (10, MAIN_BATCH, 4)
    assert stats_adapt["converged_fraction"] > 0, "no instance converged"
    for k, n in counts.items():
        assert n > 0, f"main path never launched {k}: {counts}"
    for row in kernels:
        row["launches"] = counts[row["name"]]

    # Batch-1 missions against the compiled C++ reference's trajectories:
    # columns 13:17 of the CSV are the applied u0, column 17 the iterations.
    def golden(name):
        rows = np.loadtxt(GOLDEN / f"{name}_traj.csv", delimiter=",")
        return rows[:, 13:17], rows[:, 17].astype(int)

    prob, cch, x0 = atm.models.quadrotor_hovering_setup()
    one = atm.TinyMPC.from_parts(
        prob, cch, tier="fused",
        settings=atm.Settings(max_iter=50, check_termination=0))
    one.set_x0(x0)
    _, us = one.rollout(70, in_kernel=True)
    want_u, _ = golden("hovering_fixed50")
    err_hover = float(np.abs(us.cpu().numpy() - want_u).max())
    assert err_hover <= VAL_TOL, f"hovering_fixed50 golden: {err_hover}"

    prob, cch, x0, Xref_total = atm.models.quadrotor_tracking_setup()
    golden_track = {}
    want_u, want_it = golden("tracking_adaptive")
    for in_kernel in (True, False):
        one = atm.TinyMPC.from_parts(
            prob, cch, tier="fused",
            settings=atm.Settings(max_iter=100, check_termination=1))
        one.set_x0(x0)
        _, us = one.rollout(290, Xref_total=Xref_total, in_kernel=in_kernel)
        err = float(np.abs(us.cpu().numpy() - want_u).max())
        assert err <= VAL_TOL, f"tracking_adaptive golden: {err}"
        golden_track["in_kernel" if in_kernel else "tick_loop"] = err
    emit("main_path", batch=MAIN_BATCH, steps=steps, launches=counts,
         golden_hovering_fixed50_max_err=err_hover,
         golden_tracking_adaptive_max_err=golden_track,
         seconds_total=round(time.perf_counter() - t_start, 1))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
