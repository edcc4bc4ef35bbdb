#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device, nvcc and g++

Builds the CUDA kernels from the sources in this checkout (one ``nvcc``
for each source, started together), holds each kernel against its plain PyTorch
version on the card at batch 4,099 (the heterogeneous-plant kernels also
against a float64 plain version and the plain version on the CPU, and
against the fused kernels on a fleet of identical plants), times each at
batch 65,536, drives the port's main path
(batched fused MPC on the quadrotor, nx=12, nu=4, N=10) through ``TinyMPC``
at batch 65,536, and checks two batch-1 missions against the golden
trajectories of the compiled C++ reference. The ``slots`` phase holds the
fused kernels' per-instance slots to position independence: a permuted
batch, a batch smaller than one block's slots and two launches back to back
give the same instance the same bits. The ``operators`` phase holds the two
placements of the condensed operators (shared memory, device memory) to the
same bits where both fit, and runs the quadrotor at N=20 and N=40 (past
shared memory) through ``TinyMPC(tier="fused")``. The Riccati kernels are
held at the port's sizes and at (17, 9), (24, 10), (32, 12). Then the
second path, again
through ``TinyMPC`` at batch 65,536: second-order cones inside the fused
kernels (the powered-descent lander, nx=6, nu=3, N=15), the compaction
cascade, and per-instance adaptive rho with the Riccati kernels. Then the
third: ``TinyMPCFleet`` on 65,536 perturbed quadrotors (setup, fixed and
adaptive solves, the hetero cascade, a 20-tick fleet mission, an online
plant refresh, adaptive rho with the hetero and einsum engines at 16,384).
Then the fourth, long horizons: the stream kernels at N=1024 (nx=8, nu=3)
for batches 512 and 8,192 with both compaction cascades, ``TinyMPC(tier=
"block")`` against the scan tier, and ``TinyMPCFleet`` on the hstream and
block tiers at N=256 for 8,192 perturbed quadrotors; the long-horizon
kernels are held against their plain versions at batch 1,027 first.
Then the fifth (``fifth_path``): the fused solve exported through the
``atm_torch::fused_solve`` op (K1 fixed, K2 warm) at batch 65,536, loaded
and held bit for bit against ``fused_solve``, timed beside it and traced
with ``torch.profiler``; the scan tier exported at 256; a serialization
round trip on the card; the six ``examples/torch_*.py`` at their defaults.
Then the sixth (``sixth_path``): every ``sharded_*`` entry point of the
batch mesh in a world of one over NCCL at its path's shapes, bit for bit
against the unsharded calls, with each stats dict held to its reduction;
two ranks on the one card over gloo (``--gloo-rank`` child processes,
65,536 split 32,768 + 32,768), bit for bit against the unsharded calls; the
quadrotor's generated C++ project built with g++ and run 70 ticks against
K1 and the golden CSVs; ``NativeSolver.solve_batch`` at 1,024 against the
fused tier. Each kernel row carries ``sixth_path_launches``.
Before the sixth, ``bf16x3_path``: the fused kernels' split-bf16 mode
(``algo="bf16x3"``, ``mma.sync`` bf16 products) against its plain versions,
the float32 kernels and the golden CSVs, bit for bit with the float32
kernels where no iteration splits, through ``TinyMPC(algo="bf16x3")`` at
65,536 and timed beside the float32 kernels, each row with its slots a
block (an earlier checkout's split kernels are timed in turns with these
by ``tools/torch_fused_times.py --algo bf16x3``).
Every phase prints one JSON line with the seconds since the start;
the last line is ``{"ok": true, "device": {...}}``. Any failed check raises,
so the exit code is non-zero and no result line is printed. Without a CUDA
device the script exits non-zero at once.

Imports the port only (``accelerated_tinympc_tpu_torch``), never JAX.
"""

from __future__ import annotations

import copy
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"

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


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line per phase; ``t`` is the seconds since the start."""
    print(json.dumps({"phase": phase,
                      "t": round(time.perf_counter() - T_START, 1),
                      **fields}), flush=True)


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


def timed(fn):
    """``(fn(), milliseconds)`` of one call by CUDA events."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


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


def compare_solve(name, got, want, check_every, rho, ref64=None,
                  max_iter=None):
    """Kernel result vs plain result of one solve. Values are compared on
    the instances whose iteration counts agree: FMA contraction and
    summation order differ between nvcc and the plain products, so an
    instance whose residual sits on the tolerance can freeze one check
    later, and then returns a different (equally valid) iterate.

    Where the counts agree the solved flags must agree too, with one
    exception when ``max_iter`` is given: an instance that converges at the
    check on the last iteration in one version and runs to the cap in the
    other reports ``max_iter`` in both, with another result (the snapshot
    against the live iterate); such instances count as a schedule
    disagreement and their values are not compared."""
    it_g, it_w = got.stats[:, 0], want.stats[:, 0]
    flags_differ = (it_g == it_w) & (got.stats[:, 1] != want.stats[:, 1])
    at_cap = (it_g == max_iter) if max_iter is not None else \
        torch.zeros_like(flags_differ)
    same = (it_g == it_w) & ~flags_differ
    agree = float(same.float().mean())
    worst = float((it_g - it_w).abs().max())
    errs = {"U": max_err(got.U, want.U, same), "X": max_err(got.X, want.X, same)}
    for k in ("D", "Y", "G", "Z", "V"):
        errs[k] = max_err(getattr(got.carry, k), getattr(want.carry, k), same)
    flags_below_cap = int((flags_differ & ~at_cap).sum())
    hard = [f"{name}: solved flags disagree below the iteration cap on "
            f"{flags_below_cap} instances"] if flags_below_cap else []
    extra = list(hard)
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
        ok = (same & (ref64.stats[:, 0] == it_g)
              & (ref64.stats[:, 1] == got.stats[:, 1]))
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
            "hard_failures": hard,
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


CARRY_FIELDS = ("D", "Y", "G", "Z", "V")


def solve_fields(r):
    """The compared fields of a solve result, a row per instance."""
    return dict(U=r.U, X=r.X, **{k: getattr(r.carry, k) for k in CARRY_FIELDS})


def solve_sched(r):
    """A solve's schedule per instance: its count and its solved flag."""
    return r.stats[:, :2]


# The split-bf16 kernels' rule (rule="split" below): the kernel's products
# round in the tensor cores, so its errors are a third sample of the
# float32 noise that the two plain versions show, not a subset of it.
SPLIT_Q = 0.99           # the quantile of per-instance errors held ...
SPLIT_Q_MARGIN = 1.25    # ... within this of the larger plain version's
SPLIT_MAX_MARGIN = 3.5   # the largest error, likewise (or the bar)
# Both set between the sound kernel's readings and those of planted faults
# (tools/torch_bf16x3_faults.py; PERF.md §6): 0.99-quantile ratios
# 0.99-1.13 sound, 1.36-11 with no split iteration; largest-error ratios
# up to 3.03 sound, 4.05 with the sums running inside the tensor cores
# (there under the absolute bar, which the margin never lowers).


def arbitrate(case, got, want, ref64, plain_cpu, block, rule="spread",
              fields=solve_fields, sched=solve_sched):
    """The float64 arbiter of ``case`` (``compare_solve`` or
    ``compare_rollout`` of the kernel ``got`` against another float32
    version ``want`` on the card) where the case misses its bars.
    ``ref64`` is the float64 plain version (or a callable run only here),
    ``plain_cpu()`` the float32 plain version on the CPU. On the instances
    whose schedule (``sched(r)``, a row per instance) equals float64's in
    the kernel and both float32 versions, each field (``fields(r)``)
    passes, by ``rule``:

    * ``"spread"``: no further from float64 than the bar or the further
      of the two float32 versions (the kernel inside their spread);
    * ``"split"`` (the split-bf16 kernels): the SPLIT_Q quantile of the
      kernel's per-instance errors within SPLIT_Q_MARGIN of the larger
      float32 version's (no systematic loss of accuracy) and its largest
      error within the bar or SPLIT_MAX_MARGIN times the larger float32
      version's (the largest error over 4,099 instances sits on the few
      whose rounding the iteration amplifies most, or on a slack at a
      cone's or a bound's edge, a different instance in each version);
      and at least half the instances compared.

    Either way the kernel's schedule agrees with float64 no less than
    ``want``'s minus 1 point and never strays from it by more than
    ``want``'s worst plus ``block`` iterations; solved flags that disagree
    below the cap (``hard_failures``) fail."""
    if not case["failures"]:
        case["held_by"] = "kernel_vs_f32"
        return case
    name = case["case"]
    cpu = plain_cpu()
    r64 = ref64() if callable(ref64) else ref64
    fk, fw, fc, f64 = (fields(r) for r in (got, want, cpu, r64))
    dev = next(iter(fk.values())).device
    sk, sw, sc, s64 = (sched(r).to(dev).double()
                       for r in (got, want, cpu, r64))
    ok_k = (sk == s64).all(dim=1)
    ok_w = (sw == s64).all(dim=1)
    every = ok_k & ok_w & (sc == s64).all(dim=1)
    arb = {"agree_f64": {"kernel": float(ok_k.float().mean()),
                         "other_f32": float(ok_w.float().mean())},
           "worst_vs_f64": {"kernel": float((sk - s64).abs().max()),
                            "other_f32": float((sw - s64).abs().max())},
           "compared_share": float(every.float().mean()), "err_vs_f64": {}}
    if rule == "split":
        arb[f"q{SPLIT_Q}_vs_f64"], arb["rms_vs_f64"] = {}, {}
    fails = list(case.get("hard_failures", []))

    def per_instance(a, b):
        return (a[every].double() - b[every].double()).abs().flatten(1).amax(
            dim=1)

    for k in fk:
        f64k = f64[k].to(dev)
        ek, ew, ec = (max_err(f[k].to(dev), f64k, every) for f in (fk, fw, fc))
        arb["err_vs_f64"][k] = {"kernel": ek, "other_f32": ew,
                                "plain_f32_cpu": ec}
        tol = STATE_TOL if k in STATE_FIELDS else VAL_TOL
        if rule == "spread":
            bar = max(tol, ew, ec)
        else:
            bar = max(tol, SPLIT_MAX_MARGIN * max(ew, ec))
            per = [per_instance(f[k].to(dev), f64k) for f in (fk, fw, fc)]
            qk, qw, qc = (float(torch.quantile(d, SPLIT_Q)) if d.numel()
                          else 0.0 for d in per)
            arb[f"q{SPLIT_Q}_vs_f64"][k] = {
                "kernel": qk, "other_f32": qw, "plain_f32_cpu": qc}
            arb["rms_vs_f64"][k] = dict(zip(
                ("kernel", "other_f32", "plain_f32_cpu"),
                (float((f[k].to(dev)[every].double() - f64k[every].double())
                       .pow(2).mean().sqrt()) if int(every.sum()) else 0.0
                 for f in (fk, fw, fc))))
            if not qk <= SPLIT_Q_MARGIN * max(qw, qc):
                fails.append(f"{name}: {k} {SPLIT_Q} quantile {qk} from "
                             f"float64 > {SPLIT_Q_MARGIN} x {max(qw, qc)}")
        if not ek <= bar:
            fails.append(f"{name}: {k} {ek} from float64 > {bar}")
    if arb["agree_f64"]["kernel"] < arb["agree_f64"]["other_f32"] - 0.01:
        fails.append(f"{name}: schedule agrees with float64 on "
                     f"{arb['agree_f64']}")
    if arb["worst_vs_f64"]["kernel"] > (arb["worst_vs_f64"]["other_f32"]
                                        + block):
        fails.append(f"{name}: counts off float64 by {arb['worst_vs_f64']}")
    if rule == "split" and not arb["compared_share"] >= 0.5:
        fails.append(f"{name}: float64 schedule shared by "
                     f"{arb['compared_share']} of the instances")
    case["arbiter_float64"] = arb
    case["bars_kernel_vs_f32"] = case["failures"]
    case["held_by"] = "float64_arbiter"
    case["failures"] = fails
    return case


def arbitrated(name, got, want, ref64, check, rho, plain_cpu,
               max_iter=100):
    """``arbitrate`` of one solve by the spread rule: ``got`` (a kernel)
    against ``want`` (another float32 version on the card) on the bars of
    ``compare_solve``, the float64 plain version ``ref64`` arbitrating."""
    return arbitrate(compare_solve(name, got, want, check, rho,
                                   max_iter=max_iter),
                     got, want, ref64, plain_cpu, max(check, 1))


def raise_failures(cases) -> None:
    fails = [f for c in cases for f in c["failures"]]
    if fails:
        raise AssertionError("; ".join(fails))


# -------------------------------------------------------------- workloads --
# The fused kernels' workloads, shared with tools/torch_fused_times.py and
# tools/torch_kernel_sweep.py. The builders import the package when called,
# so a tool can build them against another checkout's package.

WARM_KW = dict(max_iter=100, check_termination=1)   # K2's and K3's solves
LANDER_TOL = dict(abs_pri_tol=1e-2, abs_dua_tol=1e-2)
LANDER_FIXED = dict(max_iter=100, check_termination=0)                  # K4 a
LANDER_ADAPTIVE = dict(max_iter=300, check_termination=2, **LANDER_TOL)  # K4 b
LANDER_MISSION = dict(max_iter=100, check_termination=2, **LANDER_TOL)   # K4 c


def flagship(batch, dev, seed=0, spread=0.05, horizon=10):
    """The quadrotor (nx=12, nu=4, N=10, or ``horizon``): ``(problem, cache,
    padded operators, batch x0 spread around its nominal x0)``."""
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.ops import pad_problem

    problem, cache, x0 = atm.models.quadrotor_hovering_setup(
        horizon=horizon, device=dev)
    ops = atm.condensed_operators(
        cache, problem.A, problem.B, problem.horizon, device=dev)
    pp = pad_problem(problem, cache, ops, device=dev)
    rng = np.random.default_rng(seed)
    x0s = torch.as_tensor(
        x0[None] + spread * rng.standard_normal((batch, 12)),
        dtype=torch.float32, device=dev)
    return problem, cache, pp, x0s


def warm_start(problem, pp, x0s, dev):
    """K2's workload: the measurement and carried slacks after a 12-tick
    adaptive mission from cold, duals reset, where the early exit really
    ends solves at different iterations. Returns ``(x1, carry)``."""
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_rollout, rollout_ops,
    )

    cold = FusedCarry.zeros(x0s.shape[0], pp, device=dev)
    lead = fused_rollout(x0s, cold, pp, rollout_ops(problem, pp, device=dev),
                         12, **WARM_KW)
    return lead.x_final, lead.final.carry.reset_duals()


def lander(batch, dev, seed=0):
    """The powered-descent lander of examples/torch_soc_landing.py (nx=6,
    nu=3, N=15): ``(problem, cache, padded operators, batch x0)``."""
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.ops import pad_problem

    I3 = np.eye(3)
    A = np.block([[I3, 0.1 * I3], [0 * I3, I3]])
    Bm = np.vstack([0.005 * I3, 0.1 * I3])
    Q = np.concatenate([np.full(3, 10.0), np.full(3, 1.0)])
    mpc = atm.TinyMPC.setup(
        A, Bm, Q, np.full(3, 1.0), 1.0, 15, u_min=-10.0, u_max=10.0,
        x_min=-100.0, x_max=100.0, device=dev)
    lops = atm.condensed_operators(
        mpc.cache, mpc.problem.A, mpc.problem.B, 15, device=dev)
    lpp = pad_problem(mpc.problem, mpc.cache, lops, device=dev)
    rng = np.random.default_rng(seed)
    base = np.asarray([3.0, -2.0, 6.0, 1.0, 0.5, -1.0])
    xs = torch.as_tensor(base[None] + 0.3 * rng.standard_normal((batch, 6)),
                         dtype=torch.float32, device=dev)
    return mpc.problem, mpc.cache, lpp, xs


def lander_cones():
    """The lander's thrust-tilt input cone and glideslope state cone."""
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    tilt = Cone(ball=(0, 1), axis=2, mu=1.0, shift=3.0)    # thrust tilt
    glide = Cone(ball=(0, 1), axis=2, mu=2.0, shift=0.1)   # glideslope
    return ConeSet(input_cones=(tilt,), state_cones=(glide,))


def robust_family(batch, seed=0, spread=0.03, dev="cuda"):
    """The robust sweep's family (examples/robust_plant_sweep.py): the
    quadrotor's plant perturbed elementwise by ``spread``, instance 0
    nominal. Returns ``(batch-leading problem, rho (B,), x0s)``, the x0s
    around the hover reference: the cold solves from the nominal x0 need
    more than 100 iterations, these exit at different ones."""
    import accelerated_tinympc_tpu_torch as atm

    prob, cch, x0 = atm.models.quadrotor_hovering_setup(device=dev)
    rng = np.random.default_rng(seed)
    A0 = prob.A.double().cpu().numpy()
    B0 = prob.B.double().cpu().numpy()
    mulA = 1.0 + spread * rng.standard_normal((batch, 12, 12))
    mulB = 1.0 + spread * rng.standard_normal((batch, 12, 4))
    mulA[0] = 1.0
    mulB[0] = 1.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    wide = lambda a: a.expand((batch,) + tuple(a.shape)).contiguous()
    prob_b = atm.Problem(**{k: wide(v) for k, v in prob.tensors().items()})
    prob_b = prob_b.replace(A=t(A0[None] * mulA), B=t(B0[None] * mulB))
    rho = torch.full((batch,), float(cch.rho), device=dev)
    x0s_ = t(prob.Xref[0].cpu().numpy()[None]
             + 0.2 * rng.standard_normal((batch, 12)))
    return prob_b, rho, x0s_


def long_plant(N, knot=False, dev="cuda"):
    """examples/torch_long_horizon.py's plant (random_lti seed 0, nx=8,
    nu=3, |u| <= 3, |x| <= 30); ``knot``: the input bound tightens from
    4.5 to 1.5 over the horizon."""
    import accelerated_tinympc_tpu_torch as atm

    prob, rho = atm.models.random_lti_problem(0, 8, 3, N, device=dev)
    if knot:
        lim = prob.u_max * torch.linspace(
            1.5, 0.5, N - 1, device=dev)[:, None]
        prob = prob.replace(u_min=-lim, u_max=lim)
    cch = atm.riccati_cache(prob.A, prob.B, prob.Q, prob.R, rho, device=dev)
    return prob, cch


def at_horizon(prob_b, N):
    """A batch-leading problem of uniform bounds and reference carried to
    horizon N (its first knot's rows repeated)."""
    Bn = prob_b.A.shape[0]
    rows = lambda a, k: a[:, :1].expand(Bn, k, a.shape[-1]).contiguous()
    return prob_b.replace(
        u_min=rows(prob_b.u_min, N - 1), u_max=rows(prob_b.u_max, N - 1),
        x_min=rows(prob_b.x_min, N), x_max=rows(prob_b.x_max, N),
        Xref=rows(prob_b.Xref, N), Uref=rows(prob_b.Uref, N - 1))


def ptxas_per_kernel(log: str) -> list:
    """Registers, spills and static shared memory of each kernel, from the
    ``-Xptxas -v`` lines of one build log."""
    import re

    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", ln)
        if m and "Compiling" in ln:
            name = m.group(1)
            short = re.search(r"atm(?:_[a-z]+)?\d+(\w+?_kernel)(I\w*E)?",
                              name)
            label = name
            if short:   # template arguments (placement, shape) as <...>
                args = re.findall(r"L[ib](\d+)E", short.group(2) or "")
                label = short.group(1) + (f"<{','.join(args)}>" if args else "")
            cur = {"kernel": label}
            rows.append(cur)
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("stack_bytes", r"(\d+) bytes stack frame"),
                         ("smem_static", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if m:
                cur[key] = int(m.group(1))
    return rows


def cone_excess(W, cone, mu=None, shift=None):
    """Worst violation ``||w[ball]|| - mu (w[axis] + shift)`` of per-knot
    vectors ``W (B, K, dim)``; ``mu``/``shift`` ``(B,)`` override the cone's
    values per instance."""
    v = W[..., list(cone.ball)]
    a = torch.sqrt((v * v).sum(dim=-1))
    mu = cone.mu if mu is None else mu[:, None]
    shift = cone.shift if shift is None else shift[:, None]
    return float((a - mu * (W[..., cone.axis] + shift)).max())


CONE_TOL = 1e-5   # every final slack satisfies every cone to this


# The robust sweep's closed loop on the card against its plain versions
# (K5/K7 against the float32 plain Riccati and hetero solve, sums in
# another order, over 80 ticks of 50 iterations), on the values it prints
# to 4 decimals.
ROBUST_TOL = 1e-3


def floats_in(line: str) -> list[float]:
    """The decimal numbers in a printed line, in order."""
    return [float(v) for v in re.findall(r"-?\d+\.\d+", line)]


def run_example(name: str, *args: str) -> tuple[list[str], str | None]:
    """``examples/<name>`` in this process (``runpy``) with ``args``: its
    printed lines and the message of the AssertionError it raised, if any
    (the examples end on their own checks). The CPU tests run the examples
    through here too."""
    import contextlib
    import io
    import runpy

    argv, out, failed = sys.argv, io.StringIO(), None
    try:
        sys.argv = [name, *args]
        with contextlib.redirect_stdout(out):
            try:
                runpy.run_path(str(ROOT / "examples" / name),
                               run_name="__main__")
            except AssertionError as e:
                failed = str(e)
    finally:
        sys.argv = argv
    return out.getvalue().splitlines(), failed


def fifth_path(dev: str = "cuda") -> dict:
    """The utilities, AOT export and the examples at full width: the fused
    solve (K1 fixed 100 cold, K2 check 1 on the warm start, 65,536
    quadrotors) exported through the ``atm_torch::fused_solve`` op, saved,
    loaded and called, bit for bit against ``fused_solve`` and timed
    against it; a ``torch.profiler`` trace of one artifact call; the scan
    tier exported at 256 x 10 iterations against the live solve; a
    serialization round trip of the cache, the problem and a warm State on
    the card with a health report; the six examples at their defaults, the
    robust sweep held to its plain versions (``--cpu``) run here on the
    same inputs. Every launch count is set to 0 just before and read just
    after; raises on any failed check."""
    import shutil
    import tempfile

    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.api import (
        export_batched_solve, export_fused_solve, load_exported,
        save_exported,
    )
    from accelerated_tinympc_tpu_torch.ops import FusedCarry, fused_solve
    from accelerated_tinympc_tpu_torch.ops import fused_admm
    from accelerated_tinympc_tpu_torch.solver.batched import (
        init_state_batched, solve_batched,
    )
    from accelerated_tinympc_tpu_torch.utils import (
        debug_nans, health_report, load_like, load_problem_cache,
        save_problem_cache, save_pytree, time_fn, trace,
    )

    t_start = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="atm_fifth_path_"))
    problem, cache, pp, x0s = flagship(MAIN_BATCH, dev)
    cold = FusedCarry.zeros(MAIN_BATCH, pp, device=dev)
    x1, warm = warm_start(problem, pp, x0s, dev)
    counters = _counters()
    for c in counters:
        for k in c:
            c[k] = 0
    out = {}

    # K1/K2 through the op: export, save, load, call; bits and launches.
    artifact = {}
    for label, xs, carry, kw in (
            ("fixed100_cold", x0s, cold, dict(max_iter=100)),
            ("adaptive_warm", x1, warm, WARM_KW)):
        t0 = time.perf_counter()
        f = tmp / f"fused_{label}.pt2"
        save_exported(f, export_fused_solve(pp, MAIN_BATCH, **kw))
        solve = load_exported(f)
        export_s = time.perf_counter() - t0
        before = dict(fused_admm.LAUNCH_COUNTS)
        got = solve(xs, *carry)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in
                    fused_admm.LAUNCH_COUNTS.items() if v != before[k]}
        want = fused_solve(xs, carry, pp, **kw)
        fields = dict(U=want.U, X=want.X, stats=want.stats,
                      **want.carry._asdict())
        unequal = [k for k, v in fields.items() if not torch.equal(got[k], v)]
        kernel = ("fused_solve_adaptive" if kw.get("check_termination")
                  else "fused_solve_fixed")
        assert launched == {kernel: 1}, f"artifact {label} launched {launched}"
        assert not unequal, f"artifact {label}: {unequal} differ from fused_solve"
        t_art = time_fn(solve, xs, *carry, reps=5)
        t_dir = time_fn(lambda: fused_solve(xs, carry, pp, **kw), reps=5)
        artifact[label] = {
            "bit_exact": True, "launched": launched,
            "export_save_load_s": round(export_s, 2),
            "artifact_ms": {"best": 1e3 * t_art["best_s"],
                            "mean": 1e3 * t_art["mean_s"]},
            "fused_solve_ms": {"best": 1e3 * t_dir["best_s"],
                               "mean": 1e3 * t_dir["mean_s"]},
            "iterations_mean": float(want.stats[:, 0].mean())}
        if label == "fixed100_cold":
            fixed_solve = solve
    out["fused_artifact"] = artifact

    # One artifact call under the profiler: the kernels it names.
    from torch.autograd import DeviceType

    with trace(str(tmp / "trace")) as prof:
        fixed_solve(x0s, *cold)
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
    kernels = sorted({e.name for e in prof.events()
                      if e.device_type == DeviceType.CUDA})
    ops = sorted({e.key for e in prof.key_averages()
                  if "atm_torch" in e.key})
    files = [p.name for p in (tmp / "trace").iterdir()]
    out["profiler"] = {
        "device_kernels": kernels, "custom_ops": ops, "trace_files": files,
        "device_us": {e.key: dev_time(e) for e in prof.key_averages()
                      if dev_time(e) > 0}}
    assert any("fused_solve_fixed_kernel" in k for k in kernels), \
        f"the trace names no fused_solve_fixed_kernel: {kernels}"

    # The scan tier's artifact at 256 x 10 iterations against the live
    # solve_batched.
    n, settings = 256, atm.Settings(max_iter=10, check_termination=0)
    t0 = time.perf_counter()
    f = tmp / "scan.pt2"
    save_exported(f, export_batched_solve(problem, cache, settings, n))
    scan = load_exported(f)
    scan_export_s = time.perf_counter() - t0
    got = scan(x0s[:n].contiguous())
    st = init_state_batched(n, 12, 4, 10, device=dev)
    x = st.x.clone()
    x[:, 0, :] = x0s[:n]
    live = solve_batched(st.replace(x=x), problem, cache, settings)
    names = {"iterations": "iter"}
    scan_err = {k: max_err(v, getattr(live, names.get(k, k)))
                for k, v in got.items()}
    scan_exact = all(torch.equal(v, getattr(live, names.get(k, k)))
                     for k, v in got.items())
    assert scan_exact, f"scan artifact against the live solve: {scan_err}"
    out["scan_artifact"] = {"batch": n, "iters": 10, "bit_exact": scan_exact,
                            "export_save_load_s": round(scan_export_s, 2)}

    # Serialization on the card: cache, problem bundle, a warm State.
    save_pytree(tmp / "cache.npz", cache)
    c2 = load_like(tmp / "cache.npz", cache)
    save_pytree(tmp / "state.npz", (live, x0s[:n]))
    s2, x2 = load_like(tmp / "state.npz", (live, x0s[:n]))
    save_problem_cache(tmp / "bundle.npz", problem, cache, settings)
    p3, c3, s3 = load_problem_cache(tmp / "bundle.npz", device=dev)
    same = lambda a, b: all(torch.equal(u, v) for u, v in zip(
        a.tensors().values(), b.tensors().values()))
    assert same(c2, cache) and same(s2, live) and torch.equal(x2, x0s[:n])
    assert same(p3, problem) and same(c3, cache) and s3.max_iter == 10
    assert s2.x.is_cuda and c3.Kinf.is_cuda
    health = health_report(s2)
    assert health["all_finite"], health
    with debug_nans():
        fused_solve(x0s, cold, pp, max_iter=10)   # finite: no raise
    out["serialization"] = {"round_trip_bit_exact": True, "health": {
        k: v for k, v in health.items() if k != "unconverged_instances"}}

    # The six examples at their defaults, on the card.
    examples = {}
    for name in ("torch_quadrotor_hovering.py", "torch_quadrotor_tracking.py",
                 "torch_batch_scenario_mpc.py", "torch_mission_kernel.py",
                 "torch_adaptive_rho_demo.py", "torch_robust_plant_sweep.py"):
        before = [dict(c) for c in counters]
        t0 = time.perf_counter()
        lines, failed = run_example(name)
        launched = {k: v - b[k] for c, b in zip(counters, before)
                    for k, v in c.items() if v != b[k]}
        examples[name] = {"last_line": lines[-1] if lines else None,
                          "seconds": round(time.perf_counter() - t0, 2),
                          "launches": launched}
        if failed is not None:
            examples[name]["own_bar_failed"] = failed
            examples[name]["lines_before"] = lines[-3:]
        if name == "torch_robust_plant_sweep.py":
            robust = lines, failed
    hover = float(examples["torch_quadrotor_hovering.py"]["last_line"]
                  .split()[-1])
    assert hover < 0.01, f"hovering final error {hover}"
    for name, ex in examples.items():
        if name != "torch_robust_plant_sweep.py":
            assert "own_bar_failed" not in ex, (name, ex)
    # The robust sweep's own bar (err < 0.1) fails at its defaults in both
    # packages (tests/test_torch_examples.py, marked slow, runs both). So
    # the card's run is held to the plain versions' on the same inputs, in
    # this run: the example at its defaults with --cpu, tick by tick.
    t0 = time.perf_counter()
    plain, plain_failed = run_example("torch_robust_plant_sweep.py", "--cpu")
    ticks = lambda ls: [floats_in(ln) for ln in ls
                        if ln.startswith(("tick ", "final tracking"))]
    card_ticks, plain_ticks = ticks(robust[0]), ticks(plain)
    worst = max(abs(a - b) for c, p in zip(card_ticks, plain_ticks)
                for a, b in zip(c, p))
    examples["torch_robust_plant_sweep.py"]["against_plain"] = {
        "card_final_error": card_ticks[-1][0],
        "plain_final_error": plain_ticks[-1][0],
        "max_abs_err": worst, "tol": ROBUST_TOL,
        "plain_own_bar_failed": plain_failed,
        "plain_seconds": round(time.perf_counter() - t0, 2)}
    assert len(card_ticks) == len(plain_ticks) == 18, (card_ticks, plain)
    assert worst <= ROBUST_TOL, f"robust sweep card vs plain: {worst}"
    assert robust[1] == plain_failed, (robust[1], plain_failed)
    for name, kernel in (("torch_quadrotor_hovering.py", "fused_solve_fixed"),
                         ("torch_quadrotor_tracking.py", "fused_solve_fixed"),
                         ("torch_batch_scenario_mpc.py", "fused_solve_fixed"),
                         ("torch_mission_kernel.py", "fused_rollout"),
                         ("torch_robust_plant_sweep.py", "hetero_solve_fixed"),
                         ("torch_robust_plant_sweep.py",
                          "riccati_fixed_point")):
        assert examples[name]["launches"].get(kernel, 0) > 0, (name, kernel)
    out["examples"] = examples
    out["launches"] = {k: v for c in counters for k, v in c.items() if v}
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = round(time.perf_counter() - t_start, 1)
    return out


# ------------------------------------------------------------- sixth path --
# The batch mesh (accelerated_tinympc_tpu_torch.parallel), codegen and the
# native binding, against the card.

CASCADE_KW = dict(max_iter=100, check_termination=1, segment_iters=25)
RHO_BATCH6 = 16384        # adaptive rho, as the third path
LONG_BATCH6 = 8192        # the long-horizon kernels, as the fourth path
ADAPT5 = dict(max_iter=100, check_termination=5, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3)
GLOO_TIMEOUT_S = 300      # the two-rank sub-phase, launch to last exit
GLOO_RANK_DEVICE = "cuda:0"   # both ranks drive the one card


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _main_tile(dims) -> int:
    """The fused kernels' slots per block at the main batch on this card:
    passed to every cascade segment, so the survivors run at the main
    path's launch geometry (and so to its bits) in every bucket."""
    from accelerated_tinympc_tpu_torch.ops import fused_admm

    props = torch.cuda.get_device_properties(0)
    return fused_admm.choose_tile(
        dims, MAIN_BATCH, props.multi_processor_count,
        getattr(props, "shared_memory_per_block_optin",
                fused_admm.SMEM_LIMIT_BYTES))


def _flat(tree, prefix: str = "") -> dict:
    """``{field path: tensor}`` of a result (NamedTuples, dicts, the port's
    dataclasses); other leaves are left out."""
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("."): tree}
    if hasattr(tree, "_fields"):
        items = ((k, getattr(tree, k)) for k in tree._fields)
    elif isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "tensors"):
        items = tree.tensors().items()
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _unequal(got, want) -> list:
    """The fields of ``got`` whose bits differ from ``want``'s."""
    g, w = _flat(got), _flat(want)
    assert set(g) <= set(w) and g, (sorted(g), sorted(w))
    return [k for k in g if not torch.equal(g[k], w[k])]


def _stats_of(kind: str, res) -> dict:
    """A sharded call's stats recomputed in float64 from the unsharded
    result: the sums, maxima and means of the JAX package's ``psum``,
    ``pmax`` and ``pmean`` entries."""
    if kind == "rollout":
        it = res.iters.double()
        r = {"n_total": it.shape[1], "iterations_sum": it.sum(),
             "iterations_max": it.max(),
             "last_tick_iterations_mean": it[-1].mean()}
    elif kind == "adaptive":
        r = {"n_total": res.total_iter.shape[0],
             "n_solved": res.solved.double().sum(),
             "rounds_max": res.rounds, "iterations_max": res.total_iter.max()}
    else:
        st = res.stats.double()
        r = {"n_total": st.shape[0]}
        if kind == "fused":
            r.update(n_converged=st[:, 1].sum(), iterations_sum=st[:, 0].sum(),
                     iterations_max=st[:, 0].max())
        elif kind == "hetero":
            r["iterations_max"] = st[:, 0].max()
        r.update(primal_residual_state_max=st[:, 2].max(),
                 dual_residual_state_max=st[:, 3].max(),
                 primal_residual_input_max=st[:, 4].max(),
                 dual_residual_input_max=st[:, 5].max())
    return {k: float(v) for k, v in r.items()}


def _stats_equal(kind: str, stats: dict, want) -> bool:
    got = {k: float(v) for k, v in stats.items()}
    return got == _stats_of(kind, want)


def _counters() -> tuple:
    from accelerated_tinympc_tpu_torch.ops import fused_admm
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
    from accelerated_tinympc_tpu_torch.ops import riccati_kernel as rk
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    return (fused_admm.LAUNCH_COUNTS, rk.LAUNCH_COUNTS, ha.LAUNCH_COUNTS,
            sa.LAUNCH_COUNTS)


def _launch_ranks(out_dir: pathlib.Path) -> list:
    """``chip_smoke.py --gloo-rank`` twice on this card; a rank that fails,
    or the time limit, kills the other. Returns the ranks' reports."""
    addr = f"127.0.0.1:{_free_port()}"
    logs = [open(out_dir / f"rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         "--gloo-rank", addr, str(r), str(out_dir)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or (
                    time.monotonic() > deadline):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = []
    for r, f in enumerate(logs):
        f.seek(0)
        tails.append(f"rank {r} exit {procs[r].returncode}: "
                     + f.read()[-2000:])
        f.close()
    assert all(p.returncode == 0 for p in procs), "\n".join(tails)
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(2)]


def gloo_rank(addr: str, rank: int, out_dir: str) -> None:
    """One of two ranks on one card over gloo (NCCL refuses two ranks on
    one GPU): the main path's 65,536 split 32,768 + 32,768 (a fixed-100
    solve, the warm adaptive solve, the cascade) through the sharded entry
    points. Rank 0 holds the stitched results bit for bit to the unsharded
    calls and the stats to their reduction; each rank writes
    ``rank<r>.json``. The kernels are the ones the parent built."""
    import datetime

    import torch.distributed as dist

    from accelerated_tinympc_tpu_torch import parallel as par
    from accelerated_tinympc_tpu_torch.ops import FusedCarry, fused_solve
    from accelerated_tinympc_tpu_torch.solver.cascade import cascade_solve

    dev = GLOO_RANK_DEVICE
    t_start = time.perf_counter()
    par.initialize_distributed(
        addr, 2, rank, device=dev, backend="gloo",
        timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    mesh = par.make_batch_mesh(2, device=dev)
    problem, _cache, pp, x0s = flagship(MAIN_BATCH, dev)
    cold = FusedCarry.zeros(MAIN_BATCH, pp, device=dev)
    x1, warm = warm_start(problem, pp, x0s, dev)
    tile = _main_tile(pp.dims)
    sh = lambda t: par.shard_batch(t, mesh)
    log: list = []
    calls = {
        "fixed100": lambda: par.sharded_fused_solve(
            mesh, pp, max_iter=100)(sh(x0s), sh(cold)),
        "adaptive_warm": lambda: par.sharded_fused_solve(
            mesh, pp, **WARM_KW)(sh(x1), sh(warm)),
        "cascade": lambda: (par.sharded_cascade_solve(
            mesh, pp, batch_tile=tile, segment_log=log, **CASCADE_KW)(
            x1, warm), None),
    }
    for c in _counters():
        for k in c:
            c[k] = 0
    dist.barrier()
    runs, ms = {}, {}
    for name, fn in calls.items():
        runs[name], ms[name] = timed(fn)
    launches = {k: v for c in _counters() for k, v in c.items() if v}
    stitched = {name: (par.gather_batch(res, mesh) if stats is not None
                       else res) for name, (res, stats) in runs.items()}
    report = {"rank": rank, "backend": mesh.backend, "ms": ms,
              "launches": launches, "rows": int(x0s.shape[0] // 2)}
    if rank == 0:
        wants = {
            "fixed100": fused_solve(x0s, cold, pp, max_iter=100),
            "adaptive_warm": fused_solve(x1, warm, pp, **WARM_KW),
            "cascade": cascade_solve(x1, warm, pp, batch_tile=tile,
                                     **CASCADE_KW)}
        report["unequal"] = {n: _unequal(stitched[n], w)
                             for n, w in wants.items()}
        report["stats_equal"] = {
            n: _stats_equal("fused", runs[n][1], wants[n])
            for n in ("fixed100", "adaptive_warm")}
        report["segment_log"] = log
        report["iterations_mean"] = {
            n: float(w.stats[:, 0].mean()) for n, w in wants.items()}
    report["seconds"] = round(time.perf_counter() - t_start, 1)
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def sixth_path(dev: str = "cuda") -> dict:
    """The batch mesh, codegen and the native binding at full width.

    A world of one over NCCL on the card (a process group of one rank, so
    every collective runs): every ``sharded_*`` entry point at the shapes
    of its single-device path -- the quadrotor at 65,536 for K1 (fixed
    100), K2 (the warm start), K3 (70 ticks) and the cascade; the lander's
    cones for K4 a; the robust family for K7, and at 16,384 for K8, K5 and
    K6 through ``sharded_adaptive_hetero``; the 8/3/1024 plant at 8,192 for
    K9 and K10; the robust family at N=256 for K11 and K12 -- each held bit
    for bit to the same unsharded call and each stats dict to its
    reduction, recomputed. The launch counts are set to 0 just before the
    sharded calls and read just after; the unsharded calls come after.
    Then two ranks on the card over gloo (:func:`gloo_rank`), then the
    quadrotor's generated C++ project (70 hovering ticks against K1 on the
    card and the golden CSVs) and ``NativeSolver.solve_batch`` at 1,024
    against the fused tier. Raises on any failed check."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist

    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch import parallel as par
    from accelerated_tinympc_tpu_torch.api import build_project, tiny_codegen
    from accelerated_tinympc_tpu_torch.models import quadrotor as qm
    from accelerated_tinympc_tpu_torch.native import NativeSolver
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_rollout, fused_solve, pad_cones, rollout_ops,
    )
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa
    from accelerated_tinympc_tpu_torch.solver import (
        cascade_solve, solve_adaptive_rho_hetero,
    )

    t_start = time.perf_counter()
    out = {}
    # inputs, built before the counts are set to 0
    problem, cache, pp, x0s = flagship(MAIN_BATCH, dev)
    cold = FusedCarry.zeros(MAIN_BATCH, pp, device=dev)
    x1, warm = warm_start(problem, pp, x0s, dev)
    rops = rollout_ops(problem, pp, device=dev)
    tile = _main_tile(pp.dims)
    _lp, _lc, lpp, lx0 = lander(MAIN_BATCH, dev)
    lcold = FusedCarry.zeros(MAIN_BATCH, lpp, device=dev)
    lcops = pad_cones(lpp, lander_cones())
    prob_h, rho_h, x0_h = robust_family(MAIN_BATCH, dev=dev)
    hp = ha.pad_hetero_from_plants(prob_h.A, prob_h.B, prob_h.Q, prob_h.R,
                                   rho_h, prob_h)[0]
    hcold = ha.HeteroCarry.zeros(hp)
    prob_r, rho_r, _x = robust_family(RHO_BATCH6, seed=6, dev=dev)
    x0_r = prob_r.Xref[0, 0][None] + 0.2 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((RHO_BATCH6, 12)),
        dtype=torch.float32, device=dev)
    rho0 = rho_r * torch.as_tensor(np.tile(
        [1.0, 1e-3, 200.0], RHO_BATCH6 // 3 + 1)[:RHO_BATCH6],
        dtype=torch.float32, device=dev)
    rho_sets = atm.Settings(abs_pri_tol=1e-2, abs_dua_tol=1e-2,
                            check_termination=1)
    adapt_args = (x0_r, prob_r, prob_r.A, prob_r.B, prob_r.Q, prob_r.R, rho0)
    prob_l, cache_l = long_plant(1024, dev=dev)
    sp = sa.pad_stream_problem(prob_l, cache_l)
    sc = np.resize([0.3, 3.0, 10.0], LONG_BATCH6)[:, None]
    x0_l = torch.as_tensor(
        sc * np.random.default_rng(11).standard_normal((LONG_BATCH6, 8)),
        dtype=torch.float32, device=dev)
    scold = sa.StreamCarry.zeros(LONG_BATCH6, sp)
    prob_f, rho_f, x0_f = robust_family(LONG_BATCH6, seed=12, dev=dev)
    hsp = hs.pad_hstream_from_plants(prob_f.A, prob_f.B, prob_f.Q, prob_f.R,
                                     rho_f, at_horizon(prob_f, 256))[0]
    hscold = sa.StreamCarry.zeros(LONG_BATCH6, hsp)
    torch.cuda.synchronize()

    # A world of one over NCCL: initialize_distributed does nothing for one
    # process (as JAX's), so the group of one is brought up here.
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = par.make_batch_mesh(1)
        assert (mesh.backend, mesh.device.type) == ("nccl", "cuda"), mesh
        sh = lambda t: par.shard_batch(t, mesh)
        log: list = []
        # name: (sharded call, the same unsharded call, stats kind)
        cases = {
            "K1 fixed100": (
                lambda: par.sharded_fused_solve(mesh, pp, max_iter=100)(
                    sh(x0s), sh(cold)),
                lambda: fused_solve(x0s, cold, pp, max_iter=100), "fused"),
            "K2 adaptive warm": (
                lambda: par.sharded_fused_solve(mesh, pp, **WARM_KW)(
                    sh(x1), sh(warm)),
                lambda: fused_solve(x1, warm, pp, **WARM_KW), "fused"),
            "K3 rollout70": (
                lambda: par.sharded_fused_rollout(mesh, pp, rops, 70,
                                                  **WARM_KW)(sh(x0s), sh(cold)),
                lambda: fused_rollout(x0s, cold, pp, rops, 70, **WARM_KW),
                "rollout"),
            "K2 cascade": (
                lambda: (par.sharded_cascade_solve(
                    mesh, pp, batch_tile=tile, segment_log=log,
                    **CASCADE_KW)(x1, warm), None),
                lambda: cascade_solve(x1, warm, pp, batch_tile=tile,
                                      **CASCADE_KW), None),
            "K4a lander cones": (
                lambda: par.sharded_fused_solve(
                    mesh, lpp, cone_ops=lcops, **LANDER_FIXED)(
                    sh(lx0), sh(lcold)),
                lambda: fused_solve(lx0, lcold, lpp, cone_ops=lcops,
                                    **LANDER_FIXED), "fused"),
            "K7 robust fixed100": (
                lambda: par.sharded_hetero_solve(mesh, max_iter=100)(
                    sh(x0_h), sh(hcold), sh(hp)),
                lambda: ha.hetero_solve(x0_h, hcold, hp, max_iter=100),
                "hetero"),
            "K8 K5 K6 adaptive rho": (
                lambda: par.sharded_adaptive_hetero(
                    mesh, rho_sets, max_rounds=12)(*map(sh, adapt_args)),
                lambda: solve_adaptive_rho_hetero(
                    *adapt_args, rho_sets, max_rounds=12), "adaptive"),
            "K9 stream fixed100": (
                lambda: par.sharded_stream_solve(mesh, max_iter=100)(
                    sh(x0_l), sh(scold), sp),
                lambda: sa.stream_solve(x0_l, scold, sp, max_iter=100),
                "stream"),
            "K10 stream adaptive": (
                lambda: par.sharded_stream_solve(mesh, **ADAPT5)(
                    sh(x0_l), sh(scold), sp),
                lambda: sa.stream_solve(x0_l, scold, sp, **ADAPT5), "stream"),
            "K11 hstream fixed100": (
                lambda: par.sharded_hstream_solve(mesh, max_iter=100)(
                    sh(x0_f), sh(hscold), sh(hsp)),
                lambda: hs.hstream_solve(x0_f, hscold, hsp, max_iter=100,
                                         knot_block=16), "stream"),
            "K12 hstream adaptive": (
                lambda: par.sharded_hstream_solve(mesh, **ADAPT5)(
                    sh(x0_f), sh(hscold), sh(hsp)),
                lambda: hs.hstream_solve(x0_f, hscold, hsp, knot_block=16,
                                         **ADAPT5), "stream"),
        }
        for c in _counters():
            for k in c:
                c[k] = 0
        got, ms = {}, {}
        for name, (run, _want, _kind) in cases.items():
            got[name], ms[name] = timed(run)
        launches = {k: v for c in _counters() for k, v in c.items() if v}
        world1 = {}
        for name, (_run, want_fn, kind) in cases.items():
            (res, stats), want = got[name], None
            want, want_ms = timed(want_fn)
            bad = _unequal(res, want if kind != "adaptive" else {
                k: getattr(want, k) for k in res})
            world1[name] = {"sharded_ms": ms[name], "unsharded_ms": want_ms,
                            "bit_exact": not bad}
            assert not bad, f"sixth path {name}: {bad} differ"
            if kind is not None:
                assert _stats_equal(kind, stats, want), (
                    name, {k: float(v) for k, v in stats.items()},
                    _stats_of(kind, want))
            del want
        world1["K2 cascade"]["segment_log"] = log
        got = None
        # what the mesh adds on the host: K1 through the sharded entry and
        # directly, mean of three after a warm-up
        k1 = par.sharded_fused_solve(mesh, pp, max_iter=100)
        out["host_cost_k1_ms"] = {
            "sharded": cuda_ms(lambda: k1(sh(x0s), sh(cold))),
            "unsharded": cuda_ms(lambda: fused_solve(x0s, cold, pp,
                                                     max_iter=100))}
    finally:
        dist.destroy_process_group()
    path_kernels = (
        "fused_solve_fixed", "fused_solve_adaptive", "fused_rollout",
        "fused_solve_fixed_cones", "hetero_solve_fixed",
        "hetero_solve_adaptive", "riccati_fixed_point", "riccati_newton",
        "stream_solve_fixed", "stream_solve_adaptive", "hstream_solve_fixed",
        "hstream_solve_adaptive")
    for k in path_kernels:
        assert launches.get(k, 0) > 0, f"sixth path never launched {k}"
    out.update(world_of_one_nccl=world1, launches=launches)

    # Two ranks on this card over gloo (NCCL refuses two ranks on one GPU).
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="atm_sixth_path_"))
    t0 = time.perf_counter()
    r0, r1 = _launch_ranks(tmp)
    assert r0["backend"] == "gloo", r0
    assert not any(r0["unequal"].values()), r0["unequal"]
    assert all(r0["stats_equal"].values()), r0["stats_equal"]
    out["two_ranks_gloo_one_card"] = {
        "note": "gloo: NCCL refuses two ranks on one GPU",
        "rows_per_rank": r0["rows"], "bit_exact": True,
        "ms_rank0": r0["ms"], "ms_rank1": r1["ms"],
        "launches_rank0": r0["launches"], "launches_rank1": r1["launches"],
        "segment_log": r0["segment_log"],
        "iterations_mean": r0["iterations_mean"],
        "rank_seconds": [r0["seconds"], r1["seconds"]],
        "wall_seconds": round(time.perf_counter() - t0, 1)}

    # Codegen: the quadrotor's hovering project (the golden harness's
    # settings: 50 fixed iterations, raw workspace Q), built with g++, 70
    # ticks, against K1 on the card and the golden CSVs.
    d = np.load(qm.DATA_DIR / "quadrotor_20hz_params.npz")
    t0 = time.perf_counter()
    proj = tiny_codegen(
        d["Adyn"], d["Bdyn"], d["Q"], d["R"], rho=float(d["rho"]),
        horizon=10, output_dir=tmp / "quad_project", u_min=-0.5, u_max=0.5,
        x_min=-5.0, x_max=5.0, Xref=np.tile(qm.HOVER_SETPOINT, (10, 1)),
        settings=atm.Settings(max_iter=50, check_termination=0),
        gen_wrapper=False, augment_Q=False)
    binary = build_project(proj)
    build_s = time.perf_counter() - t0
    run = subprocess.run([str(binary), *map(str, qm.HOVER_X0), "70"],
                         capture_output=True, text=True, check=True)
    u_cpp = np.array([[float(v) for v in line.split(",")[13:17]]
                      for line in run.stdout.strip().splitlines()])
    prob, cch, x0 = atm.models.quadrotor_hovering_setup(device=dev)
    one = atm.TinyMPC.from_parts(
        prob, cch, tier="fused", device=dev,
        settings=atm.Settings(max_iter=50, check_termination=0))
    one.set_x0(x0)
    _xf, us_k1 = one.rollout(70, in_kernel=False)
    golden_u = np.loadtxt(GOLDEN / "hovering_fixed50_traj.csv",
                          delimiter=",")[:, 13:17]
    codegen = {
        "ticks": int(u_cpp.shape[0]), "build_s": round(build_s, 2),
        "u_err_vs_k1_card": float(np.abs(u_cpp - us_k1.cpu().numpy()).max()),
        "u_err_vs_golden": float(np.abs(u_cpp - golden_u).max())}
    assert u_cpp.shape == (70, 4), u_cpp.shape
    assert codegen["u_err_vs_k1_card"] <= VAL_TOL, codegen
    assert codegen["u_err_vs_golden"] <= VAL_TOL, codegen
    out["codegen_quadrotor"] = codegen

    # NativeSolver.solve_batch on 1,024 instances against K1 on the card.
    n = 1024
    f64 = lambda t: t.double().cpu().numpy()
    ns = NativeSolver(f64(problem.A), f64(problem.B), f64(problem.Q),
                      f64(problem.R), float(cache.rho), 10, max_iter=100,
                      check_termination=0)
    ns.set_bounds(u_min=f64(problem.u_min), u_max=f64(problem.u_max),
                  x_min=f64(problem.x_min), x_max=f64(problem.x_max))
    ns.set_xref(f64(problem.Xref))
    t0 = time.perf_counter()
    u_nat, iters, _status = ns.solve_batch(f64(x0s[:n]))
    native_s = time.perf_counter() - t0
    card = fused_solve(x0s[:n].contiguous(),
                       FusedCarry.zeros(n, pp, device=dev), pp, max_iter=100)
    err = float(np.abs(u_nat - f64(card.U).reshape(n, 9, 4)).max())
    out["native_batch"] = {"batch": n, "u_err_vs_fused_card": err,
                           "native_host_s": round(native_s, 3),
                           "iterations": int(iters.max())}
    assert err <= VAL_TOL, out["native_batch"]
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = round(time.perf_counter() - t_start, 1)
    return out


# ------------------------------------------------------------ bf16x3 path
# The split-bf16 mode's workloads beside the float32 kernels' rows: K1 cold
# fixed-100 at polish 8 (and 6), K2 on K2's warm workload (checks every
# iteration: no split iteration, so the float32 arithmetic in the split
# kernel) and at checks every 5 with the JAX test's tolerance 0.05
# (tests/test_fused.py:261), K3 over 70 ticks at checks every 5 (so split
# iterations run between them), K4 a/b/c on the lander. The mode's checks
# are float32 iterations after split ones, so a check's dual residual holds
# the switch of arithmetic: on the quadrotor it floors at a few 1e-3 (the
# JAX package's mode alike, tests/test_torch_bf16x3.py), and the adaptive
# workloads take tolerances above that floor.
BF16X3_TOL = dict(abs_pri_tol=1e-2, abs_dua_tol=1e-2)
BF16X3_ADAPTIVE = dict(max_iter=400, check_termination=5, abs_pri_tol=0.05,
                       abs_dua_tol=0.05)
BF16X3_MISSION = dict(max_iter=100, check_termination=5, **BF16X3_TOL)
BF16X3_COMPARE_TICKS = 10   # K3, K4 c against their plain versions at 4,099
# Short solves where the two arithmetics part (a few iterations pin the
# schedule, as tests/test_torch_bf16x3.py shows against the JAX package on
# the CPU): fixed at 5 iterations, adaptive at 8 with checks every 3 past a
# warmup of 2, under tolerances that no instance meets (every solve runs to
# its cap), missions of 3 such ticks.
BF16X3_SHORT_FIXED = dict(max_iter=5, check_termination=0)
BF16X3_SHORT_ADAPTIVE = dict(max_iter=8, check_termination=3, warmup_iters=2,
                             abs_pri_tol=1e-12, abs_dua_tol=1e-12)
BF16X3_SHORT_TICKS = 3
# Short solves (split_separation): the share of instances nearer the
# kernel's own schedule than any other plain version, and the median
# distances this many times apart, 5 fixed iterations, or adaptive solves
# and missions, where the flips of the split compound (sound kernel, PERF.md
# §6: shares 0.77-0.99, factors 18-57 fixed, 1.9-7.5 adaptive; planted
# faults: shares 0-0.52 or factors 0.002-1.96 in the cases they touch).
SPLIT_NEARER = 0.6
SPLIT_SEP_FIXED = 10.0
SPLIT_SEP_ADAPTIVE = 1.5
SPLIT_CLOSER = 0.85  # held cases: median error vs the split plain version
                     # within this of the same vs the float32 plain version
                     # (sound 0.016-0.68, no split iteration 6.1-44)


def split_closer(case, got, want, plain_f32, field, sched, schedule):
    """Adds to ``case`` (a split-bf16 kernel ``got`` against the split plain
    version ``want`` of its schedule) the check that the kernel sits nearer
    ``want`` than the float32 plain version ``plain_f32()`` of the same
    inputs: on the instances whose schedule (``sched``) all three share,
    the median over instances of the kernel's largest error in ``field(r)``
    (a row per instance) against ``want`` within SPLIT_CLOSER of the same
    against the float32 version. A schedule that splits no iteration
    (``schedule``, the solve's keywords) makes the two plain versions one,
    and is not read (the bit-for-bit checks cover it)."""
    from accelerated_tinympc_tpu_torch.ops.fused_admm import schedule_splits

    skw = {k: v for k, v in schedule.items() if k in (
        "max_iter", "check_termination", "warmup_iters", "polish")}
    if not schedule_splits("bf16x3", **skw):
        case["closer_to_split"] = "no split iteration"
        return case
    f32 = plain_f32()
    sk, sw, sf = (sched(r).double() for r in (got, want, f32))
    same = (sk == sw).all(dim=1) & (sk == sf).all(dim=1)
    n = int(same.sum())

    if not n:
        case["failures"].append(f"{case['case']}: no instance shares the "
                                "schedule of the float32 plain version")
        return case
    per = lambda a, b: (field(a)[same].double() - field(b)[same].double()
                        ).abs().flatten(1).amax(dim=1)
    db, df = per(got, want), per(got, f32)
    mb, mf = float(db.median()), float(df.median())
    case["closer_to_split"] = {
        "median_vs_split_plain": mb, "median_vs_f32_plain": mf,
        "median_split_plain_vs_f32_plain": float(per(want, f32).median()),
        "ratio": mb / mf if mf else None,
        "kernel_nearer_share": float((db < df).float().mean()),
        "compared_share": n / same.numel()}
    if not mb <= SPLIT_CLOSER * mf:
        case["failures"].append(
            f"{case['case']}: median error {mb} from the split plain version "
            f"> {SPLIT_CLOSER} x {mf} from the float32 plain version")
    return case


def split_separation(name, run_k, run_p, kw, alts, field, iters, sep):
    """A short split-bf16 solve (or mission) where the arithmetics part:
    ``run_k(**kw)`` (the kernel) against ``run_p(**kw)`` (the plain
    version), both taking ``algo``; ``field(r)`` a row per instance. Each
    other plain version, the float32 one and those of a schedule one
    iteration off (``alts``: keywords over ``kw``), is held apart from the
    split plain version by two readings per instance (largest error): the
    share of instances on which the kernel is nearer the split plain
    version than the other (at least SPLIT_NEARER), and the median over
    instances of the other's distance to the split plain version over the
    kernel's (at least ``sep``). Largest errors over all instances are
    reported beside them: the split is discontinuous, so an iterate one
    float32 ulp apart (the kernel's sums against the plain version's) may
    split into other bf16 pairs and move a product by as much as the
    mode itself, and on the worst instances the two arithmetics do not
    part. Every solve runs to its cap (``iters(r)``). Returns the row,
    its ``failures`` empty when it passes."""
    bf = dict(algo="bf16x3")
    got, want = run_k(**bf, **kw), run_p(**bf, **kw)
    others = {"float32": run_p(**kw), **{
        k: run_p(**bf, **{**kw, **v}) for k, v in alts.items()}}
    per = lambda a, b: (field(a).double() - field(b).double()).abs().flatten(
        1).amax(dim=1)
    dk = per(got, want)
    row = {"case": name, "kernel_vs_split_plain": {
        "max": float(dk.max()), "median": float(dk.median())}, "others": {}}
    for k, r in others.items():
        do = per(r, want)
        row["others"][k] = {
            "max": float(do.max()), "median": float(do.median()),
            "kernel_nearer_share": float((dk < per(got, r)).float().mean())}
    m_k = row["kernel_vs_split_plain"]["median"]
    m_o = min(v["median"] for v in row["others"].values())
    row["median_factor"] = m_o / m_k if m_k else None
    row["nearer_share"] = min(v["kernel_nearer_share"]
                              for v in row["others"].values())
    row["failures"] = []
    if not row["nearer_share"] >= SPLIT_NEARER:
        row["failures"].append(
            f"{name}: nearer share {row['nearer_share']} < {SPLIT_NEARER} "
            "(instances nearer the plain version of the kernel's schedule "
            "than the float32 one or a schedule one iteration off)")
    if not sep * m_k <= m_o:
        row["failures"].append(
            f"{name}: median factor {row['median_factor']} < {sep} (the "
            f"kernel {m_k} from the plain version of its schedule, the "
            f"nearest other {m_o})")
    if not bool((iters(got) == kw["max_iter"]).all()):
        row["failures"].append(f"{name}: a solve stopped before its cap")
    return row


def bf16x3_checks(dev: str = "cuda") -> dict:
    """The split-bf16 kernels' checks at batch 4,099, the first part of
    :func:`bf16x3_path`. Each kernel against the plain version of its
    schedule (the float64 plain version of the same splits arbitrates,
    ``arbitrate(rule="split")``, where two float32 plain versions, the
    card's and the CPU's, stray further apart than the bars: the split is
    discontinuous, so sums in another order move a product by up to 2^-17
    of its terms), and nearer it than the float32 plain version
    (``split_closer``); short solves where the arithmetics part, one case a
    kernel (``separation``); against the float32 kernels (K1 at polish 8
    and 6 within 1e-4 on the controls; the adaptive mode at checks every 5
    and tolerance 0.05: every instance converged, residuals under the
    tolerance, controls within 5e-4 where the two stop at the same check);
    bit for bit against the float32 kernels where no iteration splits
    (polish >= max_iter; checks every iteration) at one launch geometry;
    and the quadrotor's hovering mission of fixed-50 solves through K1 at
    polish 8 and 6 against the golden CSV (1e-4). Raises on no failed check
    (``tools/torch_bf16x3_faults.py`` reads the checks of kernels built
    with planted faults): returns ``{"cases", "vs_float32", "separation",
    "bit_exact", "plain_ms", "failures"}``."""
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.api.mpc import fused_mpc_rollout
    from accelerated_tinympc_tpu_torch.ops import fused_admm
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_rollout, fused_rollout_plain, fused_solve,
        fused_solve_plain, pad_cones, pad_problem, rollout_ops,
    )
    from accelerated_tinympc_tpu_torch.solver.cascade import cascade_solve

    BF = dict(algo="bf16x3")
    f64 = torch.float64
    B = KERNEL_BATCH
    cases, exact, vs_f32, plain_ms = [], {}, [], {}

    def pad64(problem, cache):
        return pad_problem(problem.to(dtype=f64), cache.to(dtype=f64),
                           atm.condensed_operators(
                               cache, problem.A, problem.B, problem.horizon,
                               dtype=f64, device=dev), dtype=f64, device=dev)

    def held(name, xs, cy, pp, pp64, kw, cones=None, dims=None):
        """The kernel against the plain version of its schedule, arbitrated
        by the float64 plain version, and nearer it than the float32 plain
        version. Returns ``(kernel, case, plain ms)``."""
        ck = lambda p: {} if cones is None else {"cone_ops": pad_cones(p, cones)}
        got = fused_solve(xs, cy, pp, **BF, **ck(pp), **kw)
        want, ms = timed(lambda: fused_solve_plain(
            xs, cy, pp, **BF, **ck(pp), **kw))
        cpu_pp = pp.to(device="cpu")
        check = kw.get("check_termination", 0)
        case = arbitrate(
            compare_solve(name, got, want, check, pp.rho_f,
                          max_iter=kw["max_iter"]), got, want,
            lambda: fused_solve_plain(
                xs.double(), FusedCarry(*(t.double() for t in cy)), pp64,
                **BF, **ck(pp64), **kw),
            lambda: fused_solve_plain(
                xs.cpu(), FusedCarry(*(t.cpu() for t in cy)), cpu_pp, **BF,
                **ck(cpu_pp), **kw), max(check, 1), rule="split")
        split_closer(case, got, want, lambda: fused_solve_plain(
            xs, cy, pp, **ck(pp), **kw), lambda r: r.U, solve_sched, kw)
        if cones is not None:
            nx, nu, _N = dims
            Bn = got.U.shape[0]
            zz, vv = got.carry.Z.reshape(Bn, -1, nu), got.carry.V.reshape(
                Bn, -1, nx)
            excess = max([cone_excess(zz, c) for c in cones.input_cones]
                         + [cone_excess(vv, c) for c in cones.state_cones])
            case["cone_excess"] = excess
            if not excess <= CONE_TOL:
                case["failures"].append(
                    f"{name}: final slack violates a cone by {excess}")
        cases.append(case)
        return got, case, ms

    def mission(name, xs, cy, problem, pp, pp64, T, kw, check, tol,
                cones=None):
        """A mission against the plain mission of its schedule, the float64
        plain mission as arbiter, and nearer it than the float32 plain
        mission."""
        ck = lambda p: {} if cones is None else {"cone_ops": pad_cones(p, cones)}
        rops = rollout_ops(problem, pp, device=dev)
        got = fused_rollout(xs, cy, pp, rops, T, **BF, **ck(pp), **kw)
        want, ms = timed(lambda: fused_rollout_plain(
            xs, cy, pp, rops, T, **BF, **ck(pp), **kw))
        cpu_pp = pp.to(device="cpu")
        case = arbitrate(
            compare_rollout(name, got, want, check, tol), got, want,
            lambda: fused_rollout_plain(
                xs.double(), FusedCarry(*(t.double() for t in cy)), pp64,
                rollout_ops(problem, pp64, f64, dev), T, **BF, **ck(pp64),
                **kw),
            lambda: fused_rollout_plain(
                xs.cpu(), FusedCarry(*(t.cpu() for t in cy)), cpu_pp,
                rollout_ops(problem, cpu_pp, device="cpu"), T, **BF,
                **ck(cpu_pp), **kw), 3 * max(check, 1), rule="split",
            fields=lambda r: dict(us=r.us.transpose(0, 1), x_final=r.x_final,
                                  **solve_fields(r.final)),
            sched=lambda r: r.iters.T)
        split_closer(case, got, want, lambda: fused_rollout_plain(
            xs, cy, pp, rops, T, **ck(pp), **kw),
            lambda r: r.us.transpose(0, 1), lambda r: r.iters.T, kw)
        cases.append(case)
        return case, ms

    # ------------------------------------------ against the plain versions
    problem, cache, pp, x0s = flagship(B, dev)
    pp64 = pad64(problem, cache)
    cold = FusedCarry.zeros(B, pp, device=dev)
    x1, warm = warm_start(problem, pp, x0s, dev)
    for polish in (8, 6):
        kw = dict(max_iter=100, check_termination=0, polish=polish)
        got, case, ms = held(
            f"K1 bf16x3 fixed-100 cold polish={polish}", x0s, cold, pp, pp64,
            kw)
        f32 = fused_solve(x0s, cold, pp, max_iter=100)
        err = max_err(got.U, f32.U)
        vs_f32.append({"case": f"K1 polish={polish} vs the float32 kernel",
                       "u_err": err, "bar": VAL_TOL,
                       "failures": [] if err <= VAL_TOL else [
                           f"K1 polish={polish}: controls {err} from the "
                           "float32 kernel"]})
        plain_ms[f"K1 p{polish}"] = (case, ms)
    _g, case, ms = held("K2 bf16x3 warm check=1", x1, warm, pp, pp64, WARM_KW)
    plain_ms["K2"] = (case, ms)
    geo3 = fused_admm._geometry(pp.dims, B, dev, None, None, split=True)
    geo = dict(batch_tile=geo3[0], threads=geo3[1], placement=geo3[3])
    fields = lambda r: (r.U, r.X, r.stats) + tuple(r.carry)
    exact["K2 warm check=1 is the float32 kernel's bits"] = all(
        torch.equal(a, b) for a, b in zip(
            fields(fused_solve(x1, warm, pp, **BF, **WARM_KW, **geo)),
            fields(fused_solve(x1, warm, pp, **WARM_KW, **geo))))
    exact["K1 polish=100 is the float32 kernel's bits"] = all(
        torch.equal(a, b) for a, b in zip(
            fields(fused_solve(x0s, cold, pp, max_iter=100, polish=100,
                               **BF, **geo)),
            fields(fused_solve(x0s, cold, pp, max_iter=100, **geo))))
    got, _case, _ms = held("K2 bf16x3 warm check=5 tol=0.05", x1, warm, pp,
                           pp64, BF16X3_ADAPTIVE)
    f32 = fused_solve(x1, warm, pp, **BF16X3_ADAPTIVE)
    same = got.stats[:, 0] == f32.stats[:, 0]
    adaptive = {
        "case": "K2 check=5 tol=0.05 vs the float32 kernel (warm)",
        "converged": float(got.stats[:, 1].mean()),
        "converged_f32": float(f32.stats[:, 1].mean()),
        "residual_max": float(got.stats[:, 2:].max()),
        "counts_agree": float(same.float().mean()),
        "u_err_same_count": max_err(got.U, f32.U, same)}
    adaptive["failures"] = (
        [] if adaptive["converged"] == 1.0 else ["not every instance converged"]
    ) + ([] if adaptive["residual_max"] < 0.05 else ["residual over tol"]) + (
        [] if adaptive["u_err_same_count"] <= 5e-4 else ["controls > 5e-4"]) + (
        [] if adaptive["counts_agree"] >= AGREE_SOLVE else ["counts differ"])
    vs_f32.append(adaptive)

    T = BF16X3_COMPARE_TICKS
    plain_ms["K3"] = mission(f"K3 bf16x3 {T} ticks check=5", x0s, cold,
                             problem, pp, pp64, T, BF16X3_MISSION, 5, 1e-3)

    lproblem, lcache, lpp, lx0 = lander(B, dev)
    lpp64 = pad64(lproblem, lcache)
    lcold = FusedCarry.zeros(B, lpp, device=dev)
    lcones = lander_cones()
    for key, kw in (("K4a", LANDER_FIXED), ("K4b", LANDER_ADAPTIVE)):
        _g, case, ms = held(f"{key} bf16x3 lander cones", lx0, lcold, lpp,
                            lpp64, kw, cones=lcones, dims=(6, 3, 15))
        plain_ms[key] = (case, ms)
    plain_ms["K4c"] = mission(
        f"K4c bf16x3 lander coned mission {T} ticks", lx0, lcold, lproblem,
        lpp, lpp64, T, LANDER_MISSION, 2, 1e-2, cones=lcones)

    # ------------------------ short solves where the two arithmetics part
    rops = rollout_ops(problem, pp, device=dev)
    lcops = pad_cones(lpp, lcones)
    lrops = rollout_ops(lproblem, lpp, device=dev)
    solve_u, solve_it = (lambda r: r.U), (lambda r: r.stats[:, 0])
    tick_u, tick_it = (lambda r: r.us.transpose(0, 1)), (lambda r: r.iters)
    quad_k = lambda **a: fused_solve(x0s, cold, pp, **a)
    quad_p = lambda **a: fused_solve_plain(x0s, cold, pp, **a)
    land_k = lambda **a: fused_solve(lx0, lcold, lpp, cone_ops=lcops, **a)
    land_p = lambda **a: fused_solve_plain(lx0, lcold, lpp, cone_ops=lcops,
                                           **a)
    TS = BF16X3_SHORT_TICKS
    AD, FX = BF16X3_SHORT_ADAPTIVE, BF16X3_SHORT_FIXED
    late = {"warmup=3": dict(warmup_iters=AD["warmup_iters"] + 1)}
    SF, SA = SPLIT_SEP_FIXED, SPLIT_SEP_ADAPTIVE
    short = [(f"K1 max_iter=5 polish={p}", quad_k, quad_p,
              dict(**FX, polish=p), {f"polish={q}": dict(polish=q)
                                     for q in alts}, solve_u, solve_it, SF)
             for p, alts in ((1, (2,)), (2, (1, 3)))]
    short += [
        ("K2 max_iter=8 warmup=2 check=3", quad_k, quad_p, AD, late,
         solve_u, solve_it, SA),
        (f"K3 {TS} ticks max_iter=8 warmup=2 check=3",
         lambda **a: fused_rollout(x0s, cold, pp, rops, TS, **a),
         lambda **a: fused_rollout_plain(x0s, cold, pp, rops, TS, **a),
         AD, late, tick_u, tick_it, SA),
        ("K4a lander max_iter=5 polish=1", land_k, land_p,
         dict(**FX, polish=1), {"polish=2": dict(polish=2)}, solve_u,
         solve_it, SF),
        ("K4b lander max_iter=8 warmup=2 check=3", land_k, land_p, AD, late,
         solve_u, solve_it, SA),
        (f"K4c lander {TS} ticks max_iter=8 warmup=2 check=3",
         lambda **a: fused_rollout(lx0, lcold, lpp, lrops, TS,
                                   cone_ops=lcops, **a),
         lambda **a: fused_rollout_plain(lx0, lcold, lpp, lrops, TS,
                                         cone_ops=lcops, **a),
         AD, late, tick_u, tick_it, SA)]
    sep = [split_separation(*args) for args in short]

    # the cascade and TinyMPC at the comparison batch
    segs = []
    casc = cascade_solve(x1, warm, pp, segment_iters=25, trace=segs, **BF,
                         **BF16X3_ADAPTIVE)
    mono = fused_solve(x1, warm, pp, **BF, **BF16X3_ADAPTIVE)
    same = casc.stats[:, 0] == mono.stats[:, 0]
    cc = {"case": "cascade_solve bf16x3 vs one launch", "segments": segs,
          "iters_agree": float(same.float().mean()),
          "u_err_same_schedule": max_err(casc.U, mono.U, same)}
    cc["failures"] = ([] if cc["iters_agree"] >= AGREE_SOLVE else
                      ["cascade counts"]) + (
        [] if cc["u_err_same_schedule"] <= VAL_TOL else ["cascade controls"])
    cases.append(cc)
    mpc = atm.TinyMPC.from_parts(
        problem, cache, tier="fused", batch=B, algo="bf16x3", device=dev,
        settings=atm.Settings(max_iter=100, check_termination=0))
    mpc.set_x0(x0s)
    mpc.solve()
    direct = fused_solve(x0s, cold, pp, max_iter=100, **BF)
    exact["TinyMPC(algo='bf16x3') is the kernel"] = all(
        torch.equal(a, b) for a, b in zip(fields(mpc._fused_result),
                                          fields(direct)))

    # the golden hovering mission, fixed-50 solves through K1 (tick loop)
    rows = np.loadtxt(GOLDEN / "hovering_fixed50_traj.csv", delimiter=",")
    gprob, gcache, gx0 = atm.models.quadrotor_hovering_setup(device=dev)
    gpp = atm.TinyMPC.from_parts(gprob, gcache, tier="fused",
                                 device=dev)._pp
    golden = {}
    for polish in (8, 6):
        _xf, us, _c = fused_mpc_rollout(
            gpp, torch.as_tensor(gx0[None], dtype=torch.float32, device=dev),
            70, problem=gprob, max_iter=50, algo="bf16x3", polish=polish)
        golden[f"polish={polish}"] = float(np.abs(
            us[:, 0].cpu().numpy() - rows[:, 13:17]).max())
    vs_f32.append({"case": "K1 hovering fixed-50 golden CSV", **golden,
                   "failures": [f"golden {k}: {v}" for k, v in golden.items()
                                if not v <= VAL_TOL]})
    torch.cuda.synchronize()
    failures = [f for c in cases + vs_f32 + sep for f in c["failures"]] + [
        f"bf16x3: {k} is not bit-exact" for k, v in exact.items() if not v]
    return {"cases": cases, "vs_float32": vs_f32, "separation": sep,
            "bit_exact": exact, "plain_ms": plain_ms, "failures": failures}


def bf16x3_path(dev: str = "cuda") -> tuple[dict, list]:
    """The fused tier's split-bf16 mode (``algo="bf16x3"``, the kernels of
    ``csrc/fused_admm_bf16x3.cu``) at full width: :func:`bf16x3_checks`
    at batch 4,099, then the mode's main path through
    ``TinyMPC(algo="bf16x3")`` at batch 65,536 with the launch counts set
    to 0 just before and read just after, and each kernel timed beside its
    float32 twin. Returns ``(phase fields, kernel rows)``; raises on a
    failed check."""
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.ops import fused_admm
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_rollout, fused_solve, pad_cones, rollout_ops,
    )
    from accelerated_tinympc_tpu_torch.utils.profiling import (
        solve_bound, split_iters_of,
    )

    t0 = time.perf_counter()
    BF = dict(algo="bf16x3")
    chk = bf16x3_checks(dev)
    emit("bf16x3_kernels", batch=KERNEL_BATCH, **{
        k: chk[k] for k in ("cases", "vs_float32", "separation", "bit_exact")})
    if chk["failures"]:
        raise AssertionError("; ".join(chk["failures"]))
    small = chk["plain_ms"]
    lcones = lander_cones()
    lproblem, lcache, lpp, lx0 = lander(MAIN_BATCH, dev)

    # ------------------------------------ the mode's main path at 65,536
    MB = MAIN_BATCH
    qprob, qcache, qx0 = atm.models.quadrotor_hovering_setup(device=dev)
    rng = np.random.default_rng(0)
    qx0s = qx0[None] + 0.05 * rng.standard_normal((MB, 12))

    def quad(check, segment=0):
        m = atm.TinyMPC.from_parts(
            qprob, qcache, tier="fused", batch=MB, algo="bf16x3", device=dev,
            compaction_segment=segment,
            settings=atm.Settings(max_iter=100, check_termination=check,
                                  **BF16X3_TOL))
        m.set_x0(qx0s)
        return m

    lmpc = lambda: atm.TinyMPC.from_parts(
        lproblem, lcache, tier="fused", batch=MB, cones=lcones, algo="bf16x3",
        device=dev, settings=atm.Settings(**LANDER_ADAPTIVE))
    quad(0).solve()   # warm-up: the split kernels' library loaded
    fused_admm.reset_launch_counts()
    steps = {}

    def step(name, fn, n):
        out, ms = timed(fn)
        steps[name] = {"ms": ms, "solves_per_s": n / ms * 1e3}
        return out

    mpc = quad(0)
    step("solve_fixed100", mpc.solve, MB)
    u_fixed = mpc.get_u()
    mpc.settings = mpc.settings.replace(check_termination=5)
    step("solve_adaptive_check5_after_fixed", mpc.solve, MB)
    mpc.reset_duals()
    xf_k, us_k = step("rollout70_in_kernel",
                      lambda: mpc.rollout(70, in_kernel=True), 70 * MB)
    xf_l, us_l = step("rollout10_tick_loop",
                      lambda: mpc.rollout(10, in_kernel=False), 10 * MB)
    mpc.reset_duals()
    st = step("solve_adaptive_check5_warm", mpc.solve, MB)
    cmpc = quad(5, segment=25)
    cmpc.rollout(12, in_kernel=True)
    cmpc.reset_duals()
    step("cascade_warm_check5", cmpc.solve, MB)
    lf = lmpc()
    lf.set_x0(lx0)
    st_l = step("lander_cones_solve_adaptive", lf.solve, MB)
    lf.settings = lf.settings.replace(max_iter=100, check_termination=0)
    lf.reset_duals()
    step("lander_cones_solve_fixed100", lf.solve, MB)
    lf.settings = lf.settings.replace(**LANDER_MISSION)
    xf_c, us_c = step("lander_cones_rollout30_in_kernel",
                      lambda: lf.rollout(30, in_kernel=True), 30 * MB)
    counts = dict(fused_admm.LAUNCH_COUNTS)
    for name, arr in (("u_fixed", u_fixed), ("us_k", us_k.cpu().numpy()),
                      ("us_l", us_l.cpu().numpy()), ("us_c", us_c.cpu().numpy()),
                      ("xf_k", xf_k.cpu().numpy()), ("xf_c", xf_c.cpu().numpy())):
        assert np.isfinite(arr).all(), f"bf16x3 path: {name} not finite"
    assert u_fixed.shape == (MB, 9, 4) and us_k.shape == (70, MB, 4)
    assert us_c.shape == (30, MB, 3) and us_l.shape == (10, MB, 4)
    for name, st_ in (("solve_adaptive_check5_warm", st),
                      ("lander_cones_solve_adaptive", st_l)):
        steps[name]["converged_fraction"] = st_["converged_fraction"]
    assert st["converged_fraction"] > 0, st["converged_fraction"]
    assert st_l["converged_fraction"] > 0.5, st_l["converged_fraction"]
    names = ("fused_solve_fixed_bf16x3", "fused_solve_adaptive_bf16x3",
             "fused_rollout_bf16x3", "fused_solve_fixed_cones_bf16x3",
             "fused_solve_adaptive_cones_bf16x3", "fused_rollout_cones_bf16x3")
    for k in names:
        assert counts[k] > 0, f"bf16x3 path never launched {k}: {counts}"
    del mpc, cmpc, lf

    # ----------------------------- times beside the float32 twins, 65,536
    problem, cache, pp, x0s = flagship(MB, dev)
    cold = FusedCarry.zeros(MB, pp, device=dev)
    x1, warm = warm_start(problem, pp, x0s, dev)
    rops = rollout_ops(problem, pp, device=dev)
    lcold = FusedCarry.zeros(MB, lpp, device=dev)
    lcops = pad_cones(lpp, lcones)
    lrops = rollout_ops(lproblem, lpp, device=dev)
    K1P8 = dict(max_iter=100, check_termination=0, polish=8)
    specs = (   # key, name, replaces, run(**algo), schedule, ticks, dims
        ("K1 p8", "fused_solve_fixed_bf16x3",
         "accelerated_tinympc_tpu/ops/fused_admm.py:672",
         lambda **a: fused_solve(x0s, cold, pp, **K1P8, **a), K1P8, 0,
         pp.dims),
        ("K2", "fused_solve_adaptive_bf16x3",
         "accelerated_tinympc_tpu/ops/fused_admm.py:740",
         lambda **a: fused_solve(x1, warm, pp, **WARM_KW, **a), WARM_KW, 0,
         pp.dims),
        ("K3", "fused_rollout_bf16x3",
         "accelerated_tinympc_tpu/ops/fused_rollout.py:125",
         lambda **a: fused_rollout(x0s, cold, pp, rops, 70, **BF16X3_MISSION,
                                   **a), BF16X3_MISSION, 70, pp.dims),
        ("K4a", "fused_solve_fixed_cones_bf16x3",
         "accelerated_tinympc_tpu/ops/fused_admm.py:326",
         lambda **a: fused_solve(lx0, lcold, lpp, cone_ops=lcops,
                                 **LANDER_FIXED, **a), LANDER_FIXED, 0,
         lpp.dims),
        ("K4b", "fused_solve_adaptive_cones_bf16x3",
         "accelerated_tinympc_tpu/ops/fused_admm.py:326",
         lambda **a: fused_solve(lx0, lcold, lpp, cone_ops=lcops,
                                 **LANDER_ADAPTIVE, **a), LANDER_ADAPTIVE, 0,
         lpp.dims),
        ("K4c", "fused_rollout_cones_bf16x3",
         "accelerated_tinympc_tpu/ops/fused_admm.py:326",
         lambda **a: fused_rollout(lx0, lcold, lpp, lrops, 30, cone_ops=lcops,
                                   **LANDER_MISSION, **a), LANDER_MISSION, 30,
         lpp.dims))
    rows_out, extra_ms = [], {}
    for key, name, replaces, run, sched, ticks, dims in specs:
        # in turns: float32, split, float32 again for K1; float32 and split
        # for the rest
        f32_ms = [cuda_ms(lambda: run())]
        ms = cuda_ms(lambda: run(**BF))
        if key.startswith("K1"):
            f32_ms.append(cuda_ms(lambda: run()))
        out = run(**BF)
        its = out.iters if ticks else out.stats[:, 0]
        n_solves = MB * (ticks or 1)
        skw = {k: v for k, v in sched.items() if k in (
            "max_iter", "check_termination", "warmup_iters", "polish")}
        split = split_iters_of(its, **skw)
        bound_ms, bound_by = solve_bound(dims, float(its.sum()), n_solves, MB,
                                         ticks, split_iters=split)
        case, plain_ms = small[key]
        tile, threads, _smem, placement, ri = fused_admm._geometry(
            dims, MB, dev, None, None,
            split=fused_admm.schedule_splits("bf16x3", **skw))
        rows_out.append({
            "name": name, "route": "cuda",
            "source": "accelerated_tinympc_tpu_torch/ops/csrc/"
                      "fused_admm_bf16x3.cu",
            "replaces": replaces + " (algo='bf16x3')",
            "launches": counts[name], "max_abs_err": case["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "plain_batch": KERNEL_BATCH,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "f32_twin_ms": f32_ms, "slots": tile,
            "f32_twin_slots": fused_admm._geometry(dims, MB, dev, None,
                                                   None)[0],
            "iters_mean": float(its.float().mean()),
            "split_iters_share": split / float(its.sum()),
            "tile_threads_placement": [tile, threads, placement],
            # the split kernels run the three coned passes
            **({"cone_path": "three-pass"} if "cones" in name else {})})
    extra_ms["K1 polish=6"] = cuda_ms(lambda: fused_solve(
        x0s, cold, pp, max_iter=100, polish=6, **BF))
    extra_ms["K1 polish=8 placement=device"] = cuda_ms(lambda: fused_solve(
        x0s, cold, pp, max_iter=100, placement="device", **BF))
    extra_ms["K1 polish=100 (no split iteration)"] = cuda_ms(
        lambda: fused_solve(x0s, cold, pp, max_iter=100, polish=100, **BF))
    extra_ms["K2 warm check=5 tol=0.05"] = [cuda_ms(lambda: fused_solve(
        x1, warm, pp, **BF16X3_ADAPTIVE, **a)) for a in ({}, BF)]
    torch.cuda.synchronize()
    return ({"steps": steps, "launches": counts, "ms_more": extra_ms,
             "seconds": round(time.perf_counter() - t0, 1)}, rows_out)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device: "
                 "torch.cuda.is_available() is False")
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.api.mpc import fused_mpc_rollout
    from accelerated_tinympc_tpu_torch.ops import _build, fused_admm
    from accelerated_tinympc_tpu_torch.ops import riccati_kernel as rk
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_rollout, fused_rollout_plain, fused_solve,
        fused_solve_plain, pad_cones, pad_problem, rollout_const_seq,
        rollout_ops,
    )
    from accelerated_tinympc_tpu_torch.precompute import (
        riccati_fixed_point, riccati_newton,
    )
    from accelerated_tinympc_tpu_torch.solver.cascade import cascade_solve
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet
    from accelerated_tinympc_tpu_torch.api.mpc import fleet_mpc_rollout
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
    from accelerated_tinympc_tpu_torch.ops import FusedResult
    from accelerated_tinympc_tpu_torch.utils.profiling import (
        hetero_bound, riccati_bound, solve_bound, stream_bound,
    )

    def as_flat(res):
        """A hetero result in the fused tier's flat layout (stats' first six
        columns) on the card, so the fused comparisons and bars apply
        unchanged."""
        Bn = res.U.shape[0]
        f = lambda a: a.reshape(Bn, -1).to(dev)
        c = res.carry
        return FusedResult(U=f(res.U), X=f(res.X), carry=FusedCarry(
            D=f(c.d), Y=f(c.y), G=f(c.g), Z=f(c.z), V=f(c.v)),
            stats=res.stats[:, :6].to(dev))

    def plain_on_cpu(xs, cy, hp, **kw):
        """The float32 plain version on the CPU: the same arithmetic as on
        the card, with the CPU's BLAS grouping the products' sums."""
        cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v
        return as_flat(ha.hetero_solve_plain(
            xs.cpu(), ha.HeteroCarry(*(a.cpu() for a in cy)),
            hp.to(device="cpu"), **{k: cpu(v) for k, v in kw.items()}))

    def hetero_carry_of(fc, dims_):
        nx_, nu_, N_ = dims_
        Bn = fc.D.shape[0]
        u = lambda a: a.reshape(Bn, N_ - 1, nu_)
        x = lambda a: a.reshape(Bn, N_, nx_)
        return ha.HeteroCarry(d=u(fc.D), y=u(fc.Y), g=x(fc.G), z=u(fc.Z),
                              v=x(fc.V))

    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", kind=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---------------------------------------------------------------- build
    _build.build_all()
    ptxas = {
        name: [ln.strip() for ln in _build.build_log(name).splitlines()
               if "registers" in ln or "spill" in ln]
        for name in ("hetero_admm", "stream_admm")}
    hstream_ptxas = ptxas_per_kernel(_build.build_log("stream_admm"))
    hetero_ptxas = ptxas_per_kernel(_build.build_log("hetero_admm"))
    emit("build", seconds=round(_build.last_build_seconds, 2), ptxas=ptxas,
         hetero_kernels=hetero_ptxas,
         fused_kernels=ptxas_per_kernel(_build.build_log("fused_admm")),
         fused_bf16x3_kernels=ptxas_per_kernel(
             _build.build_log("fused_admm_bf16x3")),
         riccati_kernels=ptxas_per_kernel(_build.build_log("riccati")),
         shared_stream_kernels=ptxas_per_kernel(
             _build.build_log("stream_shared")),
         hstream_kernels=hstream_ptxas)

    # -------------------------------------------------------------- kernels
    cases = []
    problem, cache, pp, x0s = flagship(KERNEL_BATCH, dev)
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
    rops = rollout_ops(problem, pp, device=dev)
    x1, warm = warm_start(problem, pp, x0s, dev)
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
        want, plain_ms = timed(
            lambda: fused_rollout_plain(x0s, cold, pp, rops, 70, **kw))
        cases.append(compare_rollout(
            f"K3 70 ticks hovering {label}", got, want,
            kw["check_termination"]))
    k3_pre = (got, want, plain_ms)   # the adaptive mission: K3's row
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

    # ------------------------------------------------------------- slots
    # Position independence of the slot kernels: an instance's arithmetic
    # depends on its own data only (not on its slot, its block or the order
    # in which slots claim instances), so a permuted batch gives the
    # permuted result bit for bit. K2 on the warm workload above and K3 over
    # a 12-tick adaptive mission, hovering and tracking (a const_d row per
    # slot); batches smaller than one block's slots; two launches back to
    # back (the work counter starts at 0 in each). All at one launch
    # geometry (the backward product's depth split follows slots and threads).
    tile_, threads_ = fused_admm._geometry(pp.dims, B, dev, None, None)[:2]
    geo = dict(batch_tile=tile_, threads=threads_)
    perm = torch.as_tensor(np.random.default_rng(7).permutation(B),
                           device=dev)
    inv = torch.argsort(perm)
    solve_fields = lambda r: (r.U, r.X, r.stats) + tuple(r.carry)
    mission_fields = lambda r: (
        r.x_final, r.us.transpose(0, 1), r.iters.T) + solve_fields(r.final)
    kw2 = dict(max_iter=100, check_termination=1, **geo)

    def permuted_equal(fields, run, xs, cy):
        a = fields(run(xs, cy))
        b = fields(run(xs[perm], FusedCarry(*(t[perm] for t in cy))))
        return all(torch.equal(x, y[inv]) for x, y in zip(a, b))

    k2 = lambda xs, cy: fused_solve(xs, cy, pp, **kw2)
    slot_cases = {
        "K2 warm permuted": permuted_equal(solve_fields, k2, x1, warm),
        "K3 hovering 12 ticks permuted": permuted_equal(
            mission_fields, lambda xs, cy: fused_rollout(
                xs, cy, pp, rops, 12, **kw2), x0s, cold),
        "K3 tracking 12 ticks permuted": permuted_equal(
            mission_fields, lambda xs, cy: fused_rollout(
                xs, cy, tpp, trops, 12, const_seq=cs[:12], **kw2),
            tx0s, cold),
    }
    first, second = solve_fields(k2(x1, warm)), solve_fields(k2(x1, warm))
    slot_cases["K2 back to back"] = all(
        torch.equal(a, b) for a, b in zip(first, second))
    small_cases = []
    for n in (1, 5):
        xs_n, cy_n = x1[:n], FusedCarry(*(t[:n] for t in warm))
        got = k2(xs_n, cy_n)
        small_cases.append(compare_solve(
            f"K2 batch {n}", got, fused_solve_plain(
                xs_n, cy_n, pp, max_iter=100, check_termination=1),
            1, pp.rho_f))
        # the same instances inside the whole batch, bit for bit
        slot_cases[f"K2 batch {n} equals its rows of the full batch"] = all(
            torch.equal(a, b[:n]) for a, b in zip(solve_fields(got), first))
        m = fused_rollout(x0s[:n], FusedCarry(*(t[:n] for t in cold)), pp,
                          rops, 12, **kw2)
        full = fused_rollout(x0s, cold, pp, rops, 12, **kw2)
        slot_cases[f"K3 batch {n} equals its rows of the full batch"] = all(
            torch.equal(a, b[:n]) for a, b in zip(
                mission_fields(m), mission_fields(full)))
    torch.cuda.synchronize()
    emit("slots", batch=B, bit_exact=slot_cases, small_batches=small_cases)
    raise_failures(small_cases + [{"failures": [
        f"slots: {k} is not bit-exact" for k, v in slot_cases.items()
        if not v]}])

    # ---------------------------------------------------------- operators
    # The fused kernels keep the condensed operators in shared memory where
    # they fit beside one register tile of slots, else read them from
    # device memory (resident in L2). Both placements sum in the same
    # order: where both fit they give the same bits at one launch geometry
    # (K1 fixed-100 cold, K2 warm, K3 12 ticks at the flagship N=10 and at
    # N=18, the longest horizon that still fits shared memory, both at the
    # shared placement's slots and threads; the backward product's depth
    # split follows them). Past N=18 the quadrotor runs
    # only with the operators in device memory: N=20 and N=40 through
    # TinyMPC(tier="fused") -- a fixed-100 and an adaptive solve and a
    # 20-tick in-kernel mission, each against the plain version (the
    # float64 plain version arbitrates, as for the fleets, where two
    # float32 versions stray further than the bars), and the entry point's
    # results equal to the kernel's called directly; the same at N=100 and
    # N=129 (the JAX package's limit for the quadrotor), where one register
    # tile of 8 slots no longer fits shared memory and the kernels run
    # tiles of 4 (batch 1,027). At N=40 tiles of 8 and of 4 slots give the
    # same bits (K1, K2 warm, K3 12 ticks; a block of one tile, 128
    # threads). Then the N=18 solve's milliseconds in both placements at
    # batch 65,536, N=100 and N=129 at 4,099, and where choose_tile
    # refuses.
    def placement_fields(kind, run):
        out = run("shared"), run("device")
        f = solve_fields if kind == "solve" else mission_fields
        return all(torch.equal(a, b) for a, b in zip(f(out[0]), f(out[1])))

    def cuda_result(r):
        return FusedResult(U=r.U.to(dev), X=r.X.to(dev), stats=r.stats.to(dev),
                           carry=FusedCarry(*(a.to(dev) for a in r.carry)))

    op_exact, op_cases, op_ms = {}, [], {}
    for N in (10, 18):
        oprob, _oc, opp, ox = flagship(B, dev, horizon=N)
        ocold = FusedCarry.zeros(B, opp, device=dev)
        orops = rollout_ops(oprob, opp, device=dev)
        ox1, owarm = warm_start(oprob, opp, ox, dev)
        assert fused_admm.choose_placement(opp.dims) == "shared", N
        tile_o, threads_o = fused_admm._geometry(opp.dims, B, dev, None, None)[:2]
        ogeo = dict(batch_tile=tile_o, threads=threads_o)
        op_exact[f"K1 N={N}"] = placement_fields("solve", lambda pl: fused_solve(
            ox, ocold, opp, max_iter=100, placement=pl, **ogeo))
        op_exact[f"K2 warm N={N}"] = placement_fields(
            "solve", lambda pl: fused_solve(ox1, owarm, opp, placement=pl,
                                            **ogeo, **WARM_KW))
        op_exact[f"K3 12 ticks N={N}"] = placement_fields(
            "mission", lambda pl: fused_rollout(ox, ocold, opp, orops, 12,
                                                placement=pl, **ogeo,
                                                **WARM_KW))
    for N in (20, 40, 100, 129):
        oprob, ocache, ox = atm.models.quadrotor_hovering_setup(
            horizon=N, device=dev)
        OB = B if N <= 40 else 1027
        rng = np.random.default_rng(N)
        ox = torch.as_tensor(ox[None] + 0.05 * rng.standard_normal((OB, 12)),
                             dtype=torch.float32, device=dev)
        opp64 = pad_problem(oprob.to(dtype=f64), ocache.to(dtype=f64),
                            atm.condensed_operators(
                                ocache, oprob.A, oprob.B, N, dtype=f64,
                                device=dev), dtype=f64, device=dev)
        for label, settings in (
                ("fixed-100", atm.Settings(max_iter=100, check_termination=0)),
                ("adaptive", atm.Settings(max_iter=100, check_termination=1))):
            mpc = atm.TinyMPC.from_parts(oprob, ocache, tier="fused",
                                         batch=OB, settings=settings)
            mpc.set_x0(ox)
            mpc.solve()
            opp = mpc._pp
            assert fused_admm.choose_placement(opp.dims) == "device", N
            assert fused_admm.choose_register_tile(opp.dims) == (
                8 if N <= 78 else 4), N
            ocold = FusedCarry.zeros(OB, opp, device=dev)
            kw = dict(max_iter=100,
                      check_termination=settings.check_termination)
            got = mpc._fused_result
            direct = fused_solve(ox, ocold, opp, **kw)
            op_exact[f"TinyMPC {label} N={N} is the kernel"] = all(
                torch.equal(a, b) for a, b in zip(solve_fields(got),
                                                  solve_fields(direct)))
            cpu_pp = opp.to(device="cpu")
            op_cases.append(arbitrated(
                f"TinyMPC fused {label} N={N}", got,
                fused_solve_plain(ox, ocold, opp, **kw),
                fused_solve_plain(ox.double(), FusedCarry.zeros(
                    OB, opp64, f64, dev), opp64, **kw),
                kw["check_termination"], opp.rho_f,
                lambda: cuda_result(fused_solve_plain(
                    ox.cpu(), FusedCarry.zeros(OB, cpu_pp, device="cpu"),
                    cpu_pp, **kw))))
        orops = rollout_ops(oprob, opp, device=dev)
        mpc = atm.TinyMPC.from_parts(oprob, ocache, tier="fused", batch=OB,
                                     settings=atm.Settings(
                                         max_iter=100, check_termination=1))
        mpc.set_x0(ox)
        xf_m, us_m = mpc.rollout(20, in_kernel=True)
        got = fused_rollout(ox, ocold, opp, orops, 20, **WARM_KW)
        op_exact[f"TinyMPC 20 ticks N={N} is the kernel"] = bool(
            torch.equal(us_m, got.us) and torch.equal(xf_m, got.x_final))
        op_cases.append(compare_rollout(
            f"K3 20 ticks N={N}", got,
            fused_rollout_plain(ox, ocold, opp, orops, 20, **WARM_KW), 1))
        if N == 40:   # register tiles of 8 and of 4 slots, one geometry
            tgeo = lambda ri: dict(placement="device", register_tile=ri,
                                   batch_tile=ri, threads=128)
            ox1, owarm = got.x_final, got.final.carry.reset_duals()
            for label, fkind, run in (
                    ("K1", "solve", lambda ri: fused_solve(
                        ox, ocold, opp, max_iter=100, **tgeo(ri))),
                    ("K2 warm", "solve", lambda ri: fused_solve(
                        ox1, owarm, opp, **WARM_KW, **tgeo(ri))),
                    ("K3 12 ticks", "mission", lambda ri: fused_rollout(
                        ox, ocold, opp, orops, 12, **WARM_KW, **tgeo(ri)))):
                f = solve_fields if fkind == "solve" else mission_fields
                op_exact[f"{label} N=40 tiles of 8 and 4 slots"] = all(
                    torch.equal(a, b) for a, b in zip(f(run(8)), f(run(4))))
    raises_at = []
    for N in range(2, 152):
        try:
            fused_admm.choose_tile((12, 4, N), MAIN_BATCH)
        except ValueError:
            raises_at.append(N)
    for N in (18, 20, 100, 129):
        MB = MAIN_BATCH if N <= 20 else B
        _p, _c, opp, oxm = flagship(MB, dev, horizon=N)
        ocold = FusedCarry.zeros(MB, opp, device=dev)
        for pl in ("shared", "device") if N == 18 else ("device",):
            geo_ = fused_admm._geometry(opp.dims, MB, dev, None, None, 0, pl)
            op_ms[f"N={N} fixed-100 {pl}"] = {
                "ms": cuda_ms(lambda: fused_solve(oxm, ocold, opp,
                                                  max_iter=100, placement=pl)),
                "batch": MB, "tile_threads": geo_[:2],
                "register_tile": geo_[4]}
    del oxm, ocold, opp, mpc, got, direct
    torch.cuda.synchronize()
    emit("operators", batch=B, bit_exact=op_exact, cases=op_cases,
         choose_tile_raises_at=raises_at, ms_at_main_batch=op_ms)
    raise_failures(op_cases + [{"failures": [
        f"operators: {k} is not bit-exact" for k, v in op_exact.items()
        if not v]}])
    assert raises_at == [151], raises_at

    # ------------------------------------------- cones in the fused kernels
    # The powered-descent lander of examples/torch_soc_landing.py: nx=6,
    # nu=3, N=15, so Dx = 90 and Du = 42 are no multiples of the kernels'
    # float4 grid and a knot starts anywhere on it. Box-only first.
    lcones = lander_cones()

    def slack_excess(Z, V, cones, rows=None):
        """Worst cone violation of final slacks ``Z (B, N-1, nu)``,
        ``V (B, N, nx)``."""
        rows = rows or {}
        worst = -float("inf")
        for c, cone in enumerate(cones.input_cones):
            worst = max(worst, cone_excess(
                Z, cone,
                None if "cone_mu_u" not in rows else rows["cone_mu_u"][c],
                None if "cone_shift_u" not in rows else rows["cone_shift_u"][c]))
        for c, cone in enumerate(cones.state_cones):
            worst = max(worst, cone_excess(
                V, cone,
                None if "cone_mu_x" not in rows else rows["cone_mu_x"][c],
                None if "cone_shift_x" not in rows else rows["cone_shift_x"][c]))
        return worst

    def coned_case(name, got, want, check, rho, cones, nx, nu, rows=None):
        case = compare_solve(name, got, want, check, rho)
        Bn = got.carry.Z.shape[0]
        case["cone_excess"] = slack_excess(
            got.carry.Z.reshape(Bn, -1, nu), got.carry.V.reshape(Bn, -1, nx),
            cones, rows)
        if not case["cone_excess"] <= CONE_TOL:
            case["failures"].append(
                f"{name}: final slack violates a cone by {case['cone_excess']}")
        return case

    cone_cases = []
    lproblem, lcache, lpp, lx0 = lander(B, dev)
    lcold = FusedCarry.zeros(B, lpp, device=dev)
    lcops = pad_cones(lpp, lcones)
    fixed_kw, adapt_kw = LANDER_FIXED, LANDER_ADAPTIVE
    for label, kw in (("K1 lander box-only fixed-100", fixed_kw),
                      ("K2 lander box-only adaptive", adapt_kw)):
        cone_cases.append(compare_solve(
            label, fused_solve(lx0, lcold, lpp, **kw),
            fused_solve_plain(lx0, lcold, lpp, **kw),
            kw["check_termination"], lpp.rho_f))
    lin = lambda a, b: torch.linspace(a, b, B, device=dev)[None]
    per_instance = dict(cone_mu_u=lin(0.6, 1.4), cone_shift_u=lin(2.5, 3.5),
                        cone_mu_x=lin(1.5, 2.5), cone_shift_x=lin(0.05, 0.2))
    for rows_label, rows in (("static", {}), ("per-instance", per_instance)):
        for label, kw in (("K4 lander cones fixed-100", fixed_kw),
                          ("K4 lander cones adaptive", adapt_kw)):
            cone_cases.append(coned_case(
                f"{label} {rows_label}",
                fused_solve(lx0, lcold, lpp, cone_ops=lcops, **rows, **kw),
                fused_solve_plain(lx0, lcold, lpp, cone_ops=lcops, **rows,
                                  **kw),
                kw["check_termination"], lpp.rho_f, lcones, 6, 3, rows))
    # Per-instance rows that repeat the static values change nothing.
    same_rows = dict(cone_mu_u=torch.full((1, B), 1.0, device=dev),
                     cone_shift_x=torch.full((1, B), 0.1, device=dev))
    r_static = fused_solve(lx0, lcold, lpp, cone_ops=lcops, **adapt_kw)
    r_rows = fused_solve(lx0, lcold, lpp, cone_ops=lcops, **same_rows,
                         **adapt_kw)
    equal = all(torch.equal(a, b) for a, b in zip(
        (r_static.U, r_static.stats) + tuple(r_static.carry),
        (r_rows.U, r_rows.stats) + tuple(r_rows.carry)))
    cone_cases.append({
        "case": "K4 per-instance rows equal to the static values",
        "bitwise_equal": equal,
        "failures": [] if equal else ["rows equal to the static mu/shift "
                                      "changed the result"]})

    # Quadrotor (Dx = 120, knots of 12 states span three column groups)
    # with a thrust-tilt cone on the hover-relative inputs and box bounds.
    qcones = ConeSet(input_cones=(Cone(ball=(0, 1), axis=2, mu=0.4, shift=0.3),))
    qcops = pad_cones(pp, qcones)
    for label, kw in (
            ("K4 quadrotor tilt cone fixed-100", dict(max_iter=100,
                                                      check_termination=0)),
            ("K4 quadrotor tilt cone adaptive", dict(max_iter=100,
                                                     check_termination=1))):
        cone_cases.append(coned_case(
            label, fused_solve(x0s, cold, pp, cone_ops=qcops, **kw),
            fused_solve_plain(x0s, cold, pp, cone_ops=qcops, **kw),
            kw["check_termination"], pp.rho_f, qcones, 12, 4))

    # The coned in-kernel mission against its plain version and against the
    # tick loop of coned solves (one launch per tick).
    lrops = rollout_ops(lproblem, lpp, device=dev)
    mission_kw = LANDER_MISSION
    got = fused_rollout(lx0, lcold, lpp, lrops, 30, cone_ops=lcops,
                        **mission_kw)
    want, plain_ms = timed(lambda: fused_rollout_plain(
        lx0, lcold, lpp, lrops, 30, cone_ops=lcops, **mission_kw))
    k4c_pre = (got, want, plain_ms)   # K4's mission row
    cone_cases.append(compare_rollout(
        "K4 lander coned mission 30 ticks", got, want, 2, tol=1e-2))
    xf_loop, us_loop, carry_loop = fused_mpc_rollout(
        lpp, lx0, 30, problem=lproblem, cone_ops=lcops, in_kernel=False,
        **mission_kw)
    loop_err = max_err(got.us, us_loop)
    mission_excess = slack_excess(got.final.carry.Z.reshape(B, -1, 3),
                                  got.final.carry.V.reshape(B, -1, 6), lcones)
    cone_cases.append({
        "case": "K4 coned mission in one launch vs tick loop of coned solves",
        "us_err_all_instances": loop_err, "cone_excess": mission_excess,
        "x_final_err": max_err(got.x_final, xf_loop),
        # all instances, so the bar is the mission's: twice the exit tolerance
        "failures": ([] if loop_err <= 2e-2 else
                     [f"mission vs tick loop: controls off by {loop_err}"])
        + ([] if mission_excess <= CONE_TOL else
           [f"mission: final slack violates a cone by {mission_excess}"])})

    # Both coned paths of the float32 kernels give the same bits: the fused
    # cone pass (the forward stage's pass over whole knots) and the three
    # coned passes (fused_admm.FUSED_CONES off; the split kernels' path).
    # Each case names the path it took (fused: the cases above took it too,
    # at this batch's slots).
    ten_cones_q = ConeSet(
        input_cones=tuple(Cone((i,), (i + 1) % 4, 2.0, 1.0)
                          for i in range(4)),
        state_cones=(Cone(tuple(range(10)), 10, 5.0, 1.0),)
        + tuple(Cone((k,), k + 1, 3.0, 2.0) for k in range(5)))
    tcops = pad_cones(pp, ten_cones_q)

    def paths_case(name, run, dims, cops, ncp=0):
        tile, _t, _s, _p, ri = fused_admm._geometry(dims, B, dev, None, None,
                                                    ncp)
        path = fused_admm.cone_path(dims, tile, ri, cops)
        fused = run()
        fused_admm.FUSED_CONES = False
        try:
            three = run()
        finally:
            fused_admm.FUSED_CONES = True
        bad = _unequal(fused, three)
        return {"case": f"{name}: fused cone pass vs three passes",
                "path": path, "slots": tile, "unequal_fields": bad,
                "failures": ([f"{name}: {bad} differ between the paths"]
                             if bad else [])
                + ([] if path == "fused" else
                   [f"{name}: took the {path} path"])}

    for label, kw in (("fixed-100", fixed_kw), ("adaptive", adapt_kw)):
        cone_cases.append(paths_case(
            f"K4 lander {label}",
            lambda: fused_solve(lx0, lcold, lpp, cone_ops=lcops, **kw),
            lpp.dims, lcops))
    cone_cases.append(paths_case(
        "K4 lander adaptive per-instance",
        lambda: fused_solve(lx0, lcold, lpp, cone_ops=lcops, **per_instance,
                            **adapt_kw), lpp.dims, lcops, ncp=2))
    cone_cases.append(paths_case(
        "K4 quadrotor tilt cone adaptive",
        lambda: fused_solve(x0s, cold, pp, cone_ops=qcops, max_iter=100,
                            check_termination=1), pp.dims, qcops))
    cone_cases.append(paths_case(
        "K4 quadrotor ten cones fixed-30",
        lambda: fused_solve(x0s, cold, pp, cone_ops=tcops, max_iter=30),
        pp.dims, tcops))
    cone_cases.append(paths_case(
        "K4 lander coned mission 30 ticks",
        lambda: fused_rollout(lx0, lcold, lpp, lrops, 30, cone_ops=lcops,
                              **mission_kw), lpp.dims, lcops))
    torch.cuda.synchronize()
    emit("kernels_cones", batch=B, cases=cone_cases)
    raise_failures(cone_cases)

    # ------------------------------------------------------ Riccati kernels
    def plants(batch, nx, nu, seed=0):
        """Random plants scaled to spectral radius 0.95 (so K0 = 0
        stabilises them), random positive cost diagonals and rho."""
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((batch, nx, nx))
        A *= (0.95 / np.abs(np.linalg.eigvals(A)).max(axis=1))[:, None, None]
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        return (t(A), t(rng.standard_normal((batch, nx, nu))),
                t(rng.uniform(0.5, 5.0, (batch, nx))),
                t(rng.uniform(0.5, 5.0, (batch, nu))),
                t(rng.uniform(0.5, 5.0, batch)))

    def compare_cache(name, got, want, it_got, it_want, rows=None,
                      count_bar="equal"):
        """Kernel cache vs plain cache: 1e-4 relative to each field's largest
        entry (coeff_d2p vanishes at the fixed point: relative to Pinf's, the
        size of its two terms), on the instances whose step counts agree.
        ``count_bar="equal"``: counts equal on AGREE_SOLVE of the instances,
        never off by more than one step. ``"near"``: counts within one step
        on AGREE_SOLVE of the instances, the worst reported (a plant whose
        max|dK| falls slowly past the tolerance: a rounding difference moves
        the crossing by a step more often, and by several where it falls
        slowest). ``"none"`` (the quadrotor's plant at the default tolerance
        1e-5): in float32 its max|dK| stops falling at 1e-5..1e-4, by rho
        (float64 reaches 1e-13; tools/torch_riccati_floor.py), so the step that dips under 1e-5 and ends
        the loop is rounding noise and two float32 implementations stop far
        apart, at the same fixed point: the values are then held on *all*
        instances, the counts are reported, and the stop itself is held by
        ``stop_check`` and by the count cases at tolerance 1e-3 below."""
        diff = (it_got - it_want).abs()
        same = diff == 0 if count_bar != "none" else torch.ones_like(
            it_got, dtype=torch.bool)
        if rows is not None:
            same = same & rows
        agree = float((diff == 0).float().mean())
        near = float((diff <= 1).float().mean())
        worst = int(diff.max())
        errs, fails = {}, []
        for k, v in want.tensors().items():
            ref = want.Pinf if k == "coeff_d2p" else v
            scale = max(1.0, float(ref[same].abs().max()))
            errs[k] = max_err(getattr(got, k), v, same) / scale
            if not (np.isfinite(errs[k]) and errs[k] <= VAL_TOL):
                fails.append(f"{name}: {k} relative err {errs[k]} > {VAL_TOL}")
        if count_bar == "equal" and agree < AGREE_SOLVE:
            fails.append(f"{name}: step counts agree on {agree:.4f}")
        if count_bar == "equal" and worst > 1:
            fails.append(f"{name}: step counts off by {worst}")
        if count_bar == "near" and near < AGREE_SOLVE:
            fails.append(f"{name}: step counts within one on {near:.4f}")
        return {"case": name, "max_abs_err": max(errs.values()), "errs": errs,
                "iters_agree": agree, "iters_within_one": near,
                "iters_worst": worst,
                "iters_mean": float(it_got.float().mean()),
                "iters_mean_plain": float(it_want.float().mean()),
                "failures": fails}

    # The plain versions with their step counts: the batched tensor code
    # of precompute.py at the kernels' defaults.
    def fixed_point_plain(*a, tol=1e-5, **kw):
        return riccati_fixed_point(*a, max_iters=1000, tol=tol, **kw)

    def newton_plain(*a, tol=1e-5):
        return riccati_newton(*a, tol=tol, max_outer=12, inner_iters=13)

    # Flagship sizes and a random_lti shape (lane-group instantiations),
    # then sizes past the lane-group list (the general kernel, any size
    # shared memory takes).
    ric_cases = []
    for shape in ((12, 4), (6, 8), (17, 9), (24, 10), (32, 12)):
        P = plants(B, *shape, seed=shape[0])
        got, it_g = rk.riccati_fixed_point_kernel(*P)
        want, it_w = fixed_point_plain(*P)
        ric_cases.append(compare_cache(
            f"K5 fixed point cold {shape}", got, want, it_g, it_w))
        ric_cases[-1]["plan"] = rk.kernel_plan(*shape)._asdict()
        ric_cases[-1]["kernel_ms"] = cuda_ms(
            lambda: rk.riccati_fixed_point_kernel(*P))
        # warm start at a rho five times larger, as an adaptive-rho refresh
        rho2 = P[4] * 5.0
        warm, it_g = rk.riccati_fixed_point_kernel(
            *P[:4], rho2, P0=got.Pinf, K0=got.Kinf)
        want, it_w = fixed_point_plain(*P[:4], rho2, P0=got.Pinf, K0=got.Kinf)
        ric_cases.append(compare_cache(
            f"K5 fixed point warm {shape}", warm, want, it_g, it_w))
        K0 = got.Kinf.clone()
        K0[7] = -50.0 * K0[7] + 3.0       # does not stabilise plant 7
        ok = torch.ones(B, dtype=torch.bool, device=dev)
        ok[7] = False
        newt, it_g = rk.riccati_newton_kernel(*P[:4], rho2, K0)
        want, it_w = newton_plain(*P[:4], rho2, K0)
        case = compare_cache(
            f"K6 newton warm {shape}", newt, want, it_g, it_w, ok)
        # Newton lands on the fixed point the warm fixed-point kernel reaches
        case["kinf_vs_fixed_point"] = max_err(newt.Kinf, warm.Kinf, ok)
        if not case["kinf_vs_fixed_point"] <= 1e-3:
            case["failures"].append(
                f"newton Kinf {case['kinf_vs_fixed_point']} from the fixed "
                "point's")
        bad_finite = bool(torch.isfinite(newt.Kinf[7]).all())
        rest_finite = all(bool(torch.isfinite(v[ok]).all())
                          for v in newt.tensors().values())
        case["bad_gain_row_nonfinite"] = not bad_finite
        if bad_finite or not rest_finite:
            case["failures"].append(
                "a non-stabilising K0 must come back non-finite, and only it")
        ric_cases.append(case)

    # The quadrotor's plant once per instance, rho over six decades: the
    # adaptive-rho path's data. At the default tolerance 1e-5 float32
    # rounding decides the stopping step there (see compare_cache), so the
    # counts and the freeze at convergence are held at 1e-3, ten times
    # above that floor, within one step (at 1e-4 they agree on 29-76 %, off
    # by up to 13 of 47 steps: measured, with equal means).
    def quad_plants(batch):
        prob = atm.models.quadrotor_hovering_setup(device=dev)[0]
        wide = lambda a: a.expand((batch,) + tuple(a.shape)).contiguous()
        return (wide(prob.A), wide(prob.B), wide(prob.Q), wide(prob.R),
                torch.logspace(-3, 3, batch, device=dev))

    QUAD_TOL = 1e-3
    P = quad_plants(B)
    got, it_g = rk.riccati_fixed_point_kernel(*P, tol=QUAD_TOL)
    want, it_w = fixed_point_plain(*P, tol=QUAD_TOL)
    ric_cases.append(compare_cache(
        "K5 quadrotor plant cold tol=1e-3", got, want, it_g, it_w,
        count_bar="near"))
    rho2 = P[4] * 5.0
    warm, it_g = rk.riccati_fixed_point_kernel(
        *P[:4], rho2, tol=QUAD_TOL, P0=got.Pinf, K0=got.Kinf)
    want, it_w = fixed_point_plain(*P[:4], rho2, tol=QUAD_TOL, P0=got.Pinf,
                                   K0=got.Kinf)
    ric_cases.append(compare_cache(
        "K5 quadrotor plant warm tol=1e-3", warm, want, it_g, it_w,
        count_bar="near"))
    newt, it_g = rk.riccati_newton_kernel(*P[:4], rho2, got.Kinf,
                                          tol=QUAD_TOL)
    want, it_w = newton_plain(*P[:4], rho2, got.Kinf, tol=QUAD_TOL)
    ric_cases.append(compare_cache(
        "K6 quadrotor plant tol=1e-3", newt, want, it_g, it_w,
        count_bar="near"))
    torch.cuda.synchronize()
    emit("kernels_riccati", batch=B, cases=ric_cases)
    raise_failures(ric_cases)

    # ------------------------------------- heterogeneous plants: K7 and K8
    # Three families at the comparison batch, each kernel against its plain
    # version under the bars above: (a) the robust sweep's (the quadrotor's
    # plant perturbed elementwise by 3 %, examples/robust_plant_sweep.py),
    # (b) examples/fleet_sweep.py's (64 random plants nx=8, nu=3, inputs in
    # [-2, 2], a thrust cone with per-instance mu and, for half the fleet,
    # the axis on another input), (c) a ragged shape (nx=5, nu=2, N=7).
    def fleet_family(batch, seed=0):
        from accelerated_tinympc_tpu_torch.models import random_lti_problem

        ps = [random_lti_problem(s, 8, 3, 10, device=dev)[0]
              for s in range(64)]
        reps = -(-batch // 64)
        tile = lambda f: torch.cat([torch.stack([f(p) for p in ps])] * reps)[
            :batch].contiguous()
        inf = float("inf")
        full = lambda v, *s: torch.full((batch,) + s, v, device=dev)
        prob_b = atm.Problem(
            A=tile(lambda p: p.A), B=tile(lambda p: p.B),
            Q=tile(lambda p: p.Q), R=tile(lambda p: p.R),
            u_min=full(-2.0, 9, 3), u_max=full(2.0, 9, 3),
            x_min=full(-inf, 10, 8), x_max=full(inf, 10, 8),
            Xref=full(0.0, 10, 8), Uref=full(0.0, 9, 3))
        rng = np.random.default_rng(seed)
        x0s_ = torch.as_tensor(0.5 * rng.standard_normal((batch, 8)),
                               dtype=torch.float32, device=dev)
        mu = torch.as_tensor(0.6 + 0.8 * np.random.default_rng(42).random(
            batch), dtype=torch.float32, device=dev)
        h = batch // 2
        ball = np.zeros((batch, 3), np.float32)
        ball[:h, [0, 1]] = 1.0
        ball[h:, [1, 2]] = 1.0
        axis = np.full(batch, 2, np.int64)
        axis[h:] = 0
        cones = ConeSet(input_cones=(Cone((0, 1), 2, 1.0, 2.0),))
        cone_kw = dict(
            cones=cones,
            cone_params=ha.pad_hetero_cone_params(cones, batch, mu_u=mu[None],
                                                  device=dev),
            cone_masks=ha.pad_hetero_cone_masks(
                cones, batch, 8, 3, ball_u=[ball], axis_u=[axis],
                device=dev),
            en_state_bound=False)
        geometry = (torch.as_tensor(ball, device=dev),
                    torch.as_tensor(axis, device=dev), mu, 2.0)
        return prob_b, torch.ones(batch, device=dev), x0s_, cone_kw, geometry

    def ragged_family(batch, seed=3):
        A_, B_, Q_, R_, rho_ = plants(batch, 5, 2, seed=seed)
        rng = np.random.default_rng(seed)
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        lim = t(0.5 + rng.random((batch, 6, 2)))
        prob_b = atm.Problem(
            A=A_, B=B_, Q=Q_, R=R_, u_min=-lim, u_max=lim,
            x_min=t(np.full((batch, 7, 5), -5.0)),
            x_max=t(np.full((batch, 7, 5), 5.0)),
            Xref=t(0.1 * rng.standard_normal((batch, 7, 5))),
            Uref=t(np.zeros((batch, 6, 2))))
        return prob_b, rho_, t(rng.standard_normal((batch, 5)))

    def hetero_of(prob_b, rho):
        return ha.pad_hetero_from_plants(prob_b.A, prob_b.B, prob_b.Q,
                                         prob_b.R, rho, prob_b)[0]

    def random_fleet(batch, nx, nu, N, seed):
        """Random plants of any size (spectral radius 0.95), per-instance
        input bounds, a small reference, caches from the batched tensor
        code; ``(hp, x0s)``."""
        A_, B_, Q_, R_, rho_ = plants(batch, nx, nu, seed=seed)
        rng = np.random.default_rng(seed)
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        lim = t(0.5 + rng.random((batch, N - 1, nu)))
        prob_b = atm.Problem(
            A=A_, B=B_, Q=Q_, R=R_, u_min=-lim, u_max=lim,
            x_min=t(np.full((batch, N, nx), -5.0)),
            x_max=t(np.full((batch, N, nx), 5.0)),
            Xref=t(0.1 * rng.standard_normal((batch, N, nx))),
            Uref=t(np.zeros((batch, N - 1, nu))))
        hp = ha.pad_hetero_from_plants(A_, B_, Q_, R_, rho_, prob_b,
                                       riccati="vmap")[0]
        return hp, t(rng.standard_normal((batch, nx)))

    # ten cones, one with a ten-entry ball (the cones overlap, so their
    # composition is held against the plain version only)
    ten_cones = ConeSet(
        input_cones=tuple(Cone((i,), (i + 1) % 4, 2.0, 1.0)
                          for i in range(4)),
        state_cones=(Cone(tuple(range(10)), 10, 5.0, 1.0),)
        + tuple(Cone((k,), k + 1, 3.0, 2.0) for k in range(5)))

    def geometry_excess(Z, geometry):
        """Worst violation of per-instance cones on slacks ``Z (B, K, nu)``:
        ball mask ``(B, nu)``, axis index ``(B,)``, mu ``(B,)``, shift."""
        bm, ax, mu, shift = geometry
        a = torch.sqrt(((Z * bm[:, None, :]) ** 2).sum(-1))
        s = Z.gather(2, ax[:, None, None].expand(-1, Z.shape[1], 1))[..., 0]
        return float((a - mu[:, None] * (s + shift)).max())

    def plain_mission(hp, prob_b, xs, ticks, **kw):
        """fleet_mpc_rollout with the plain version in place of the kernel."""
        cy = ha.HeteroCarry.zeros(hp)
        mv = lambda M, v: torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)
        us = []
        for _ in range(ticks):
            res = ha.hetero_solve_plain(xs, cy.reset_duals(), hp, **kw)
            cy = res.carry
            us.append(res.U[:, 0])
            xs = mv(prob_b.A, xs) + mv(prob_b.B, res.U[:, 0])
        return xs, torch.stack(us), cy

    het_cases = []
    fam_a = robust_family(B)
    hp_a = hetero_of(fam_a[0], fam_a[1])
    fam_b = fleet_family(B)
    hp_b = hetero_of(fam_b[0], fam_b[1])
    fam_c = ragged_family(B)
    hp_c = hetero_of(fam_c[0], fam_c[1])
    # warm start of family (a): twelve adaptive ticks of the plain mission
    xa_w, _us, ca_w = plain_mission(hp_a, fam_a[0], fam_a[2], 12,
                                    max_iter=100, check_termination=1)
    # (d, e) past the old lane groups (the run-time body: a lane owns 2 and
    # 3 of the 52 and 66 rows) and (f) ten cones on the compiled 12/4 body,
    # random plants, 40 iterations
    hp_d, xs_d = random_fleet(B, 40, 12, 10, seed=5)
    hp_e, xs_e = random_fleet(B, 33, 33, 10, seed=6)
    hp_f, xs_f = random_fleet(B, 12, 4, 10, seed=7)
    hcases = [("a robust 12/4/10", hp_a, fam_a[2], {}, None, None),
              ("a robust 12/4/10 warm", hp_a, xa_w, {}, ca_w.reset_duals(),
               None),
              ("b fleet_sweep 8/3/10 cones", hp_b, fam_b[2], fam_b[3], None,
               fam_b[4]),
              ("c ragged 5/2/7", hp_c, fam_c[2], {}, None, None),
              ("d random 40/12/10", hp_d, xs_d, {}, None, None),
              ("e random 33/33/10", hp_e, xs_e, {}, None, None),
              ("f random 12/4/10 ten cones", hp_f, xs_f,
               {"cones": ten_cones}, None, None)]
    for label, hp, xs, extra, cy, geometry in hcases:
        cy = ha.HeteroCarry.zeros(hp) if cy is None else cy
        rho_max = float(hp.rho.max())
        it = 40 if label[0] in "def" else 100
        modes = [(f"K7 fixed-{it}", dict(max_iter=it), 0),
                 ("K8 check=1", dict(max_iter=it, check_termination=1,
                                     abs_pri_tol=1e-3, abs_dua_tol=1e-3), 1),
                 ("K8 check=5", dict(max_iter=it, check_termination=5,
                                     abs_pri_tol=1e-3, abs_dua_tol=1e-3), 5)]
        if label.endswith("warm"):
            modes = modes[1:2]
        hp64 = hp.to(dtype=torch.float64)
        cy64 = ha.HeteroCarry(*(a.double() for a in cy))
        for mode, kw, check in modes:
            got = ha.hetero_solve(xs, cy, hp, **kw, **extra)
            want = ha.hetero_solve_plain(xs, cy, hp, **kw, **extra)
            extra64 = {k: (v.double() if isinstance(v, torch.Tensor) else v)
                       for k, v in extra.items()}
            ref64 = ha.hetero_solve_plain(xs.double(), cy64, hp64, **kw,
                                          **extra64)
            case = arbitrated(
                f"{mode} {label}", as_flat(got), as_flat(want),
                as_flat(ref64), check, rho_max,
                lambda: plain_on_cpu(xs, cy, hp, **kw, **extra),
                max_iter=kw["max_iter"])
            case["solved_share"] = float(got.stats[:, 1].mean())
            case["plan"] = ha.hetero_plan(*hp.dims, nc=len(
                extra["cones"].input_cones) + len(extra["cones"].state_cones)
                if "cones" in extra else 0, adaptive=check > 0)
            if geometry is not None:
                case["cone_excess"] = geometry_excess(got.carry.z, geometry)
                if not case["cone_excess"] <= CONE_TOL:
                    case["failures"].append(
                        f"{mode} {label}: final slack violates its cone by "
                        f"{case['cone_excess']}")
            het_cases.append(case)
    # K7/K8's slot refills: a batch a quarter past the instances the card
    # holds at once (the compiled 12/4 body on the robust family, the
    # run-time one at 33/33/10), so slots retire and take new instances
    # from the work counter; against the plain version, and a permuted
    # batch bit for bit
    for label, dims_r in (("12/4/10", (12, 4, 10)), ("33/33/10",
                                                      (33, 33, 10))):
        slots = ha.hetero_slots(*dims_r)
        RB = slots + slots // 4
        if dims_r[0] == 12:
            fr = robust_family(RB, seed=4)
            hp_r, xs_r = hetero_of(fr[0], fr[1]), fr[2]
        else:
            hp_r, xs_r = random_fleet(RB, *dims_r, seed=8)
        cy_r = ha.HeteroCarry.zeros(hp_r)
        perm_r = torch.as_tensor(np.random.default_rng(8).permutation(RB),
                                 device=dev)
        inv_r = torch.argsort(perm_r)
        hp_p, cy_p, xs_p, _cp, _cm = ha.gather_hetero(hp_r, cy_r, xs_r,
                                                      perm_r)
        fields = lambda r: (r.U, r.X, r.stats) + tuple(r.carry)
        for mode, kw, check in (
                ("K7 fixed-40", dict(max_iter=40), 0),
                ("K8 check=1", dict(max_iter=100, check_termination=1,
                                    abs_pri_tol=1e-3, abs_dua_tol=1e-3), 1)):
            got = ha.hetero_solve(xs_r, cy_r, hp_r, **kw)
            want = ha.hetero_solve_plain(xs_r, cy_r, hp_r, **kw)
            ref64 = lambda: as_flat(ha.hetero_solve_plain(
                xs_r.double(), ha.HeteroCarry(*(a.double() for a in cy_r)),
                hp_r.to(dtype=torch.float64), **kw))
            case = arbitrated(
                f"{mode} slot refills {label}", as_flat(got), as_flat(want),
                ref64, check, float(hp_r.rho.max()),
                lambda: plain_on_cpu(xs_r, cy_r, hp_r, **kw),
                max_iter=kw["max_iter"])
            again = ha.hetero_solve(xs_p, cy_p, hp_p, **kw)
            exact = all(torch.equal(a, b[inv_r]) for a, b in zip(
                fields(got), fields(again)))
            its = got.stats[:, 0]
            case.update(slots=slots, batch=RB, refills=RB - slots,
                        permuted_bit_exact=exact,
                        iters_min=float(its.min()),
                        iters_max=float(its.max()))
            if not exact:
                case["failures"].append(f"{mode} slot refills {label}: a "
                                        "permuted batch changes the results")
            het_cases.append(case)
        del hp_r, xs_r, cy_r, hp_p, cy_p, xs_p
    torch.cuda.synchronize()
    emit("kernels_hetero", batch=B, cases=het_cases)
    raise_failures(het_cases)

    # K7/K8 against K1/K2: every instance with the quadrotor's plant and
    # cache, the same x0s, the same carries (the cheapest proof that K7 is
    # the reference's ADMM, not only equal to its own plain version).
    wide = lambda a: a.expand((B,) + tuple(a.shape)).contiguous()
    hp_q = ha.pad_hetero_problem(
        atm.Problem(**{k: wide(v) for k, v in problem.tensors().items()}),
        atm.Cache(**{k: wide(v) for k, v in cache.tensors().items()}))
    xs_f = x0s
    lead_f = fused_rollout(xs_f, cold, pp, rops, 12, max_iter=100,
                           check_termination=1)
    x1_f, warm_f = lead_f.x_final, lead_f.final.carry.reset_duals()
    vs_fused = []
    for label, xs, fcarry, kw, check in (
            ("K7 vs K1 fixed-100 cold", xs_f, cold,
             dict(max_iter=100, check_termination=0), 0),
            ("K8 vs K2 check=1 cold", xs_f, cold,
             dict(max_iter=100, check_termination=1), 1),
            ("K8 vs K2 check=1 warm", x1_f, warm_f,
             dict(max_iter=100, check_termination=1), 1)):
        hcarry = hetero_carry_of(fcarry, (12, 4, 10))
        got = ha.hetero_solve(xs, hcarry, hp_q, **kw)
        vs_fused.append(arbitrated(
            label, as_flat(got), fused_solve(xs, fcarry, pp, **kw),
            plain64(xs, fcarry, **kw), check, pp.rho_f,
            lambda: plain_on_cpu(xs, hcarry, hp_q, **kw)))
    torch.cuda.synchronize()
    emit("hetero_vs_fused", batch=B, cases=vs_fused)
    raise_failures(vs_fused)

    # Each kernel at the main path's shapes: time and bound at batch 65,536;
    # the comparison with the plain version, and the plain version's time,
    # at the comparison batch (the plain versions are thousands of small
    # launches, seconds at 65,536).
    small_problem, small_cache, small_pp, xs_s = flagship(KERNEL_BATCH, dev)
    cold_s = FusedCarry.zeros(KERNEL_BATCH, pp, device=dev)
    problem, cache, pp, x0s = flagship(MAIN_BATCH, dev)
    rops = rollout_ops(problem, pp, device=dev)
    cold = FusedCarry.zeros(MAIN_BATCH, pp, device=dev)
    dims = pp.dims
    kernels = []

    def kernel_row(name, replaces, run_main, small, compare, iters_of,
                   n_solves, ticks=0, dims=dims, bound=None,
                   source="fused_admm.cu", long_plain=False):
        """``small = (kernel, plain)`` at the comparison batch: compared, and
        the plain version timed there (or ``(got, want, plain_ms)`` of an
        earlier phase's comparison on the same inputs); ``run_main`` is the
        kernel at the main batch, timed, and its iteration counts give the
        bound. ``long_plain``: a plain version of seconds is timed on the
        compared run instead of a second one."""
        if callable(small[0]):
            got = small[0]()
            want, plain_ms = timed(small[1])
        else:
            got, want, plain_ms = small
            long_plain = True
        cmp_ = compare(got, want)
        emit("kernel_at_main_shape", **cmp_)
        raise_failures([cmp_])
        if not long_plain:
            plain_ms = timed(small[1])[1]
        ms = cuda_ms(run_main)
        main_out = run_main()
        if bound is None:
            bound_ms, bound_by = solve_bound(
                dims, float(iters_of(main_out)), n_solves, MAIN_BATCH, ticks)
        else:
            bound_ms, bound_by = bound(main_out)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "accelerated_tinympc_tpu_torch/ops/csrc/" + source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": cmp_["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "plain_batch": KERNEL_BATCH,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "iters_mean": float(iters_of(main_out)) / n_solves,
        })

    kw1 = dict(max_iter=100, check_termination=0)
    kernel_row(
        "fused_solve_fixed",
        "accelerated_tinympc_tpu/ops/fused_admm.py:672",
        lambda: fused_solve(x0s, cold, pp, **kw1),
        (lambda: fused_solve(xs_s, cold_s, pp, **kw1),
         lambda: fused_solve_plain(xs_s, cold_s, pp, **kw1)),
        lambda g, w: compare_solve("K1 main shape", g, w, 0, pp.rho_f),
        lambda g: g.stats[:, 0].sum(), MAIN_BATCH)
    # K1's path at the main batch (its own body, csrc/fixed_waves.cuh, or
    # the shared slot body), its slots a block, threads and registers, and
    # the two bodies bit for bit at the comparison batch and at the main one
    # (same geometry; at the main batch each block of the own body runs
    # several waves)
    k1_tile, k1_threads, _s, _p, k1_ri = fused_admm._geometry(
        dims, MAIN_BATCH, dev, None, None)
    k1_path = fused_admm.fixed_path(dims, k1_tile, k1_threads, k1_ri)
    # the instantiation: K1's own body compiled for these widths and depth
    # split (<GOPS, RI, waves, DuP, DzP, H>), else its run-time one
    k1_rows = [r for r in ptxas_per_kernel(_build.build_log("fused_admm"))
               if r["kernel"].startswith("fused_solve_fixed_kernel<0,8,1,")]
    k1_split = fused_admm.backward_split(dims, k1_tile, k1_threads, k1_ri)
    k1_regs = [r for r in k1_rows if r["kernel"] == (
        "fused_solve_fixed_kernel<0,8,1,%d,%d,%d>"
        % (*pp.W_f.shape, k1_split))] or [
        r for r in k1_rows if r["kernel"].endswith(",0,0,0>")]
    k1_bits = {}
    for flag in (True, False):
        fused_admm.FIXED_WAVES = flag
        k1_bits[flag] = []
        for x, c in ((xs_s, cold_s), (x0s, cold)):
            r = fused_solve(x, c, pp, **kw1)
            k1_bits[flag] += [r.U, r.X, r.stats, *r.carry]
    fused_admm.FIXED_WAVES = True
    k1_same = all(torch.equal(a, b)
                  for a, b in zip(k1_bits[True], k1_bits[False]))
    kernels[-1].update(
        path=k1_path, slots=k1_tile, threads=k1_threads,
        kernel=k1_regs[0]["kernel"] if k1_regs else None,
        registers=k1_regs[0].get("registers") if k1_regs else None,
        spill_stores=k1_regs[0].get("spill_stores") if k1_regs else None,
        paths_bit_exact=k1_same)
    emit("k1_paths", batches=[KERNEL_BATCH, MAIN_BATCH], path=k1_path,
         bit_exact=k1_same, ptxas=k1_regs)
    assert k1_path == "waves", f"K1 at the main batch takes {k1_path}"
    assert k1_same, "K1's two bodies disagree"
    del k1_bits
    kw2 = WARM_KW
    x1, warm = warm_start(problem, pp, x0s, dev)
    x1_s, warm_s = warm_start(problem, pp, xs_s, dev)
    kernel_row(
        "fused_solve_adaptive",
        "accelerated_tinympc_tpu/ops/fused_admm.py:740",
        lambda: fused_solve(x1, warm, pp, **kw2),
        (lambda: fused_solve(x1_s, warm_s, pp, **kw2),
         lambda: fused_solve_plain(x1_s, warm_s, pp, **kw2)),
        lambda g, w: compare_solve("K2 main shape", g, w, 1, pp.rho_f),
        lambda g: g.stats[:, 0].sum(), MAIN_BATCH)
    # The compaction cascade on K2's workload, taken apart: the first
    # segment on the whole batch, the rest of the budget on the survivors
    # alone (compacted) and on the whole batch from the first segment's carry
    # (what the kernel's own per-instance exit makes of the same work), and
    # what the cascade spends between its launches (clones, index_select,
    # index_copy_, the host's read of the solved column).
    seg = 25
    first = fused_solve(x1, warm, pp, max_iter=seg, check_termination=1)
    keep = torch.nonzero(first.stats[:, 1] < 0.5)[:, 0]
    xs_sv = x1.index_select(0, keep)
    cy_sv = FusedCarry(*(a.index_select(0, keep) for a in first.carry))
    cascade_kw = dict(max_iter=100, check_termination=1, segment_iters=seg)
    segments = []
    casc = cascade_solve(x1, warm, pp, trace=segments, **cascade_kw)
    mono = fused_solve(x1, warm, pp, **kw2)
    same = casc.stats[:, 0] == mono.stats[:, 0]
    split = {
        "segments": segments, "survivors": int(keep.numel()),
        "iters_agree": float(same.float().mean()),
        "solved_agree": float(
            (casc.stats[:, 1] == mono.stats[:, 1]).float().mean()),
        "u_err_same_schedule": max_err(casc.U, mono.U, same),
        "plain_ms": kernels[-1]["ms"],
        "first_segment_ms": cuda_ms(lambda: fused_solve(
            x1, warm, pp, max_iter=seg, check_termination=1)),
        "rest_on_survivors_ms": cuda_ms(lambda: fused_solve(
            xs_sv, cy_sv, pp, max_iter=100 - seg, check_termination=1)),
        "rest_on_whole_batch_ms": cuda_ms(lambda: fused_solve(
            x1, first.carry, pp, max_iter=100 - seg, check_termination=1)),
        "cascade_ms": cuda_ms(
            lambda: cascade_solve(x1, warm, pp, **cascade_kw)),
    }
    split["between_launches_ms"] = (
        split["cascade_ms"] - split["first_segment_ms"]
        - split["rest_on_survivors_ms"])
    emit("cascade_split_at_main_shape", **split)
    # The survivors run in other blocks and at another tile, which regroups
    # the backward product's partial sums: the bars are the kernels' own.
    assert split["iters_agree"] >= AGREE_SOLVE, split
    assert split["solved_agree"] >= AGREE_SOLVE, split
    assert split["u_err_same_schedule"] <= VAL_TOL, split
    assert len(segments) > 1 and segments[-1][1] < MAIN_BATCH, segments
    del first, casc, mono, xs_sv, cy_sv

    kernel_row(
        "fused_rollout",
        "accelerated_tinympc_tpu/ops/fused_rollout.py:125",
        lambda: fused_rollout(x0s, cold, pp, rops, 70, **kw2), k3_pre,
        lambda g, w: compare_rollout("K3 main shape", g, w, 1),
        lambda g: g.iters.sum(), 70 * MAIN_BATCH, ticks=70, long_plain=True)

    # K4 (the coned instantiations) at the lander fleet's shapes, and the
    # box-only kernels at the same shapes beside them, for the cones' cost.
    lx0_s, lcold_s = lx0, lcold
    lproblem, lcache, lpp, lx0 = lander(MAIN_BATCH, dev)
    lcold = FusedCarry.zeros(MAIN_BATCH, lpp, device=dev)
    lcops = pad_cones(lpp, lcones)
    lrops = rollout_ops(lproblem, lpp, device=dev)
    ldims = lpp.dims
    cone_ref = "accelerated_tinympc_tpu/ops/fused_admm.py:326"
    ltile, _t, _s, _p, lri = fused_admm._geometry(ldims, MAIN_BATCH, dev, None,
                                                  None)
    # each K4 row with its slots a block, the path of its slack stage and
    # its box-only twin's time (the same schedule, no cones) from this call
    cone_row = dict(slots=ltile,
                    cone_path=fused_admm.cone_path(ldims, ltile, lri, lcops))
    box_ms = {}
    for label, kw in (("fixed", fixed_kw), ("adaptive", adapt_kw)):
        box_ms[label] = cuda_ms(lambda: fused_solve(lx0, lcold, lpp, **kw))
        kernel_row(
            f"fused_solve_{label}_cones", cone_ref,
            lambda: fused_solve(lx0, lcold, lpp, cone_ops=lcops, **kw),
            (lambda: fused_solve(lx0_s, lcold_s, lpp, cone_ops=lcops, **kw),
             lambda: fused_solve_plain(lx0_s, lcold_s, lpp, cone_ops=lcops,
                                       **kw)),
            lambda g, w: coned_case(
                f"K4 {label} main shape", g, w, kw["check_termination"],
                lpp.rho_f, lcones, 6, 3),
            lambda g: g.stats[:, 0].sum(), MAIN_BATCH, dims=ldims)
        kernels[-1].update(cone_row, box_only_ms=box_ms[label])
    box_ms["rollout"] = cuda_ms(
        lambda: fused_rollout(lx0, lcold, lpp, lrops, 30, **mission_kw))
    kernel_row(
        "fused_rollout_cones", cone_ref,
        lambda: fused_rollout(lx0, lcold, lpp, lrops, 30, cone_ops=lcops,
                              **mission_kw),
        k4c_pre,
        lambda g, w: compare_rollout("K4 mission main shape", g, w, 2,
                                     tol=1e-2),
        lambda g: g.iters.sum(), 30 * MAIN_BATCH, ticks=30, dims=ldims,
        long_plain=True)
    kernels[-1].update(cone_row, box_only_ms=box_ms["rollout"])
    emit("cones_cost_at_main_shape", box_only_ms=box_ms,
         coned_ms={r["name"]: r["ms"] for r in kernels[-3:]}, **cone_row)

    # K5, K6 at the shapes the adaptive-rho path gives them: the quadrotor's
    # plant once per instance, rho mis-scaled over six decades (cold build),
    # then the refresh at rho five times larger from the converged cache.
    qA, qB, qQ, qR, qrho = quad_plants(MAIN_BATCH)
    sA, sB, sQ, sR, srho = quad_plants(KERNEL_BATCH)
    q64 = tuple(a.double() for a in (sA, sB, sQ, sR))

    def stop_residual(cache, newton):
        """max|dK| per instance of one more step, taken in float64, from the
        iterate a float32 run stopped at: what its stopping test would have
        read without rounding."""
        rho, K = cache.rho.double(), cache.Kinf.double()
        if newton:
            nxt = riccati_newton(*q64, rho, K, tol=0.0, max_outer=1,
                                 inner_iters=13)[0]
        else:
            nxt = riccati_fixed_point(*q64, rho, max_iters=1, tol=0.0,
                                      P0=cache.Pinf.double(), K0=K)[0]
        return (nxt.Kinf - K).abs().amax(dim=(-2, -1))

    def stop_check(case, name, g, w, newton, cap, tol=1e-5):
        """The kernel froze each instance at a converged step, not before:
        on the instances that stopped under the cap, its float64 stop
        residual is within three times the tolerance, or within twice the
        largest stop residual of the plain version on the same data (the
        float32 rounding level of this recursion, measured)."""
        r_k, r_p = stop_residual(g[0], newton), stop_residual(w[0], newton)
        done_k, done_p = g[1] < cap, w[1] < cap
        bar = max(3 * tol, 2 * float(r_p[done_p].max()))
        case["stop_residual_float64"] = {
            "kernel_max": float(r_k[done_k].max()),
            "kernel_median": float(r_k[done_k].median()),
            "plain_f32_max": float(r_p[done_p].max()),
            "plain_f32_median": float(r_p[done_p].median()),
            "bar": bar,
            "at_cap_share": {"kernel": float((~done_k).float().mean()),
                             "plain_f32": float((~done_p).float().mean())}}
        if not float(r_k[done_k].max()) <= bar:
            case["failures"].append(
                f"{name}: stopped at a float64 max|dK| of "
                f"{float(r_k[done_k].max())} > {bar}")

    def cache_row(name, newton, cap):
        """compare_cache without the count bar but with ``stop_check``, plus
        (information) how far each float32 Kinf sits from the float64
        Newton-Kleinman solution started at the kernel's own gain: the
        distance a truncated float32 fixed point keeps from the true one,
        the same for both versions."""
        def compare(g, w):
            case = compare_cache(name, g[0], w[0], g[1], w[1],
                                 count_bar="none")
            stop_check(case, name, g, w, newton, cap)
            truth = riccati_newton(*q64, g[0].rho.double(),
                                   g[0].Kinf.double(), tol=1e-10)[0].Kinf
            case["kinf_vs_float64_newton"] = {
                "kernel": max_err(g[0].Kinf, truth),
                "plain_f32": max_err(w[0].Kinf, truth)}
            return case
        return compare
    kernel_row(
        "riccati_fixed_point", "accelerated_tinympc_tpu/ops/riccati_kernel.py:191",
        lambda: rk.riccati_fixed_point_kernel(qA, qB, qQ, qR, qrho),
        (lambda: rk.riccati_fixed_point_kernel(sA, sB, sQ, sR, srho),
         lambda: fixed_point_plain(sA, sB, sQ, sR, srho)),
        cache_row("K5 main shape", False, 1000),
        lambda g: g[1].float().sum(), MAIN_BATCH,
        source="riccati.cu", long_plain=True,
        bound=lambda g: riccati_bound(12, 4, float(g[1].sum()), MAIN_BATCH))
    base_cache = rk.riccati_cache_kernel(qA, qB, qQ, qR, qrho)
    base_s = rk.riccati_cache_kernel(sA, sB, sQ, sR, srho)
    qrho2, srho2 = qrho * 5.0, srho * 5.0
    kernel_row(
        "riccati_newton", "accelerated_tinympc_tpu/ops/riccati_kernel.py:295",
        lambda: rk.riccati_newton_kernel(
            qA, qB, qQ, qR, qrho2, base_cache.Kinf),
        (lambda: rk.riccati_newton_kernel(sA, sB, sQ, sR, srho2,
                                          base_s.Kinf),
         lambda: newton_plain(sA, sB, sQ, sR, srho2, base_s.Kinf)),
        cache_row("K6 main shape", True, 12),
        lambda g: g[1].float().sum(), MAIN_BATCH,
        source="riccati.cu",
        bound=lambda g: riccati_bound(12, 4, float(g[1].sum()), MAIN_BATCH,
                                      inner=13))
    warm_fp = lambda: rk.riccati_fixed_point_kernel(
        qA, qB, qQ, qR, qrho2, P0=base_cache.Pinf, K0=base_cache.Kinf)
    emit("riccati_refresh_at_main_shape", newton_ms=kernels[-1]["ms"],
         warm_fixed_point_ms=cuda_ms(warm_fp),
         warm_fixed_point_steps_mean=float(warm_fp()[1].float().mean()))
    del qA, qB, qQ, qR, q64, base_cache, base_s

    # K7, K8 on the robust sweep's family: fixed-100 cold, and adaptive
    # (check 1, tol 1e-3) warm after a 12-tick adaptive fleet mission.
    fam_m = robust_family(MAIN_BATCH)
    hp_m = hetero_of(fam_m[0], fam_m[1])
    hdims = (12, 4, 10)
    hcold_m = ha.HeteroCarry.zeros(hp_m)
    hcold_s = ha.HeteroCarry.zeros(hp_a)
    hp_a64 = hp_a.to(dtype=torch.float64)
    hcold_s64 = ha.HeteroCarry.zeros(hp_a64)
    kh7 = dict(max_iter=100)
    kernel_row(
        "hetero_solve_fixed", "accelerated_tinympc_tpu/ops/hetero_admm.py:700",
        lambda: ha.hetero_solve(fam_m[2], hcold_m, hp_m, **kh7),
        (lambda: ha.hetero_solve(fam_a[2], hcold_s, hp_a, **kh7),
         lambda: ha.hetero_solve_plain(fam_a[2], hcold_s, hp_a, **kh7)),
        lambda g, w: arbitrated(
            "K7 main shape", as_flat(g), as_flat(w), as_flat(
                ha.hetero_solve_plain(fam_a[2].double(), hcold_s64, hp_a64,
                                      **kh7)), 0, float(hp_a.rho.max()),
            lambda: plain_on_cpu(fam_a[2], hcold_s, hp_a, **kh7)),
        lambda g: g.stats[:, 0].sum(), MAIN_BATCH, source="hetero_admm.cu",
        bound=lambda g: hetero_bound(hdims, float(g.stats[:, 0].sum()),
                                     MAIN_BATCH))
    kh8 = dict(max_iter=100, check_termination=1, abs_pri_tol=1e-3,
               abs_dua_tol=1e-3)
    xm_w, _us, cm_w = fleet_mpc_rollout(hp_m, fam_m[0], fam_m[2], 12, **kh8)
    xs_w, _us, cs_w = fleet_mpc_rollout(hp_a, fam_a[0], fam_a[2], 12, **kh8)
    cm_w, cs_w = cm_w.reset_duals(), cs_w.reset_duals()
    kernel_row(
        "hetero_solve_adaptive",
        "accelerated_tinympc_tpu/ops/hetero_admm.py:766",
        lambda: ha.hetero_solve(xm_w, cm_w, hp_m, **kh8),
        (lambda: ha.hetero_solve(xs_w, cs_w, hp_a, **kh8),
         lambda: ha.hetero_solve_plain(xs_w, cs_w, hp_a, **kh8)),
        lambda g, w: arbitrated(
            "K8 main shape", as_flat(g), as_flat(w), as_flat(
                ha.hetero_solve_plain(
                    xs_w.double(), ha.HeteroCarry(*(a.double() for a in cs_w)),
                    hp_a64, **kh8)), 1, float(hp_a.rho.max()),
            lambda: plain_on_cpu(xs_w, cs_w, hp_a, **kh8)),
        lambda g: g.stats[:, 0].sum(), MAIN_BATCH, source="hetero_admm.cu",
        bound=lambda g: hetero_bound(hdims, float(g.stats[:, 0].sum()),
                                     MAIN_BATCH))
    # K7/K8's geometry: registers, blocks an SM, the slots the card holds
    # and the refills a batch of 65,536 takes
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for row_, adaptive in ((kernels[-2], False), (kernels[-1], True)):
        plan = ha.hetero_plan(*hdims, adaptive=adaptive)
        per_sm = ha.hetero_resident(*hdims, adaptive=adaptive)
        slots = per_sm * n_sm * plan["instances_per_block"]
        label = f"hetero_kernel<12,4,{int(adaptive)},0>"
        row_.update(
            registers=next((r.get("registers") for r in hetero_ptxas
                            if r["kernel"] == label), None),
            threads_per_block=plan["threads"],
            instances_per_block=plan["instances_per_block"],
            resident_blocks_per_sm=per_sm, slots=slots,
            refills=max(0, MAIN_BATCH - slots))
    del fam_m, hp_m, hcold_m, xm_w, cm_w

    # ------------------------------------------------------------ main path
    def solver():
        prob, cch, x0 = atm.models.quadrotor_hovering_setup()
        mpc = atm.TinyMPC.from_parts(
            prob, cch, tier="fused", batch=MAIN_BATCH,
            settings=atm.Settings(max_iter=100, check_termination=0))
        rng = np.random.default_rng(0)
        mpc.set_x0(x0[None] + 0.05 * rng.standard_normal((MAIN_BATCH, 12)))
        return mpc

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
    for k in ("fused_solve_fixed", "fused_solve_adaptive", "fused_rollout"):
        assert counts[k] > 0, f"main path never launched {k}: {counts}"
    for row in kernels:
        if row["name"] in counts and "cones" not in row["name"]:
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
         golden_tracking_adaptive_max_err=golden_track)

    # ---------------------------------------------------------- second path
    # Cones, the compaction cascade and adaptive rho through TinyMPC at
    # batch 65,536. Counts set to 0 just before, read just after.
    fleet_settings = atm.Settings(max_iter=300, check_termination=2,
                                  **LANDER_TOL)

    def lander_fleet():
        fleet = atm.TinyMPC.from_parts(
            lproblem, lcache, tier="fused", batch=MAIN_BATCH, cones=lcones,
            settings=fleet_settings)
        fleet.set_x0(lx0)
        return fleet

    def quad_fleet(segment):
        prob, cch, x0 = atm.models.quadrotor_hovering_setup()
        mpc = atm.TinyMPC.from_parts(
            prob, cch, tier="fused", batch=MAIN_BATCH,
            compaction_segment=segment,
            settings=atm.Settings(max_iter=100, check_termination=1))
        rng = np.random.default_rng(0)
        mpc.set_x0(x0[None] + 0.05 * rng.standard_normal((MAIN_BATCH, 12)))
        return mpc

    lander_fleet().solve()   # warm-up of the coned path
    fused_admm.reset_launch_counts()
    rk.reset_launch_counts()
    steps2 = {}

    def step2(name, fn, n_solves):
        out, ms = timed(fn)
        steps2[name] = {"ms": ms, "solves_per_s": n_solves / ms * 1e3}
        return out

    def fleet_excess_of(fleet):
        z, v = fleet.get_slacks()
        return slack_excess(torch.as_tensor(z), torch.as_tensor(v), lcones)

    fleet = lander_fleet()
    st_cone = step2("lander_cones_solve_adaptive", fleet.solve, MAIN_BATCH)
    steps2["lander_cones_solve_adaptive"].update(
        converged_fraction=st_cone["converged_fraction"],
        iterations_mean=st_cone["iterations_mean"])
    fleet_excess = fleet_excess_of(fleet)
    fleet.settings = fleet.settings.replace(max_iter=100, check_termination=0)
    fleet.reset_duals()
    step2("lander_cones_solve_fixed100", fleet.solve, MAIN_BATCH)
    u_cone = fleet.get_u()
    fleet = lander_fleet()
    fleet.settings = fleet.settings.replace(max_iter=100)
    xf_c, us_c = step2("lander_cones_rollout30_in_kernel",
                       lambda: fleet.rollout(30, in_kernel=True),
                       30 * MAIN_BATCH)
    mission_excess2 = fleet_excess_of(fleet)
    assert np.isfinite(u_cone).all() and u_cone.shape == (MAIN_BATCH, 14, 3)
    assert bool(torch.isfinite(xf_c).all() and torch.isfinite(us_c).all())
    assert us_c.shape == (30, MAIN_BATCH, 3)
    assert st_cone["converged_fraction"] > 0.5, st_cone["converged_fraction"]
    assert fleet_excess <= CONE_TOL and mission_excess2 <= CONE_TOL, (
        fleet_excess, mission_excess2)
    # the fleet flies to the pad: closer than it started, on average
    d0 = float(lx0[:, :3].norm(dim=1).mean())
    d1 = float(xf_c[:, :3].norm(dim=1).mean())
    assert d1 < d0, (d0, d1)
    del fleet

    # Compaction cascade against the plain adaptive solve on the warm
    # quadrotor workload (a 12-tick mission first, then one adaptive solve).
    results = {}
    for label, segment in (("plain", 0), ("cascade", 25)):
        # Three times from the same warm start, the last one kept: the first
        # two also pay for the allocator's first blocks at the survivors'
        # batch sizes.
        earlier_ms = []
        for rep in range(3):
            mpc = quad_fleet(segment)
            mpc.rollout(12, in_kernel=True)
            mpc.reset_duals()
            if rep < 2:
                earlier_ms.append(timed(mpc.solve)[1])
        st = step2(f"quad_warm_adaptive_{label}", mpc.solve, MAIN_BATCH)
        steps2[f"quad_warm_adaptive_{label}"]["earlier_calls_ms"] = earlier_ms
        results[label] = (st, mpc.get_u())
    it_p, it_c = results["plain"][0]["iterations"], results["cascade"][0]["iterations"]
    same = it_p == it_c
    cascade = {
        "iters_agree": float(same.mean()),
        "solved_agree": float((results["plain"][0]["solved"]
                               == results["cascade"][0]["solved"]).mean()),
        "iterations_mean": float(it_c.mean()),
        "u_err_same_schedule": float(np.abs(
            results["plain"][1][same] - results["cascade"][1][same]).max()),
        "plain_ms": steps2["quad_warm_adaptive_plain"]["ms"],
        "cascade_ms": steps2["quad_warm_adaptive_cascade"]["ms"],
    }
    assert cascade["iters_agree"] >= AGREE_SOLVE, cascade
    assert cascade["solved_agree"] >= AGREE_SOLVE, cascade
    assert cascade["u_err_same_schedule"] <= VAL_TOL, cascade
    del results, mpc

    # Per-instance adaptive rho on mis-scaled penalties (a third each at
    # rho, rho / 1000 and rho * 200) through TinyMPC.solve_adaptive_rho:
    # fixed-point refreshes (K5) at the full batch, Newton refreshes (K6) at
    # the comparison batch.
    adaptive = {}
    for riccati, batch in (("kernel", MAIN_BATCH), ("newton", KERNEL_BATCH)):
        prob, cch, x0 = atm.models.quadrotor_hovering_setup()
        mpc = atm.TinyMPC.from_parts(
            prob, cch, batch=batch,
            settings=atm.Settings(abs_pri_tol=1e-2, abs_dua_tol=1e-2,
                                  check_termination=1))
        # around the hover reference: at a good rho these solves converge
        # inside the budget, at a mis-scaled one they do not
        rng = np.random.default_rng(0)
        mpc.set_x0(prob.Xref[0].cpu().numpy()[None]
                   + 0.2 * rng.standard_normal((batch, 12)))
        rho0 = float(cch.rho) * np.tile(
            [1.0, 1e-3, 200.0], batch // 3 + 1)[:batch].astype(np.float32)
        st = step2(f"quad_solve_adaptive_rho_{riccati}",
                   lambda: mpc.solve_adaptive_rho(
                       riccati=riccati, rho0=rho0, max_rounds=12), batch)
        res = mpc.adaptive_rho_result
        adaptive[riccati] = {
            "batch": batch,
            "ms": steps2[f"quad_solve_adaptive_rho_{riccati}"]["ms"],
            "rounds": st["rounds"],
            "converged_fraction": st["converged_fraction"],
            "iterations_mean": float(st["iterations"].mean()),
            "rho_changed_fraction": float((st["rho"] != rho0).mean()),
        }
        assert bool(torch.isfinite(res.state.U).all())
        assert bool(torch.isfinite(res.cache.Kinf).all())
        assert adaptive[riccati]["converged_fraction"] > 0.9, adaptive
        assert adaptive[riccati]["rho_changed_fraction"] > 0.2, adaptive
        del res, mpc

    counts2 = dict(fused_admm.LAUNCH_COUNTS)
    counts2.update(rk.LAUNCH_COUNTS)
    for k in ("fused_solve_fixed_cones", "fused_solve_adaptive_cones",
              "fused_rollout_cones", "riccati_fixed_point", "riccati_newton"):
        assert counts2[k] > 0, f"second path never launched {k}: {counts2}"
    for row in kernels:
        if "cones" in row["name"] or row["name"].startswith("riccati"):
            row["launches"] = counts2[row["name"]]
    emit("second_path", batch=MAIN_BATCH, steps=steps2, launches=counts2,
         quad_solve_adaptive_rho_kernel_ms=adaptive["kernel"]["ms"],
         cone_excess={"solve": fleet_excess, "mission": mission_excess2},
         mission_mean_distance={"start": d0, "end": d1},
         cascade=cascade, adaptive_rho=adaptive)


    # ----------------------------------------------------------- third path
    # The path's 20-tick fleet mission at the comparison batch against its
    # plain version, before the path's counts start (the fused missions'
    # bar: all instances' controls within twice the exit tolerance).
    mission_hkw = dict(max_iter=100, check_termination=1, abs_pri_tol=1e-3,
                       abs_dua_tol=1e-3)
    xf_k, us_k, _ = fleet_mpc_rollout(hp_a, fam_a[0], fam_a[2], 20,
                                      **mission_hkw)
    xf_p, us_p, _ = plain_mission(hp_a, fam_a[0], fam_a[2], 20,
                                  **mission_hkw)
    mission3 = {"us_err_all_instances": max_err(us_k, us_p),
                "x_final_err": max_err(xf_k, xf_p)}
    assert mission3["us_err_all_instances"] <= 2e-3, mission3

    # Heterogeneous-plant fleets through TinyMPCFleet at batch 65,536: the
    # robust sweep's family with box bounds, then adaptive rho at 16,384.
    # Counts set to 0 just before, read just after.
    ha.reset_launch_counts()
    rk.reset_launch_counts()
    fused_admm.reset_launch_counts()
    steps3 = {}

    def step3(name, fn, n_solves, **info):
        out, ms = timed(fn)
        steps3[name] = {"ms": ms, "solves_per_s": n_solves / ms * 1e3,
                        **info}
        return out

    prob_m, rho_m, x0_m = robust_family(MAIN_BATCH, seed=5)
    bounds = dict(u_min=prob_m.u_min[:, 0], u_max=prob_m.u_max[:, 0],
                  x_min=prob_m.x_min[:, 0], x_max=prob_m.x_max[:, 0])
    fixed_settings = atm.Settings(max_iter=100, check_termination=0)
    fleet = step3("setup_riccati_k5", lambda: atm.TinyMPCFleet.setup(
        prob_m.A, prob_m.B, prob_m.Q, prob_m.R, rho_m, 10, polish=False,
        settings=fixed_settings, **bounds), MAIN_BATCH)
    from accelerated_tinympc_tpu_torch.precompute import riccati_polish_f64

    polished = step3("setup_polish_float64", lambda: riccati_polish_f64(
        fleet.cache, prob_m.A, prob_m.B, prob_m.Q, prob_m.R, rho_m),
        MAIN_BATCH)
    polish_moved = max_err(polished.Kinf, fleet.cache.Kinf)
    fleet.cache = polished          # set_xref rebuilds the operands from it
    fleet.set_xref(prob_m.Xref)     # hover at the quadrotor's reference
    fleet.set_x0(x0_m)
    launches_at = lambda: {**ha.LAUNCH_COUNTS, **rk.LAUNCH_COUNTS}
    step3("solve_fixed100", fleet.solve, MAIN_BATCH)
    u_fixed3 = fleet.get_u()
    fleet.settings = fleet.settings.replace(
        check_termination=1, abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    fleet.reset_duals()
    # a solve replaces the fleet's carry and never writes into it, so a
    # shallow copy starts the cascade from the same warm carry
    twin = copy.copy(fleet)
    twin.compaction_segment = 25
    st_plain = step3("solve_adaptive_warm", fleet.solve, MAIN_BATCH)
    u_plain = fleet.get_u()
    st_casc = step3("solve_adaptive_warm_cascade25", twin.solve, MAIN_BATCH)
    u_casc = twin.get_u()
    for name, st in (("solve_adaptive_warm", st_plain),
                     ("solve_adaptive_warm_cascade25", st_casc)):
        steps3[name].update(converged_fraction=st["converged_fraction"],
                            iterations_mean=st["iterations_mean"])
    cascade3 = {
        "iters_equal": bool((st_plain["iterations"]
                             == st_casc["iterations"]).all()),
        "u_bitwise_equal": bool(torch.equal(u_plain, u_casc)),
    }
    assert cascade3["iters_equal"] and cascade3["u_bitwise_equal"], cascade3
    del twin

    # 20-tick adaptive mission (check 1, tol 1e-3), one K8 launch per tick.
    hp_fleet = ha.pad_hetero_problem(fleet.problem, fleet.cache)
    xf3, us3, _cy = step3("fleet_mpc_rollout20", lambda: fleet_mpc_rollout(
        hp_fleet, fleet.problem, x0_m, 20, **mission_hkw), 20 * MAIN_BATCH)
    steps3["fleet_mpc_rollout20"]["ms_per_tick"] = (
        steps3["fleet_mpc_rollout20"]["ms"] / 20)

    # Online model drift: every plant moves by 0.003 (elementwise, normal),
    # Newton refresh from the current gains (K6), fixed-point fallback (K5)
    # where the old gain no longer stabilises.
    rng = np.random.default_rng(9)
    drift = lambda a: a + torch.as_tensor(
        0.003 * rng.standard_normal(tuple(a.shape)), dtype=torch.float32,
        device=dev)
    A_d, B_d = drift(fleet.problem.A), drift(fleet.problem.B)
    step3("set_plants_newton", lambda: fleet.set_plants(A=A_d, B=B_d),
          MAIN_BATCH)
    steps3["set_plants_newton"]["fallback_count"] = fleet.fallback_count
    assert bool(torch.isfinite(fleet.cache.Kinf).all())
    fleet.set_x0(x0_m)
    st_drift = step3("solve_adaptive_after_drift", fleet.solve, MAIN_BATCH)
    steps3["solve_adaptive_after_drift"].update(
        converged_fraction=st_drift["converged_fraction"])
    counts3 = launches_at()

    # Adaptive rho at 16,384: the hetero engine (K8 chunks, K6 refreshes)
    # against the einsum engine (batched tensor chunks, K5 refreshes), a
    # third each at rho, rho / 1000 and 200 rho.
    RHO_BATCH = 16384
    prob_r, rho_r, _x0r = robust_family(RHO_BATCH, seed=6)
    hov = atm.models.quadrotor_hovering_setup(device=dev)[0].Xref[0]
    x0_r = hov[None] + 0.2 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((RHO_BATCH, 12)),
        dtype=torch.float32, device=dev)
    rho0 = rho_r * torch.as_tensor(np.tile(
        [1.0, 1e-3, 200.0], RHO_BATCH // 3 + 1)[:RHO_BATCH],
        dtype=torch.float32, device=dev)
    rbounds = dict(u_min=prob_r.u_min[:, 0], u_max=prob_r.u_max[:, 0],
                   x_min=prob_r.x_min[:, 0], x_max=prob_r.x_max[:, 0])
    adaptive3 = {}
    for engine in ("hetero", "einsum"):
        f = atm.TinyMPCFleet.setup(
            prob_r.A, prob_r.B, prob_r.Q, prob_r.R, rho0, 10, polish=False,
            settings=atm.Settings(abs_pri_tol=1e-2, abs_dua_tol=1e-2,
                                  check_termination=1), **rbounds)
        f.set_xref(prob_r.Xref)
        f.set_x0(x0_r)
        res, ms = timed(lambda: f.solve_adaptive_rho(engine=engine,
                                                     max_rounds=12))
        adaptive3[engine] = {
            "batch": RHO_BATCH, "ms": ms, "rounds": res["rounds"],
            "converged_fraction": float(res["solved"].mean()),
            "iterations_mean": float(res["iterations"].mean()),
            "rho_changed_fraction": float(
                (res["rho"] != rho0.cpu().numpy()).mean())}
        assert bool(torch.isfinite(f.get_u()).all())
        assert adaptive3[engine]["converged_fraction"] > 0.5, adaptive3
        del f
    # the two engines take the same decisions up to float32 knife edges
    assert abs(adaptive3["hetero"]["converged_fraction"]
               - adaptive3["einsum"]["converged_fraction"]) <= 0.02, adaptive3
    counts3_rho = launches_at()

    for name, arr in (("u_fixed", u_fixed3), ("u_adapt", u_plain),
                      ("us_mission", us3), ("x_mission", xf3)):
        assert bool(torch.isfinite(arr).all()), f"third path: {name}"
    assert u_fixed3.shape == (MAIN_BATCH, 9, 4)
    assert us3.shape == (20, MAIN_BATCH, 4)
    assert st_plain["converged_fraction"] > 0, "no instance converged"
    for k in ("hetero_solve_fixed", "hetero_solve_adaptive",
              "riccati_fixed_point", "riccati_newton"):
        assert counts3_rho[k] > 0, f"third path never launched {k}"
    for row in kernels:
        if row["name"].startswith("hetero"):
            row["launches"] = counts3_rho[row["name"]]
    emit("third_path", batch=MAIN_BATCH, steps=steps3,
         launches_fleet=counts3, launches_with_adaptive_rho=counts3_rho,
         polish_moved_kinf=polish_moved, cascade=cascade3, mission=mission3,
         adaptive_rho=adaptive3)

    # ====================================================== long horizons
    # K9-K12 (csrc/stream_shared.cu, csrc/stream_admm.cu) against their
    # plain versions at batch 1,027 (not a multiple of any block), with the
    # float64 plain version as arbiter where float32 itself strays (cold
    # long-horizon transients amplify rounding through the clips). The
    # plain version issues ~20
    # small launches per knot (~25 us each, measured: 8.0 s for 25
    # iterations at N=1024), so the comparisons run 20 iterations at N=1024
    # (adaptive: up to 20) and 30 at N=256 (adaptive: up to 40).
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa
    from accelerated_tinympc_tpu_torch.solver.cascade import (
        stream_cascade_solve,
    )

    SB = 1027
    LONG_BATCH = 8192
    T_LONG = time.perf_counter()

    def spread_x0(batch, nx, scales, seed=1):
        rng = np.random.default_rng(seed)
        sc = np.resize(np.asarray(scales, np.float64), batch)[:, None]
        return torch.as_tensor(sc * rng.standard_normal((batch, nx)),
                               dtype=torch.float32, device=dev)

    def to64(a):
        return a.double() if isinstance(a, torch.Tensor) else a

    def stream_case(name, solve, plain, ops, xs, cy, check, rho, **kw):
        """Kernel against the plain version on the card, arbitrated by the
        float64 plain version (and the float32 one on the CPU where the
        kernel-vs-plain bars are missed). Returns the case, the kernel's
        result and the plain version's milliseconds."""
        got = solve(xs, cy, ops, **kw)
        want, ms = timed(lambda: plain(xs, cy, ops, **kw))
        ref64 = lambda: as_flat(plain(
            xs.double(), sa.StreamCarry(*(a.double() for a in cy)),
            ops.to(dtype=torch.float64),
            **{k: to64(v) for k, v in kw.items()}))
        cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v
        case = arbitrated(
            name, as_flat(got), as_flat(want), ref64, check, rho,
            lambda: as_flat(plain(xs.cpu(), sa.StreamCarry(
                *(a.cpu() for a in cy)), ops.to(device="cpu"),
                **{k: cpu(v) for k, v in kw.items()})),
            max_iter=kw["max_iter"])
        case["solved_share"] = float(got.stats[:, 1].mean())
        case["plain_ms"] = ms
        return case, got, ms

    str_cases = []
    plain_ms4 = {}
    akw = lambda it, check, tol: dict(max_iter=it, check_termination=check,
                                      abs_pri_tol=tol, abs_dua_tol=tol)
    # K9/K10 at the example's shape (8, 3, N=1024), x0 of three scales so
    # the input bounds bind and the exits spread
    prob_l, cache_l = long_plant(1024)
    sp_l = sa.pad_stream_problem(prob_l, cache_l)
    xs_l = spread_x0(SB, 8, (0.3, 3.0, 10.0))
    cold_l = sa.StreamCarry.zeros(SB, sp_l)
    rho_l = float(sp_l.rho)
    for label, kw, check in (("K9 fixed-20", dict(max_iter=20), 0),
                             ("K10 check=5", akw(20, 5, 1e-3), 5)):
        case, got, ms = stream_case(
            f"{label} example 8/3/1024", sa.stream_solve,
            sa.stream_solve_plain, sp_l, xs_l, cold_l, check, rho_l, **kw)
        str_cases.append(case)
        plain_ms4[label.split()[0]] = (case, ms, kw["max_iter"])
    # knot_block has no effect in the CUDA kernels: bit for bit at 8, 16, 64
    kb = [sa.stream_solve(xs_l, cold_l, sp_l, knot_block=k, **akw(60, 5, 1e-3))
          for k in (8, 16, 64)]
    kb_same = all(torch.equal(r.U, kb[0].U) and torch.equal(r.stats,
                                                            kb[0].stats)
                  and all(torch.equal(a, b) for a, b in zip(r.carry,
                                                            kb[0].carry))
                  for r in kb[1:])
    # per-knot bound schedules, and the lander's shape with both cones
    prob_k, cache_k = long_plant(256, knot=True)
    sp_k = sa.pad_stream_problem(prob_k, cache_k)
    assert sp_k.has_knot_bounds
    xs_k = spread_x0(SB, 8, (0.3, 3.0, 10.0), seed=2)
    str_cases.append(stream_case(
        "K9 fixed-30 per-knot bounds 8/3/256", sa.stream_solve,
        sa.stream_solve_plain, sp_k, xs_k, sa.StreamCarry.zeros(SB, sp_k), 0,
        float(sp_k.rho), max_iter=30)[0])
    I3 = np.eye(3)
    lmpc = atm.TinyMPC.setup(
        np.block([[I3, 0.1 * I3], [0 * I3, I3]]),
        np.vstack([0.005 * I3, 0.1 * I3]),
        np.concatenate([np.full(3, 10.0), np.full(3, 1.0)]), np.full(3, 1.0),
        1.0, 256, u_min=-10.0, u_max=10.0, x_min=-100.0, x_max=100.0,
        device=dev)
    sp_c = sa.pad_stream_problem(lmpc.problem, lmpc.cache)
    rng = np.random.default_rng(3)
    xs_c = torch.as_tensor(np.asarray([3.0, -2.0, 6.0, 1.0, 0.5, -1.0])[None]
                           + 0.3 * rng.standard_normal((SB, 6)),
                           dtype=torch.float32, device=dev)
    cold_c = sa.StreamCarry.zeros(SB, sp_c)
    for label, kw, check in (
            ("K9 fixed-30", dict(max_iter=30), 0),
            ("K10 check=2", dict(akw(40, 2, 1e-2)), 2)):
        case, got, _ms = stream_case(
            f"{label} lander 6/3/256 cones", sa.stream_solve,
            sa.stream_solve_plain, sp_c, xs_c, cold_c, check,
            float(sp_c.rho), cones=lcones, **kw)
        case["cone_excess"] = slack_excess(got.carry.z, got.carry.v, lcones)
        if not case["cone_excess"] <= CONE_TOL:
            case["failures"].append(f"{label} lander: final slack violates "
                                    f"a cone by {case['cone_excess']}")
        str_cases.append(case)
    # K9/K10 past the old lane groups: random plants at (40, 12, 64) and
    # (33, 33, 16) (csrc/stream_shared.cu's run-time body), and ten cones,
    # one with a ten-entry ball, on a random 12/4 plant at N=64 (the cones
    # overlap, so their composition is held against the plain version
    # only); the plan (body, knots per staged block, shared memory) beside
    for label, (wx, wu, wN), extra in (
            ("random 40/12/64", (40, 12, 64), {}),
            ("random 33/33/16", (33, 33, 16), {}),
            ("random 12/4/64 ten cones", (12, 4, 64), {"cones": ten_cones})):
        wprob, wrho = atm.models.random_lti_problem(5, wx, wu, wN, device=dev)
        spw = sa.pad_stream_problem(wprob, atm.riccati_cache(
            wprob.A, wprob.B, wprob.Q, wprob.R, wrho, device=dev))
        xs_w = spread_x0(SB, wx, (0.3, 1.0, 3.0), seed=4)
        plan = sa.shared_plan(wx, wu, wN, nc=10 if extra else 0)
        for mode, kw, check in (("K9 fixed-20", dict(max_iter=20), 0),
                                ("K10 check=5", akw(20, 5, 1e-3), 5)):
            case, got, _ms = stream_case(
                f"{mode} {label}", sa.stream_solve, sa.stream_solve_plain,
                spw, xs_w, sa.StreamCarry.zeros(SB, spw), check,
                float(spw.rho), **kw, **extra)
            case["plan"] = plan
            str_cases.append(case)
    # K11/K12 past the old lane groups too (the run-time body: a lane owns
    # 2 and 3 of the 52 and 66 rows): a fleet of the same random plants with
    # A perturbed by 1 % per instance, caches from the batched tensor code
    for label, (wx, wu, wN) in (("random 40/12/64", (40, 12, 64)),
                                ("random 33/33/16", (33, 33, 16))):
        wprob, wrho = atm.models.random_lti_problem(5, wx, wu, wN, device=dev)
        rng = np.random.default_rng(9)
        wide = lambda a: a.expand((SB,) + tuple(a.shape)).contiguous()
        wprob_b = atm.Problem(**{k: wide(v)
                                 for k, v in wprob.tensors().items()})
        wprob_b = wprob_b.replace(A=wprob_b.A * torch.as_tensor(
            1.0 + 0.01 * rng.standard_normal((SB, wx, wx)),
            dtype=torch.float32, device=dev))
        hspw = hs.pad_hstream_from_plants(
            wprob_b.A, wprob_b.B, wprob_b.Q, wprob_b.R,
            torch.full((SB,), float(wrho), device=dev), wprob_b,
            riccati="vmap")[0]
        xs_w = spread_x0(SB, wx, (0.3, 1.0, 3.0), seed=4)
        plan = sa.hstream_plan(wx, wu, wN)
        for mode, kw, check in (("K11 fixed-20", dict(max_iter=20), 0),
                                ("K12 check=5", akw(20, 5, 1e-3), 5)):
            case, got, _ms = stream_case(
                f"{mode} {label}", hs.hstream_solve, hs.hstream_solve_plain,
                hspw, xs_w, sa.StreamCarry.zeros(SB, hspw), check,
                float(hspw.rho.max()), **kw)
            case["plan"] = plan
            str_cases.append(case)
    # K10's slot refills: a batch a quarter past the slots the card holds at
    # once (the compiled 8/3 body; the run-time body at 33/33, one block an
    # SM), so slots retire and take new instances from the work counter;
    # the batch against the plain version, and a permuted batch bit for bit
    for label, (wx, wu, wN) in (("8/3/16", (8, 3, 16)),
                                ("33/33/16", (33, 33, 16))):
        slots = sa.shared_slots(wx, wu, wN)
        RB = slots + slots // 4
        wprob, wrho = atm.models.random_lti_problem(6, wx, wu, wN, device=dev)
        spw = sa.pad_stream_problem(wprob, atm.riccati_cache(
            wprob.A, wprob.B, wprob.Q, wprob.R, wrho, device=dev))
        xs_r = spread_x0(RB, wx, (0.3, 1.0, 3.0), seed=6)
        cold_r = sa.StreamCarry.zeros(RB, spw)
        rkw = akw(60, 5, 1e-3)
        case, got, _ms = stream_case(
            f"K10 slot refills {label}", sa.stream_solve,
            sa.stream_solve_plain, spw, xs_r, cold_r, 5, float(spw.rho),
            **rkw)
        perm_r = torch.as_tensor(np.random.default_rng(8).permutation(RB),
                                 device=dev)
        again = sa.stream_solve(xs_r[perm_r], sa.StreamCarry(
            *(t[perm_r] for t in cold_r)), spw, **rkw)
        inv_r = torch.argsort(perm_r)
        exact = all(torch.equal(a, b[inv_r]) for a, b in zip(
            solve_fields(got), solve_fields(again)))
        its = got.stats[:, 0]
        case.update(slots=slots, batch=RB, permuted_bit_exact=exact,
                    iters_min=float(its.min()), iters_max=float(its.max()))
        if not RB > slots:
            case["failures"].append(f"slot refills {label}: batch {RB} "
                                    f"within the {slots} slots")
        if not exact:
            case["failures"].append(f"slot refills {label}: a permuted "
                                    "batch changes the results")
        str_cases.append(case)
    # K11/K12: the robust sweep's family (a) and the design sweep's family
    # (b) with per-instance cone parameters and geometry, at N=256
    fa = robust_family(SB, seed=7)
    hsp_a = hs.pad_hstream_from_plants(fa[0].A, fa[0].B, fa[0].Q, fa[0].R,
                                       fa[1], at_horizon(fa[0], 256))[0]
    fb = fleet_family(SB, seed=8)
    hsp_b = hs.pad_hstream_from_plants(fb[0].A, fb[0].B, fb[0].Q, fb[0].R,
                                       fb[1], at_horizon(fb[0], 256))[0]
    for label, hsp, xs, extra, geometry in (
            ("a robust 12/4/256", hsp_a, fa[2], {}, None),
            ("b fleet_sweep 8/3/256 cones", hsp_b, fb[2], fb[3], fb[4])):
        cy = sa.StreamCarry.zeros(SB, hsp)
        for mode, kw, check in (("K11 fixed-30", dict(max_iter=30), 0),
                                ("K12 check=5", akw(40, 5, 1e-3), 5)):
            case, got, ms = stream_case(
                f"{mode} {label}", hs.hstream_solve, hs.hstream_solve_plain,
                hsp, xs, cy, check, float(hsp.rho.max()), **kw, **extra)
            if geometry is not None:
                case["cone_excess"] = geometry_excess(got.carry.z, geometry)
                if not case["cone_excess"] <= CONE_TOL:
                    case["failures"].append(
                        f"{mode} {label}: final slack violates its cone by "
                        f"{case['cone_excess']}")
            if label.startswith("a"):
                plain_ms4[mode.split()[0]] = (case, ms, kw["max_iter"])
            str_cases.append(case)
    for kw in (dict(max_iter=30), akw(60, 5, 1e-3)):   # K11, K12
        kb_h = [solve_fields(hs.hstream_solve(
            fa[2], sa.StreamCarry.zeros(SB, hsp_a), hsp_a, knot_block=k,
            **kw)) for k in (8, 16, 64)]
        kb_same = kb_same and all(torch.equal(a, b) for r in kb_h[1:]
                                  for a, b in zip(r, kb_h[0]))
    str_cases.append({"case": "knot_block 8/16/64 bit-identical (K10, K11, "
                              "K12)",
                      "equal": kb_same,
                      "failures": [] if kb_same else ["knot_block changes "
                                                      "the results"]})
    torch.cuda.synchronize()
    emit("kernels_stream", batch=SB, seconds=round(time.perf_counter()
                                                   - T_LONG, 1),
         cases=str_cases)
    raise_failures(str_cases)

    # ----------------------------------------------------------- fourth path
    # Long horizons through the entry points, counts set to 0 just before
    # and read just after.
    sa.reset_launch_counts()
    steps4 = {}

    def step4(name, fn, n_solves, **info):
        out, ms = timed(fn)
        steps4[name] = {"ms": ms, "solves_per_s": n_solves / ms * 1e3,
                        **info}
        return out

    adapt5 = akw(100, 5, 1e-3)
    long_runs = {}
    for Bn in (512, LONG_BATCH):
        x0_b = spread_x0(Bn, 8, (0.3, 3.0, 10.0), seed=11)
        cold_b = sa.StreamCarry.zeros(Bn, sp_l)
        fx = step4(f"stream_solve_fixed100_b{Bn}", lambda: sa.stream_solve(
            x0_b, cold_b, sp_l, max_iter=100), Bn)
        ad = step4(f"stream_solve_adaptive_b{Bn}", lambda: sa.stream_solve(
            x0_b, cold_b, sp_l, **adapt5), Bn)
        steps4[f"stream_solve_adaptive_b{Bn}"].update(
            iterations_mean=float(ad.stats[:, 0].mean()),
            converged_fraction=float(ad.stats[:, 1].mean()))
        long_runs[Bn] = (x0_b, cold_b, fx, ad)
    x0_m, cold_m, fx_m, ad_m = long_runs[LONG_BATCH]
    trace_f, trace_a = [], []
    cf = step4("stream_cascade_fixed_segments25", lambda: stream_cascade_solve(
        x0_m, cold_m, sp_l, max_iter=100, segment_iters=25,
        abs_pri_tol=1e-3, abs_dua_tol=1e-3, trace=trace_f), LONG_BATCH)
    ca = step4("stream_cascade_inkernel25", lambda: stream_cascade_solve(
        x0_m, cold_m, sp_l, segment_iters=25, trace=trace_a, **adapt5),
        LONG_BATCH)
    cascade4 = {
        "fixed_segments": trace_f, "inkernel_segments": trace_a,
        "inkernel_bitwise_equal": bool(
            torch.equal(ca[0], ad_m.U) and torch.equal(ca[2], ad_m.stats)
            and all(torch.equal(a, b) for a, b in zip(ca[3], ad_m.carry))),
        "fixed_counts": sorted(set(cf[2][:, 0].int().tolist())),
        "fixed_converged_fraction": float(cf[2][:, 1].mean()),
    }
    assert cascade4["inkernel_bitwise_equal"], cascade4
    assert set(cascade4["fixed_counts"]) <= {25, 50, 75, 100}, cascade4

    # what comes out is right: the stream kernel at batch 512 against the
    # block-condensed tier (another formulation, dense block products), with
    # the float64 block tier as arbiter
    x0_s, _cold_s, fx_s, _ad_s = long_runs[512]
    blk = {}
    for dt in (torch.float32, torch.float64):
        mb = atm.TinyMPC.from_parts(
            prob_l.to(dtype=dt), cache_l.to(dtype=dt), tier="block",
            batch=512, device=dev, settings=atm.Settings(
                max_iter=100, check_termination=0))
        mb.set_x0(x0_s.to(dt))
        mb.solve()
        blk[dt] = torch.as_tensor(mb.get_u(), device=dev)
    e_stream = max_err(fx_s.U, blk[torch.float64])
    e_block = max_err(blk[torch.float32], blk[torch.float64])
    vs_block = {"stream_vs_block_f32": max_err(fx_s.U, blk[torch.float32]),
                "stream_vs_block_f64": e_stream,
                "block_f32_vs_block_f64": e_block}
    assert e_stream <= max(VAL_TOL, e_block), vs_block

    # TinyMPC(tier="block") against the scan tier at N=1024: a solve and a
    # 10-tick mission (adaptive, check 5, tol 1e-3) for 64 instances at the
    # example's x0 scale. The scan tier issues ~13 launches per knot (0.36 s
    # an iteration on the card, measured), so it runs on the CPU, in float64.
    x0_t = spread_x0(64, 8, (0.3,), seed=13)

    def long_mpc(tier, device, dtype):
        m = atm.TinyMPC.from_parts(
            prob_l.to(dtype=dtype), cache_l.to(dtype=dtype), tier=tier,
            batch=64, device=device, settings=atm.Settings(**adapt5))
        m.set_x0(x0_t.to(device=device, dtype=dtype))
        return m

    mb = long_mpc("block", dev, torch.float32)
    ms_ = long_mpc("scan", "cpu", torch.float64)
    step4("tinympc_block_solve", mb.solve, 64)
    _st, scan_ms = timed(ms_.solve)
    same = mb.state.iter.cpu() == ms_.state.iter
    solve_agree = float(same.float().mean())
    u_err = max_err(torch.as_tensor(mb.get_u()), torch.as_tensor(
        ms_.get_u()), same.cpu())
    xf_b, us_b = step4("tinympc_block_rollout10", lambda: mb.rollout(10),
                       640)
    (xf_s, us_s), scan_roll_ms = timed(lambda: ms_.rollout(10))
    block4 = {
        "scan_solve_ms": scan_ms, "scan_rollout10_ms": scan_roll_ms,
        "solve_iters_agree": solve_agree, "solve_u_err_same_count": u_err,
        "mission_last_iters_agree": float(
            (mb.state.iter.cpu() == ms_.state.iter).float().mean()),
        "us_err_all_instances": max_err(us_b.cpu(), us_s),
        "x_final_err": max_err(xf_b.cpu(), xf_s)}
    # two float32 formulations, an adaptive exit: the mission bars
    assert solve_agree >= AGREE_MISSION and u_err <= VAL_TOL, block4
    assert block4["us_err_all_instances"] <= 2e-3, block4

    # TinyMPCFleet on the hstream tier: 8,192 perturbed quadrotors at N=256
    # (the robust sweep's family), fixed, adaptive, through the cascade
    # (bit-exact against the one-call solve), a warm second solve; then the
    # block tier on the same fleet.
    prob_f, rho_f, x0_f = robust_family(LONG_BATCH, seed=12)
    bounds4 = dict(u_min=prob_f.u_min[:, 0], u_max=prob_f.u_max[:, 0],
                   x_min=prob_f.x_min[:, 0], x_max=prob_f.x_max[:, 0])
    fleets = {}
    for tier in ("hstream", "block"):
        f = step4(f"fleet_{tier}_setup", lambda: atm.TinyMPCFleet.setup(
            prob_f.A, prob_f.B, prob_f.Q, prob_f.R, rho_f, 256, tier=tier,
            settings=atm.Settings(max_iter=100, check_termination=0),
            device=dev, **bounds4), LONG_BATCH)
        f.set_xref(prob_f.Xref[:, :1].expand(LONG_BATCH, 256, 12))
        f.set_x0(x0_f)
        step4(f"fleet_{tier}_solve_fixed100", f.solve, LONG_BATCH)
        u_fx = f.get_u()
        f.settings = f.settings.replace(**{k: v for k, v in adapt5.items()
                                           if k != "max_iter"})
        f.reset_duals()
        twin = copy.copy(f)
        twin.compaction_segment = 25 if tier == "hstream" else 0
        st1 = step4(f"fleet_{tier}_solve_adaptive_warm", f.solve, LONG_BATCH)
        u_ad = f.get_u()
        steps4[f"fleet_{tier}_solve_adaptive_warm"].update(
            iterations_mean=st1["iterations_mean"],
            converged_fraction=st1["converged_fraction"])
        if tier == "hstream":
            st2 = step4("fleet_hstream_solve_adaptive_warm_cascade25",
                        twin.solve, LONG_BATCH)
            assert (st2["iterations"] == st1["iterations"]).all()
            assert torch.equal(twin.get_u(), u_ad)
        if tier == "hstream":  # a warm second solve
            f.reset_duals()
            st3 = step4("fleet_hstream_solve_adaptive_second", f.solve,
                        LONG_BATCH)
            steps4["fleet_hstream_solve_adaptive_second"].update(
                iterations_mean=st3["iterations_mean"])
        for name, arr in (("u_fixed", u_fx), ("u_adapt", u_ad),
                          ("u_last", f.get_u())):
            assert bool(torch.isfinite(arr).all()), f"{tier} {name}"
        assert u_ad.shape == (LONG_BATCH, 255, 4)
        fleets[tier] = (u_fx, st1, u_ad)
        del twin, f
    fleet4 = {
        "fixed_u_err_hstream_vs_block": max_err(fleets["hstream"][0],
                                                fleets["block"][0]),
        "adaptive_iters_agree": float(np.mean(
            fleets["hstream"][1]["iterations"]
            == fleets["block"][1]["iterations"])),
        "adaptive_u0_err_all": max_err(fleets["hstream"][2][:, 0],
                                       fleets["block"][2][:, 0])}
    # two float32 formulations of an ill-conditioned family (PR 3: each
    # float32 version ~2e-4 from float64 at N=10): the exit-tolerance bars
    assert fleet4["adaptive_iters_agree"] >= AGREE_MISSION, fleet4
    assert fleet4["adaptive_u0_err_all"] <= 2e-3, fleet4
    counts4 = dict(sa.LAUNCH_COUNTS)
    for k, v in counts4.items():
        assert v > 0, f"fourth path never launched {k}"
    for name, arr in (("stream_fixed", fx_m.U), ("stream_adaptive", ad_m.U)):
        assert bool(torch.isfinite(arr).all()), f"fourth path: {name}"
    assert fx_m.U.shape == (LONG_BATCH, 1023, 3)
    emit("fourth_path", batch=LONG_BATCH, steps=steps4,
         launches=counts4, cascade=cascade4, stream_vs_block=vs_block,
         tinympc_block_vs_scan=block4, fleet_hstream_vs_block=fleet4,
         seconds=round(time.perf_counter() - T_LONG, 1))

    # K9-K12 rows: times at batch 8,192 (K9/K10 the example's plant at
    # N=1024, K11/K12 the robust family at N=256), the plain versions' at
    # the comparison batch, launches from the fourth path.
    hsp_m = hs.pad_hstream_from_plants(
        prob_f.A, prob_f.B, prob_f.Q, prob_f.R, rho_f,
        at_horizon(prob_f, 256))[0]
    hcold_m = sa.StreamCarry.zeros(LONG_BATCH, hsp_m)
    for key, name, replaces, run, dims4, shared in (
            ("K9", "stream_solve_fixed",
             "accelerated_tinympc_tpu/ops/stream_admm.py:372",
             lambda: sa.stream_solve(x0_m, cold_m, sp_l, max_iter=100),
             (8, 3, 1024), True),
            ("K10", "stream_solve_adaptive",
             "accelerated_tinympc_tpu/ops/stream_admm.py:562",
             lambda: sa.stream_solve(x0_m, cold_m, sp_l, **adapt5),
             (8, 3, 1024), True),
            ("K11", "hstream_solve_fixed",
             "accelerated_tinympc_tpu/ops/hstream_admm.py:338",
             lambda: hs.hstream_solve(x0_f, hcold_m, hsp_m, max_iter=100),
             (12, 4, 256), False),
            ("K12", "hstream_solve_adaptive",
             "accelerated_tinympc_tpu/ops/hstream_admm.py:588",
             lambda: hs.hstream_solve(x0_f, hcold_m, hsp_m, **adapt5),
             (12, 4, 256), False)):
        ms = cuda_ms(run)
        out = run()
        iters = float(out.stats[:, 0].sum())
        bound_ms, bound_by, streamed_ms = stream_bound(dims4, iters,
                                                       LONG_BATCH, shared)
        case, p_ms, p_iters = plain_ms4[key]
        geometry = {}
        if not shared:   # K11/K12: registers, blocks an SM, waves
            plan = sa.hstream_plan(*dims4)
            adaptive = key == "K12"
            per_sm = sa.hstream_resident(*dims4, adaptive=adaptive)
            label = f"hstream_kernel<12,4,{int(adaptive)},0>"
            blocks = -(-LONG_BATCH // plan["instances_per_block"])
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            geometry = {
                "registers": next((r.get("registers") for r in hstream_ptxas
                                   if r["kernel"] == label), None),
                "threads_per_block": plan["threads"],
                "instances_per_block": plan["instances_per_block"],
                "resident_blocks_per_sm": per_sm,
                "waves": -(-blocks // (per_sm * n_sm)), "ring_knots":
                plan["kb"]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "accelerated_tinympc_tpu_torch/ops/csrc/" + (
                "stream_shared.cu" if shared else "stream_admm.cu"),
            "replaces": replaces, "launches": counts4[name],
            "max_abs_err": case["max_abs_err"], "ms": ms,
            "plain_ms": p_ms, "plain_batch": SB, "plain_max_iter": p_iters,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "streamed_bound_ms": streamed_ms, "library_ms": None,
            "batch": LONG_BATCH, "dims": dims4,
            "iters_mean": iters / LONG_BATCH, **geometry})
    emit("long_horizon_seconds", seconds=round(time.perf_counter() - T_LONG,
                                               1))

    # ----------------------------------------------------------- fifth path
    # Export (the scan tier; K1/K2 through the torch.library op), the
    # profiler, serialization and the six examples: fifth_path.
    emit("fifth_path", batch=MAIN_BATCH, **fifth_path(dev))

    # ----------------------------------------------------------- bf16x3 path
    # The split-bf16 mode of K1-K4 (algo="bf16x3"): bf16x3_path.
    bf_fields, bf_rows = bf16x3_path(dev)
    kernels.extend(bf_rows)
    emit("bf16x3_path", batch=MAIN_BATCH, **bf_fields)

    # ----------------------------------------------------------- sixth path
    # The batch mesh (a world of one over NCCL, two ranks over gloo),
    # codegen and the native binding: sixth_path.
    six = sixth_path(dev)
    emit("sixth_path", batch=MAIN_BATCH, **six)
    for row in kernels:
        row["sixth_path_launches"] = six["launches"].get(row["name"], 0)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    else:
        main()
