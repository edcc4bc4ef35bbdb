#!/usr/bin/env python3
"""Times of the fleet and long-horizon kernels (K7-K12) of one checkout of
the port on one GPU.

    python3 tools/torch_stream_times.py [ROOT] [--reps 3]

ROOT is the directory that holds ``accelerated_tinympc_tpu_torch`` (default:
this checkout), so the same script times an unpacked earlier commit beside
this one: run it on both in one call, in turns (parent, change, change,
parent), and compare only within that call. Each checkout builds its kernels
into a directory of its own under the system's temporary directory.

The workloads are ``chip_smoke.py``'s. K9/K10: the long-horizon example's
plant (``random_lti`` seed 0, nx=8, nu=3, N=1024), x0 of three scales (0.3,
3, 10), cold, at 512 and 8,192 instances; K9 fixed 100 iterations, K10
check 5 at tolerance 1e-3 (mean iterations beside). K7/K8: the robust
sweep's family (the quadrotor's plant perturbed by 3 %, N=10) at 65,536
and 4,096; K7 fixed 100 cold, K8 check 1 at 1e-3 warm after a 12-tick fleet
mission; also ``examples/fleet_sweep.py``'s
family with its cone (``chip_smoke.py``'s family b: 64 random plants nx=8,
nu=3 tiled, a thrust cone with per-instance mu and geometry) at 65,536, K7
fixed 100 and K8 check 1 at 1e-3, cold.
K11/K12: the same family (seed 12) at N=256 for 8,192 instances (and 512),
fixed 100 and check 5; also the K9/K10 plant at N=256 given to every
instance (8/3) at 8,192 and 512. Prints one JSON line with the card's
name. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]


def robust_family(atm, batch, seed=0, spread=0.03, dev="cuda"):
    """The robust sweep's family: the quadrotor's plant with A and B
    perturbed by ``spread`` (instance 0 nominal), the hover problem for
    every instance, the cache's rho, x0 around the hover reference. Returns
    ``(problem, rho, x0s)``, batch-leading."""
    import numpy as np
    import torch

    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    prob, cch, _x0 = atm.models.quadrotor_hovering_setup(device=dev)
    rng = np.random.default_rng(seed)
    A0 = prob.A.double().cpu().numpy()
    B0 = prob.B.double().cpu().numpy()
    mulA = 1.0 + spread * rng.standard_normal((batch, 12, 12))
    mulB = 1.0 + spread * rng.standard_normal((batch, 12, 4))
    mulA[0] = 1.0
    mulB[0] = 1.0
    wide = lambda a: a.expand((batch,) + tuple(a.shape)).contiguous()
    prob_b = atm.Problem(**{k: wide(v) for k, v in prob.tensors().items()})
    prob_b = prob_b.replace(A=t(A0[None] * mulA), B=t(B0[None] * mulB))
    rho = torch.full((batch,), float(cch.rho), device=dev)
    x0s = t(prob.Xref[0].cpu().numpy()[None]
            + 0.2 * rng.standard_normal((batch, 12)))
    return prob_b, rho, x0s


def fleet_family(atm, batch, seed=0, dev="cuda"):
    """``examples/fleet_sweep.py``'s family (``chip_smoke.py``'s family b):
    64 random plants nx=8, nu=3 tiled over the batch, inputs in [-2, 2], a
    thrust cone with per-instance mu and, for half the fleet, the axis on
    another input. Returns ``(problem, rho, x0s, solve keywords)``."""
    import numpy as np
    import torch

    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

    ps = [atm.models.random_lti_problem(s, 8, 3, 10, device=dev)[0]
          for s in range(64)]
    reps = -(-batch // 64)
    tile = lambda f: torch.cat([torch.stack([f(p) for p in ps])] * reps)[
        :batch].contiguous()
    inf = float("inf")
    full = lambda v, *sh: torch.full((batch,) + sh, v, device=dev)
    prob_b = atm.Problem(
        A=tile(lambda p: p.A), B=tile(lambda p: p.B),
        Q=tile(lambda p: p.Q), R=tile(lambda p: p.R),
        u_min=full(-2.0, 9, 3), u_max=full(2.0, 9, 3),
        x_min=full(-inf, 10, 8), x_max=full(inf, 10, 8),
        Xref=full(0.0, 10, 8), Uref=full(0.0, 9, 3))
    rng = np.random.default_rng(seed)
    x0s = torch.as_tensor(0.5 * rng.standard_normal((batch, 8)),
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
    kw = dict(
        cones=cones,
        cone_params=ha.pad_hetero_cone_params(cones, batch, mu_u=mu[None],
                                              device=dev),
        cone_masks=ha.pad_hetero_cone_masks(
            cones, batch, 8, 3, ball_u=[ball], axis_u=[axis], device=dev),
        en_state_bound=False)
    return prob_b, torch.ones(batch, device=dev), x0s, kw


def at_horizon(prob_b, N):
    """A batch-leading problem carried to horizon N: uniform bounds and
    reference (its first knot's rows repeated)."""
    Bn = prob_b.A.shape[0]
    rows = lambda a, k: a[:, :1].expand(Bn, k, a.shape[-1]).contiguous()
    return prob_b.replace(
        u_min=rows(prob_b.u_min, N - 1), u_max=rows(prob_b.u_max, N - 1),
        x_min=rows(prob_b.x_min, N), x_max=rows(prob_b.x_max, N),
        Xref=rows(prob_b.Xref, N), Uref=rows(prob_b.Uref, N - 1))


def hstream_workload(atm, batch=8192, seed=12, N=256, dev="cuda"):
    """K11/K12's timed workload (``chip_smoke.py``'s): the robust family at
    N=256. Returns ``(hsp, x0s, cold carry)``."""
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    prob_f, rho_f, x0_f = robust_family(atm, batch, seed=seed, dev=dev)
    hsp = hs.pad_hstream_from_plants(prob_f.A, prob_f.B, prob_f.Q, prob_f.R,
                                     rho_f, at_horizon(prob_f, N))[0]
    return hsp, x0_f, sa.StreamCarry.zeros(batch, hsp)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs   # this checkout's timer

    sys.path.insert(0, str(root))
    tag = hashlib.sha256(str(root).encode()).hexdigest()[:8]
    os.environ["ATM_TORCH_BUILD_DIR"] = str(
        pathlib.Path(tempfile.gettempdir()) / f"atm_stream_times_{tag}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.api.mpc import fleet_mpc_rollout
    from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
    from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    dev = "cuda"
    ms = lambda fn: cs.cuda_ms(fn, args.reps)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)

    def spread_x0(batch, nx, seed=11):
        rng = np.random.default_rng(seed)
        sc = np.resize(np.asarray((0.3, 3.0, 10.0)), batch)[:, None]
        return t(sc * rng.standard_normal((batch, nx)))

    row = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    adapt5 = dict(max_iter=100, check_termination=5, abs_pri_tol=1e-3,
                  abs_dua_tol=1e-3)
    # K9/K10
    prob, rho = atm.models.random_lti_problem(0, 8, 3, 1024, device=dev)
    sp = sa.pad_stream_problem(prob, atm.riccati_cache(
        prob.A, prob.B, prob.Q, prob.R, rho, device=dev))
    for Bn in (512, 8192):
        x0 = spread_x0(Bn, 8)
        cold = sa.StreamCarry.zeros(Bn, sp)
        row[f"K9_b{Bn}_ms"] = ms(lambda: sa.stream_solve(x0, cold, sp,
                                                         max_iter=100))
        row[f"K10_b{Bn}_ms"] = ms(lambda: sa.stream_solve(x0, cold, sp,
                                                          **adapt5))
        row[f"K10_b{Bn}_iters_mean"] = float(sa.stream_solve(
            x0, cold, sp, **adapt5).stats[:, 0].mean())
        del x0, cold
    # K7/K8 at 65,536 (K7_ms, K8_ms) and at 4,096
    kh8 = dict(max_iter=100, check_termination=1, abs_pri_tol=1e-3,
               abs_dua_tol=1e-3)
    for B7, tag in ((65536, ""), (4096, "_b4096")):
        fam = robust_family(atm, B7)
        hp = ha.pad_hetero_from_plants(fam[0].A, fam[0].B, fam[0].Q,
                                       fam[0].R, fam[1], fam[0])[0]
        hcold = ha.HeteroCarry.zeros(hp)
        k7 = lambda: ha.hetero_solve(fam[2], hcold, hp, max_iter=100)
        xw, _us, cw = fleet_mpc_rollout(hp, fam[0], fam[2], 12, **kh8)
        cw = cw.reset_duals()
        k8 = lambda: ha.hetero_solve(xw, cw, hp, **kh8)
        row[f"K7{tag}_ms"] = ms(k7)
        row[f"K8{tag}_ms"] = ms(k8)
        row[f"K8{tag}_iters_mean"] = float(k8().stats[:, 0].mean())
        del fam, hp, hcold, xw, cw
    # K7/K8 on the design sweep's 8/3 family with its cone, at 65,536
    fb = fleet_family(atm, 65536)
    hpb = ha.pad_hetero_from_plants(fb[0].A, fb[0].B, fb[0].Q, fb[0].R,
                                    fb[1], fb[0])[0]
    bcold = ha.HeteroCarry.zeros(hpb)
    row["K7_8_3_cone_ms"] = ms(lambda: ha.hetero_solve(
        fb[2], bcold, hpb, max_iter=100, **fb[3]))
    row["K8_8_3_cone_ms"] = ms(lambda: ha.hetero_solve(
        fb[2], bcold, hpb, **kh8, **fb[3]))
    row["K8_8_3_cone_iters_mean"] = float(ha.hetero_solve(
        fb[2], bcold, hpb, **kh8, **fb[3]).stats[:, 0].mean())
    del fb, hpb, bcold
    # K11/K12 at 8,192 (K11_ms, K12_ms) and at 512
    for Bn, tag in ((8192, ""), (512, "_b512")):
        hsp, x0_f, hcold = hstream_workload(atm, batch=Bn)
        row[f"K11{tag}_ms"] = ms(lambda: hs.hstream_solve(
            x0_f, hcold, hsp, max_iter=100))
        row[f"K12{tag}_ms"] = ms(lambda: hs.hstream_solve(
            x0_f, hcold, hsp, **adapt5))
        row[f"K12{tag}_iters_mean"] = float(hs.hstream_solve(
            x0_f, hcold, hsp, **adapt5).stats[:, 0].mean())
        del hsp, x0_f, hcold
    # K11/K12 at another shape: the long-horizon example's plant (8/3) at
    # N=256 given to every instance
    prob83, rho83 = atm.models.random_lti_problem(0, 8, 3, 256, device=dev)
    for Bn in (8192, 512):
        rep = lambda a: a[None].expand(Bn, *a.shape).contiguous()
        pb = prob83.replace(**{k: rep(getattr(prob83, k)) for k in (
            "A", "B", "Q", "R", "u_min", "u_max", "x_min", "x_max", "Xref",
            "Uref")})
        hsp = hs.pad_hstream_from_plants(
            pb.A, pb.B, pb.Q, pb.R, torch.full((Bn,), float(rho83),
                                               device=dev), pb)[0]
        x0 = spread_x0(Bn, 8)
        hcold = sa.StreamCarry.zeros(Bn, hsp)
        row[f"K11_8_3_b{Bn}_ms"] = ms(lambda: hs.hstream_solve(
            x0, hcold, hsp, max_iter=100))
        row[f"K12_8_3_b{Bn}_ms"] = ms(lambda: hs.hstream_solve(
            x0, hcold, hsp, **adapt5))
        del hsp, x0, hcold
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
