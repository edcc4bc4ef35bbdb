"""Long-horizon MPC with the port: the streaming kernel against the tensor
tiers.

The PyTorch/CUDA counterpart of ``examples/long_horizon.py`` (no reference
counterpart: the reference is fixed at NHORIZON=10, reference:
src/tinympc/glob_opts.hpp:7; its horizon sweeps are strictly sequential
loops, src/tinympc/admm.cpp:17,29). Solves a batch of instances of one
random stabilizable plant (nx=8, nu=3) at a horizon of hundreds to
thousands of knots four ways and reports the time per solve:

* ``scan``   -- the knot-by-knot sweeps of ``solver/admm.py``, batched
* ``assoc``  -- O(log N) associative-scan sweeps (``solver/assoc_scan.py``)
* ``block``  -- block-condensed sweeps (``solver/block_condensed.py``):
  dense per-block operators, 32 knots a block
* ``stream`` -- the fused streaming CUDA kernel (``ops/stream_admm.py``,
  K9 fixed, K10 adaptive); on the CPU its plain version

Then holds the stream tier's controls against the scan tier's at 1e-4, or,
where float32 itself strays further at this horizon, against the float64
scan tier within the distance of the float32 scan tier from it (the
float64 arbiter), and runs the adaptive kernel (check every 5, tol 1e-3).

Runs on the card by default; ``--cpu`` runs everything on the CPU (use a
short horizon there). Prints ``LONG HORIZON OK`` or ``CHECK FAILED`` last.

Run: python examples/torch_long_horizon.py [--horizon 1024] [--batch 256]
     [--iters 100] [--cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.models import random_lti_problem
from accelerated_tinympc_tpu_torch.ops import (
    StreamCarry, pad_stream_problem, stream_solve,
)
from accelerated_tinympc_tpu_torch.solver.assoc_scan import (
    backward_pass_assoc, forward_pass_assoc,
)
from accelerated_tinympc_tpu_torch.solver.batched import (
    init_state_batched, solve_batched,
)
from accelerated_tinympc_tpu_torch.solver.block_condensed import block_sweeps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    dev = "cpu" if args.cpu else "cuda"
    nx, nu, N, Bn = 8, 3, args.horizon, args.batch
    x0s_np = np.random.default_rng(1).standard_normal((Bn, nx)) * 0.3

    def parts(dtype):
        problem, rho = random_lti_problem(seed=0, nx=nx, nu=nu, horizon=N,
                                          dtype=dtype, device=dev)
        cache = atm.riccati_cache(problem.A, problem.B, problem.Q, problem.R,
                                  rho, dtype=dtype, device=dev)
        return problem, cache, torch.as_tensor(x0s_np, dtype=dtype,
                                               device=dev)

    problem, cache, x0s = parts(torch.float32)
    settings = atm.Settings(max_iter=args.iters, check_termination=0)

    def sync():
        if not args.cpu:
            torch.cuda.synchronize()

    def timeit(fn, reps=1):
        out = fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return out, (time.perf_counter() - t0) / reps

    def report(name, t):
        print(f"{name:6s} tier: {t / Bn * 1e6:9.1f} us/solve "
              f"({Bn / t:8.0f} solves/s)")

    def scan_tier(prob, cach, x, **kw):
        st = init_state_batched(Bn, nx, nu, N, x.dtype, dev)
        sx = st.x.clone()
        sx[:, 0] = x
        return solve_batched(st.replace(x=sx), prob, cach, settings, **kw)

    w, t = timeit(lambda: scan_tier(problem, cache, x0s))
    report("scan", t)
    a, t = timeit(lambda: scan_tier(problem, cache, x0s,
                                    forward=forward_pass_assoc,
                                    backward=backward_pass_assoc), reps=3)
    report("assoc", t)
    fwd, bwd = block_sweeps(cache, problem.A, problem.B, N, 32)
    b, t = timeit(lambda: scan_tier(problem, cache, x0s, forward=fwd,
                                    backward=bwd), reps=3)
    report("block", t)
    print(f"assoc vs scan control err {float((a.u - w.u).abs().max()):.1e}, "
          f"block vs scan {float((b.u - w.u).abs().max()):.1e}")

    sp = pad_stream_problem(problem, cache)
    s, t = timeit(lambda: stream_solve(x0s, StreamCarry.zeros(Bn, sp), sp,
                                       max_iter=args.iters), reps=3)
    report("stream", t)
    err = float((s.U - w.u).abs().max())
    print(f"stream-vs-scan control err: {err:.2e}  (bar 1e-4)")
    ok = err <= 1e-4
    if not ok:
        # float32 noise amplified through the clips at long horizons: the
        # float64 scan tier decides, and the kernel may be no further from
        # it than the float32 scan tier is
        p64, c64, x64 = parts(torch.float64)
        w64 = scan_tier(p64, c64, x64)
        e_stream = float((s.U.double() - w64.u).abs().max())
        e_scan = float((w.u.double() - w64.u).abs().max())
        ok = e_stream <= max(1e-4, e_scan)
        print(f"float64 arbiter: stream {e_stream:.2e}, float32 scan "
              f"{e_scan:.2e}")

    sa, t = timeit(lambda: stream_solve(
        x0s, StreamCarry.zeros(Bn, sp), sp, max_iter=args.iters,
        check_termination=5, abs_pri_tol=1e-3, abs_dua_tol=1e-3), reps=3)
    report("stream (adaptive)", t)
    it = sa.stats[:, 0].cpu().numpy()
    print(f"adaptive iterations: mean {it.mean():.1f}, max {int(it.max())}, "
          f"solved {float((sa.stats[:, 1] > 0.5).float().mean()):.0%}")
    ok = ok and bool(torch.isfinite(sa.U).all())
    print("LONG HORIZON OK" if ok else "CHECK FAILED")


if __name__ == "__main__":
    main()
