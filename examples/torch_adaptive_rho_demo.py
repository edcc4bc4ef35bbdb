"""Adaptive-rho demo, PyTorch/CUDA port (beyond the reference): rescue a
badly scaled problem.

The port's counterpart of ``examples/adaptive_rho_demo.py``, with its
printed lines. The reference bakes rho at build time (codegen.cpp:254-258);
a rho four orders of magnitude off leaves ADMM stalled.
``solve_adaptive_rho`` detects the stall, rebalances rho OSQP-style,
recomputes the Riccati cache on the device, and converges. Both solves run
on the scan tier, on the card by default. ``--max-iter`` cuts both
iteration budgets (default the JAX example's 1500).

Run: python examples/torch_adaptive_rho_demo.py [--max-iter 1500] [--cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.models import random_lti_problem
from accelerated_tinympc_tpu_torch.precompute import riccati_cache
from accelerated_tinympc_tpu_torch.solver import admm, solve_adaptive_rho


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-iter", type=int, default=1500)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    problem, _ = random_lti_problem(
        seed=3, nx=8, nu=3, horizon=15, bound=5.0, q_scale=100.0,
        r_scale=0.1, device=device,
    )
    problem = problem.replace(
        u_min=torch.full_like(problem.u_min, -0.3),
        u_max=torch.full_like(problem.u_max, 0.3),
    )
    bad_rho = 1e-2
    cache = riccati_cache(problem.A, problem.B, problem.Q, problem.R,
                          bad_rho, device=device)
    rng = np.random.default_rng(0)
    st = atm.set_x0(
        atm.init_state(8, 3, 15, device=device),
        torch.as_tensor(rng.standard_normal(8), dtype=torch.float32),
    )
    settings = atm.Settings(abs_pri_tol=2e-3, abs_dua_tol=2e-3)

    fixed = admm.solve(
        st, problem, cache,
        settings.replace(max_iter=args.max_iter, check_termination=1))
    print(f"fixed rho={bad_rho}: "
          f"{'solved' if int(fixed.status) == 1 else 'FAILED'} "
          f"after {int(fixed.iter)} iterations")

    res = solve_adaptive_rho(st, problem, cache, settings,
                             max_total_iter=args.max_iter)
    print(f"adaptive rho:   {'solved' if res.converged else 'failed'} "
          f"after {res.iterations} iterations; "
          f"rho path {[round(r, 3) for r in res.rho_history]}")


if __name__ == "__main__":
    main()
