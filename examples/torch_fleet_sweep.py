"""Heterogeneous-fleet scenario MPC with the port's TinyMPCFleet.

The PyTorch/CUDA counterpart of ``examples/fleet_sweep.py``. The reference
binds one problem per process (reference: src/tinympc/tiny_wrapper.hpp:6);
this example solves a fleet of *distinct* random LTI plants at once: Riccati
caches for every plant built on the device, per-instance early termination
on the adaptive hetero kernel, optional SOC thrust cones, optional
early-termination compaction, warm-started re-solves across a short
receding-horizon loop.

``--cones`` constrains each plant's inputs to a thrust cone with
*per-instance* geometry: every instance draws its own tilt limit mu, and
half the fleet has its thrust axis on another input coordinate.
``--drift 0.003`` drifts every plant a little each tick and refreshes all
caches online through ``TinyMPCFleet.set_plants`` (Newton-Kleinman from the
current gains; instances whose old gain no longer stabilises fall back to
the warm fixed point).

Runs on the card by default; ``--cpu`` runs the plain versions on the CPU.

Run: python examples/torch_fleet_sweep.py [--fleet 512] [--ticks 20]
     [--compaction 25] [--cones] [--drift 0.003] [--cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.models import random_lti_problem


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=512)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--compaction", type=int, default=0,
                    help="cascade segment length (0 = one adaptive call)")
    ap.add_argument("--cones", action="store_true",
                    help="per-instance thrust-cone geometry (mu + axis)")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="per-tick random plant drift scale (online model "
                         "updates via set_plants + Newton cache refresh)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions of the kernels)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    B, N = args.fleet, args.horizon
    nx, nu = 8, 3
    n_distinct = min(B, 64)
    plants = [random_lti_problem(s, nx, nu, N, device="cpu")[0]
              for s in range(n_distinct)]
    reps = -(-B // n_distinct)
    stack = lambda f: np.tile(
        np.stack([f(p).numpy() for p in plants]),
        (reps,) + (1,) * f(plants[0]).dim())[:B]
    A = stack(lambda p: p.A)
    Bm = stack(lambda p: p.B)
    Q = stack(lambda p: p.Q)
    R = stack(lambda p: p.R)

    cone_kw = {}
    if args.cones:
        from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet

        rngc = np.random.default_rng(42)
        mu = (0.6 + 0.8 * rngc.random(B)).astype(np.float32)
        h = B // 2
        ball = np.zeros((B, nu), np.float32)
        ball[:h, [0, 1]] = 1.0     # thrust axis on u[2]...
        ball[h:, [1, 2]] = 1.0     # ...or on u[0] for the other half
        axis = np.full(B, 2, np.int64)
        axis[h:] = 0
        cone_kw = dict(
            cones=ConeSet(input_cones=(
                Cone(ball=(0, 1), axis=2, mu=1.0, shift=2.0),)),
            cone_mu=mu[None, :], cone_ball=[ball], cone_axis=[axis],
        )
    fleet = atm.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=1.0, horizon=N,
        u_min=-2.0, u_max=2.0,
        settings=atm.Settings(max_iter=300, check_termination=1,
                              abs_pri_tol=5e-3, abs_dua_tol=5e-3),
        compaction_segment=args.compaction, device=device, **cone_kw,
    )
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, nx)).astype(np.float32) * 0.5
    norm0 = np.linalg.norm(x, axis=1).mean()

    drift_rng = np.random.default_rng(7)
    for t in range(args.ticks):
        if args.drift and t > 0:
            A = (A + args.drift
                 * drift_rng.standard_normal(A.shape).astype(np.float32))
            Bm = (Bm + args.drift
                  * drift_rng.standard_normal(Bm.shape).astype(np.float32))
            td = time.perf_counter()
            fleet.set_plants(A=A, B=Bm, refresh="newton")
            print(f"   drift: caches refreshed in "
                  f"{(time.perf_counter() - td) * 1e3:.1f} ms "
                  f"({fleet.fallback_count} fixed-point fallbacks)")
        fleet.set_x0(x)
        t0 = time.perf_counter()
        info = fleet.solve()
        dt = time.perf_counter() - t0
        u0 = fleet.get_u()[:, 0, :].cpu().numpy()
        # per-instance nominal plant step
        x = np.einsum("bij,bj->bi", A, x) + np.einsum("bij,bj->bi", Bm, u0)
        print(f"tick {t}: solved {info['converged_fraction']:.1%}  "
              f"iters mean {info['iterations_mean']:.1f}  "
              f"|x| mean {np.linalg.norm(x, axis=1).mean():.3f}  "
              f"({dt * 1e3:.1f} ms, {B / dt:,.0f} solves/s)")
        fleet.reset_duals()  # reference re-solve protocol

    # Random near-marginally-stable plants under tight input boxes decay a
    # few percent per tick: check sustained regulation, not touchdown. Under
    # --drift the plants keep changing underfoot; the controller's job is
    # then containment (bounded states with refreshed gains).
    final = np.linalg.norm(x, axis=1).mean()
    ok = final < (1.5 * norm0 if args.drift else 0.8 * norm0)
    print(("FLEET CONTAINED" if args.drift else "FLEET REGULATED")
          if ok else "CHECK FAILED")


if __name__ == "__main__":
    main()
