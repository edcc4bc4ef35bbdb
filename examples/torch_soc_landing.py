"""Powered-descent MPC with second-order-cone constraints, PyTorch/CUDA port.

The port's counterpart of ``examples/soc_landing.py``. A capability beyond
the reference (box-only slack projection, reference:
src/tinympc/admm.cpp:45-61): a 3D point-mass lander tracks a touchdown at the
origin under two cones --

* thrust-tilt: ``||T_xy|| <= tan(theta) * T_z`` on the *total* thrust.
  Inputs are hover-relative (``u = T - (0,0,g)`` -- the LTI deviation form
  absorbs constant gravity exactly), so this is the shifted cone
  ``||u_xy|| <= tan(theta) * (u_z + g)`` (``Cone.shift``).
* glideslope: ``||p_xy|| <= tan(phi) * (p_z + eps)`` (approach stays in a
  cone over the pad; the tiny apex shift keeps touchdown smooth).

Default: one lander, the receding-horizon loop on the scan tier with the cone
projections in the ADMM slack stage (solver/cones.py).

``--fleet N`` solves a dispersion fleet of N landers in one fused solve with
the cone projections *inside the CUDA kernel* (ops/fused_admm.py pad_cones).

``--fleet N --mission`` runs the whole receding-horizon descent of the fleet
as ONE kernel launch (ops/fused_rollout.py with cone_ops): per-tick dual
reset, coned adaptive solve and plant step in the kernel, warm carries in
shared memory between ticks.

Run: python examples/torch_soc_landing.py [--ticks 60] [--horizon 15]
     [--fleet 0] [--mission] [--device cuda|cpu]
(on the CPU the fused tier runs its plain PyTorch version).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.solver.cones import (
    Cone,
    ConeSet,
    cone_violation,
)

X0 = np.asarray([3.0, -2.0, 6.0, 1.0, 0.5, -1.0])


def landing_mpc(horizon: int, cones: ConeSet, settings: atm.Settings,
                device: str, dt: float = 0.1, **kw) -> atm.TinyMPC:
    I3 = np.eye(3)
    A = np.block([[I3, dt * I3], [0 * I3, I3]])
    B = np.vstack([0.5 * dt * dt * I3, dt * I3])
    Q = np.concatenate([np.full(3, 10.0), np.full(3, 1.0)])
    R = np.full(3, 1.0)
    return atm.TinyMPC.setup(
        A, B, Q, R, 1.0, horizon, u_min=-10.0, u_max=10.0, x_min=-100.0,
        x_max=100.0, settings=settings, cones=cones, device=device, **kw)


def fleet_x0(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return X0[None] + rng.standard_normal((n, 6)) * 0.3


def fleet_solve(mpc: atm.TinyMPC, cones: ConeSet, n: int) -> None:
    """Dispersion fleet: n perturbed landers, one fused coned solve."""
    mpc.set_x0(fleet_x0(n))
    stats = mpc.solve()
    m = mpc.problem.horizon - 1
    Z = mpc._fused_carry.Z.reshape(n, m, 3)
    tilt_v = float(cone_violation(Z, cones.input_cones[0]))
    it = stats["iterations"]
    print(f"fleet {n}: solved {stats['converged_fraction']:.1%}  "
          f"iters p50={np.median(it):.0f} max={it.max():.0f}  "
          f"worst in-kernel tilt violation {tilt_v:.2e}")


def fleet_mission(mpc: atm.TinyMPC, cones: ConeSet, n: int,
                  ticks: int) -> None:
    """Whole coned descent mission of an n-lander fleet in ONE kernel
    launch (in-kernel rollout)."""
    mpc.set_x0(fleet_x0(n))
    x_final, us = mpc.rollout(ticks, in_kernel=True)
    tilt_v = float(cone_violation(us, cones.input_cones[0]))
    m = mpc.problem.horizon - 1
    Z = mpc._fused_carry.Z.reshape(n, m, 3)
    slack_v = float(cone_violation(Z, cones.input_cones[0]))
    pos = x_final[:, :3].norm(dim=1).cpu().numpy()
    print(f"mission fleet {n} x {ticks} ticks (one launch): "
          f"final |pos| p50={np.median(pos):.3f} max={pos.max():.3f}  "
          f"in-kernel slack tilt violation {slack_v:.2e}  "
          f"applied-u (pre-projection) tilt violation {tilt_v:.2e}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--horizon", type=int, default=15)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--fleet", type=int, default=0,
                    help="solve a fleet of this size in one fused solve")
    ap.add_argument("--mission", action="store_true",
                    help="with --fleet: whole receding-horizon descent in "
                         "ONE in-kernel rollout launch")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()

    g_hover = 3.0  # hover thrust in input units (gravity compensation)
    tilt = Cone(ball=(0, 1), axis=2, mu=1.0, shift=g_hover)  # theta = 45 deg
    glide = Cone(ball=(0, 1), axis=2, mu=2.0, shift=0.1)     # phi ~ 63 deg
    cones = ConeSet(input_cones=(tilt,), state_cones=(glide,))

    if args.fleet:
        iters = min(args.iters, 100) if args.mission else args.iters
        mpc = landing_mpc(
            args.horizon, cones,
            atm.Settings(max_iter=iters, check_termination=2),
            args.device, tier="fused", batch=args.fleet)
        if args.mission:
            fleet_mission(mpc, cones, args.fleet, args.ticks)
        else:
            fleet_solve(mpc, cones, args.fleet)
        return

    # Cones alone, as the JAX example: the box bounds of setup() disabled.
    mpc = landing_mpc(
        args.horizon, cones,
        atm.Settings(max_iter=args.iters, check_termination=1), args.device)
    mpc.settings = mpc.settings.replace(en_input_bound=False,
                                        en_state_bound=False)
    A, B = mpc.problem.A, mpc.problem.B
    x = torch.as_tensor(X0, dtype=A.dtype, device=A.device)
    xs, us, iters = [], [], []
    for _ in range(args.ticks):
        mpc.reset_duals()
        mpc.set_x0(x)
        stats = mpc.solve()
        u0 = mpc.state.u[0]
        xs.append(x)
        us.append(u0)
        iters.append(stats["iterations"])
        x = A @ x + B @ u0
    xs, us = torch.stack(xs), torch.stack(us)
    tilt_v = float(cone_violation(us, tilt))
    glide_v = float(cone_violation(xs[1:], glide))
    pos, vel = float(xs[-1, :3].norm()), float(xs[-1, 3:].norm())
    print(f"final |pos| = {pos:.4f}  |vel| = {vel:.4f}")
    print(f"worst thrust-tilt violation over flight: {tilt_v:.2e}")
    print(f"worst glideslope violation (post-x0):    {glide_v:.2e}")
    print(f"ADMM iterations per tick: mean {np.mean(iters):.0f} "
          f"max {int(np.max(iters))}")
    ok = pos < 0.2 and tilt_v < 5e-3 and glide_v < 5e-2
    print("LANDED inside both cones" if ok else "CHECK FAILED")


if __name__ == "__main__":
    main()
