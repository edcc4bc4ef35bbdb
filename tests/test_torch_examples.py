"""PyTorch port, the six reference examples and demos with ``--cpu`` at a
tiny size, in this process through ``chip_smoke.run_example`` (the runner
``chip_smoke.py`` uses on the card), as ``tests/test_torch_fleet.py`` runs
``examples/torch_fleet_sweep.py``: each prints its JAX twin's lines.
Held against the JAX package: hovering and batch-scenario against their JAX
examples run with the same arguments, tracking against the JAX scan tier,
and the adaptive-rho demo against the JAX demo's steps at the same budget.
The mission example and the robust sweep have no JAX twin cheap enough
here (both JAX examples run their kernel in the Pallas interpreter): the
mission is checked on its own lines, the robust sweep on its own bar, and
the robust sweep at its defaults against the JAX example in a test marked
slow (a minute on the CPU)."""

import numpy as np
import pytest

import torch_parity_utils  # noqa: F401  (one torch thread per process)
from chip_smoke import floats_in as _floats, run_example


def _run(name: str, *args: str) -> list[str]:
    """The lines of an example that must pass its own checks."""
    lines, failed = run_example(name, *args)
    assert failed is None, (name, failed)
    return lines


def test_quadrotor_hovering():
    """The tick lines and the final error equal the JAX example's run with
    the same arguments (both on their float32 scan tier, 100 iterations a
    tick) within 1e-4 on errors up to 4.1 (measured: 2.3e-5 over these 6
    ticks, 6.3e-5 over the default 70), iteration counts equal; tick 0 is
    the initial state's distance from the hover point."""
    lines = _run("torch_quadrotor_hovering.py", "--ticks", "6", "--cpu")
    want = _run("quadrotor_hovering.py", "--ticks", "6")
    assert len(lines) == len(want) == 7
    for got, ref in zip(lines, want):
        assert got.split(":")[0] == ref.split(":")[0]
        assert _floats(got) == pytest.approx(_floats(ref), abs=1e-4)
        if got.startswith("tick "):
            assert got.endswith("iters: 100") and ref.endswith("iters: 100")
    import accelerated_tinympc_tpu_torch as atm_t

    problem, _, x0 = atm_t.models.quadrotor_hovering_setup(device="cpu")
    d0 = float(np.linalg.norm(x0 - problem.Xref[0].numpy()))
    assert _floats(lines[0])[0] == pytest.approx(d0, abs=1e-6)
    lines = _run("torch_quadrotor_hovering.py", "--ticks", "2",
                 "--adaptive", "--hz", "50", "--cpu")
    assert all(int(ln.split()[-1]) <= 100 for ln in lines[:-1])


def test_quadrotor_tracking():
    """The first ticks' errors equal the JAX scan tier's on the same
    trajectory (x0 on it: tick 0 is exactly 0) within 1e-5."""
    import jax
    import jax.numpy as jnp

    import accelerated_tinympc_tpu as atm_j
    from accelerated_tinympc_tpu.api import mpc_rollout, tracking_error

    lines = _run("torch_quadrotor_tracking.py", "--ticks", "4", "--cpu")
    errs = [_floats(ln)[0] for ln in lines if ln.startswith("tick ")]
    assert len(errs) == 4 and errs[0] == 0.0
    assert lines[-1].startswith("mean tracking error: ")
    problem, cache, x0, Xref = atm_j.models.quadrotor_tracking_setup()
    Xref = jnp.asarray(Xref, jnp.float32)
    _, _, trace = jax.jit(lambda x: mpc_rollout(
        problem, cache, atm_j.Settings(max_iter=25, check_termination=0),
        x, 4, Xref_total=Xref))(jnp.asarray(x0, jnp.float32))
    want = np.asarray(tracking_error(trace, Xref))
    assert errs == pytest.approx(want.tolist(), abs=1e-5)


def test_batch_scenario_mpc():
    """The scan tier and the fused tier's plain version print the same
    tracking error (fixed iterations, float32 to the printed digits), and
    the JAX example's ``jnp`` tier with the same arguments prints it within
    one unit of the last printed digit."""
    args = ("--batch", "4", "--ticks", "2", "--iters", "10")
    out = {}
    for tier in ("scan", "fused"):
        lines = _run("torch_batch_scenario_mpc.py", *args, "--tier", tier,
                     "--cpu")
        assert lines[0] == f"tier={tier} batch=4 ticks=2 iters=10"
        assert "8 solves in" in lines[1] and lines[1].endswith("solves/s")
        out[tier] = lines[2]
    assert out["scan"] == out["fused"]
    want = _run("batch_scenario_mpc.py", *args, "--tier", "jnp")
    assert want[0] == "tier=jnp batch=4 ticks=2 iters=10"
    assert _floats(out["scan"]) == pytest.approx(_floats(want[2]), abs=1e-4)
    assert _run("torch_batch_scenario_mpc.py", "--batch", "2", "--ticks", "1",
                "--iters", "2", "--cpu")[0].startswith("tier=scan")


def test_mission_kernel():
    lines = _run("torch_mission_kernel.py", "--batch", "16", "--ticks", "3",
                 "--cpu")
    assert lines[0] == "3-tick mission, batch 8, one kernel launch (hovering):"
    assert lines[3].startswith("  u0 trace shape (3, 8, 4)")
    assert len(_floats(lines[4].split("[")[1])) == 10
    lines = _run("torch_mission_kernel.py", "--batch", "2", "--ticks", "3",
                 "--check", "1", "--track", "--cpu")
    assert lines[0].endswith("(tracking):") and len(lines) == 4


# The rebalanced rho of the two packages after the stall: 9.1595 (JAX) and
# 9.1632 (port), float32 residuals of a stalled solve summed in another
# order.
RHO_RTOL = 1e-3


def test_adaptive_rho_demo():
    """At a budget of 300 iterations (the JAX demo's is fixed at 1500) the
    port's demo prints the JAX demo's steps run at that budget: the fixed
    solve's line word for word, the adaptive solve's outcome and iteration
    count, and its rho path within RHO_RTOL."""
    import jax
    import jax.numpy as jnp

    import accelerated_tinympc_tpu as atm_j
    from accelerated_tinympc_tpu.models import random_lti_problem
    from accelerated_tinympc_tpu.precompute import riccati_cache
    from accelerated_tinympc_tpu.solver import admm, solve_adaptive_rho

    lines = _run("torch_adaptive_rho_demo.py", "--max-iter", "300", "--cpu")
    problem, _ = random_lti_problem(seed=3, nx=8, nu=3, horizon=15, bound=5.0,
                                    q_scale=100.0, r_scale=0.1)
    problem = problem.replace(u_min=jnp.full_like(problem.u_min, -0.3),
                              u_max=jnp.full_like(problem.u_max, 0.3))
    cache = riccati_cache(np.asarray(problem.A), np.asarray(problem.B),
                          np.asarray(problem.Q), np.asarray(problem.R), 1e-2)
    rng = np.random.default_rng(0)
    st = atm_j.set_x0(atm_j.init_state(8, 3, 15),
                      jnp.asarray(rng.standard_normal(8), jnp.float32))
    settings = atm_j.Settings(abs_pri_tol=2e-3, abs_dua_tol=2e-3)
    fixed = jax.jit(admm.solve)(
        st, problem, cache, settings.replace(max_iter=300, check_termination=1))
    res = solve_adaptive_rho(st, problem, cache, settings, max_total_iter=300)
    assert lines[0] == (
        f"fixed rho=0.01: {'solved' if int(fixed.status) == 1 else 'FAILED'} "
        f"after {int(fixed.iter)} iterations")
    assert lines[0] == "fixed rho=0.01: FAILED after 300 iterations"
    head, path = lines[1].split("; rho path ")
    assert head == (f"adaptive rho:   {'solved' if res.converged else 'failed'}"
                    f" after {res.iterations} iterations")
    assert head == "adaptive rho:   solved after 225 iterations"
    assert _floats(path) == pytest.approx(list(res.rho_history), rel=RHO_RTOL)


def test_robust_plant_sweep():
    """On its nominal family (``--spread 0``) the loop meets the example's
    own bar and prints OK; a run too short to settle fails it."""
    lines = _run("torch_robust_plant_sweep.py", "--scenarios", "2",
                 "--ticks", "40", "--iters", "20", "--spread", "0", "--cpu")
    assert lines[0] == "2 on-device cache builds: " + lines[0].split(": ")[1]
    assert sum(ln.startswith("tick ") for ln in lines) == 9
    assert _floats(lines[-3])[0] < 0.1 and lines[-1] == "OK"
    lines, failed = run_example("torch_robust_plant_sweep.py", "--scenarios",
                                "2", "--ticks", "2", "--iters", "5", "--cpu")
    assert failed == "robust loop failed to stabilize the unseen plant"
    assert "OK" not in lines


@pytest.mark.slow
def test_robust_sweep_defaults_fail_alike_in_both_packages():
    """At its defaults (256 scenarios, 80 ticks, spread 0.03) the robust
    sweep fails its own bar (err < 0.1) in the JAX package and in the port
    alike: both settle 0.8856 from the reference on the unseen plant, and
    every printed tick agrees within 1e-3 (the JAX example in the Pallas
    interpreter, the port on its plain versions)."""
    lines, failed = run_example("torch_robust_plant_sweep.py", "--cpu")
    want, failed_j = run_example("robust_plant_sweep.py")
    msg = "robust loop failed to stabilize the unseen plant"
    assert failed == failed_j == msg
    ticks = lambda ls: [_floats(ln) for ln in ls
                        if ln.startswith(("tick ", "final tracking"))]
    got, ref = ticks(lines), ticks(want)
    assert len(got) == len(ref) == 18
    for g, r in zip(got, ref):
        assert g == pytest.approx(r, abs=1e-3)
    assert got[-1][0] == pytest.approx(0.8856, abs=1e-4)
