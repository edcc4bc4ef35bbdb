"""PyTorch port, the utilities against the JAX package on the CPU:
``utils/profiling.py`` (the three cost models value for value, the card's
bounds pinned to PERF.md's rows, ``time_fn``, ``trace``), a JAX checkpoint
resumed in the port (``utils/serialization.py``; the file format itself:
``tests/test_torch_serialization.py``) and ``utils/debugging.py``
(``finite_state``/``health_report`` equal to JAX's on a diverging batch,
``debug_nans``).

Bars: the cost models exactly; the resumed mission in float64 within 1e-6
(the two packages' float32 scan tiers sit ~1e-5 apart after 20 ticks,
their float64 ones 1e-10)."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
from accelerated_tinympc_tpu.models import quadrotor_hovering_setup as hover_j
from accelerated_tinympc_tpu.utils import debugging as dbg_j
from accelerated_tinympc_tpu.utils import profiling as prof_j
from accelerated_tinympc_tpu.utils import serialization as ser_j
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu_torch.utils import debugging as dbg_t
from accelerated_tinympc_tpu_torch.utils import profiling as prof_t
from accelerated_tinympc_tpu_torch.utils import serialization as ser_t

from torch_parity_utils import DEV, cache_to_torch, problem_to_torch, to_np

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------------------------------------- profiling --

@pytest.mark.parametrize("shape", [(12, 4, 10, 100), (8, 3, 1024, 5),
                                   (5, 2, 24, 7), (33, 33, 16, 3),
                                   (6, 3, 15, 300)])
def test_cost_models_equal_jax(shape):
    """solver_cost, hetero_cost and stream_cost give the JAX package's
    values exactly, at its default paddings and at others."""
    nx, nu, N, iters = shape
    for name in ("solver_cost", "hetero_cost", "stream_cost"):
        fj, ft = getattr(prof_j, name), getattr(prof_t, name)
        assert ft(nx, nu, N, iters) == fj(nx, nu, N, iters), name
    assert (prof_t.solver_cost(nx, nu, N, iters, lane_pad=64)
            == prof_j.solver_cost(nx, nu, N, iters, lane_pad=64))
    for name in ("hetero_cost", "stream_cost"):
        assert (getattr(prof_t, name)(nx, nu, N, iters, sublane_pad=4)
                == getattr(prof_j, name)(nx, nu, N, iters, sublane_pad=4))


def test_card_bounds_give_the_perf_rows():
    """The bound helpers moved from chip_smoke.py unchanged: K1 (quadrotor
    fixed-100 at 65,536) 2.201 ms, K7 (the robust family) 0.873 ms, K9
    (8/3/1024 at 8,192) 5.829 [69.09], K11 (12/4/256 at 8,192) 3.093
    [25.01], as PERF.md's table; chip_smoke.py imports them and keeps no
    copy."""
    B = 65536
    ms, by = prof_t.solve_bound((12, 4, 10), 100 * B, B, B)
    assert (round(ms, 3), by) == (2.201, "operations")
    ms, by = prof_t.hetero_bound((12, 4, 10), 100 * B, B)
    assert (round(ms, 3), by) == (0.873, "operations")
    ms, by, streamed = prof_t.stream_bound((8, 3, 1024), 100 * 8192, 8192,
                                           True)
    assert (round(ms, 3), by, round(streamed, 2)) == (5.829, "operations",
                                                      69.09)
    ms, by, streamed = prof_t.stream_bound((12, 4, 256), 100 * 8192, 8192,
                                           False)
    assert (round(ms, 3), round(streamed, 2)) == (3.093, 25.01)
    ms, by = prof_t.riccati_bound(12, 4, 0, B)
    assert ms > 0 and by in ("operations", "bytes")
    src = (ROOT / "chip_smoke.py").read_text()
    assert "from accelerated_tinympc_tpu_torch.utils.profiling import" in src
    for name in ("solve_bound", "riccati_bound", "hetero_bound",
                 "stream_bound", "PEAK_FP32_FLOPS =", "PEAK_BYTES_PER_S ="):
        assert not re.search(rf"^(def )?{name}", src, re.M), name


def test_time_fn_and_trace(tmp_path):
    """time_fn returns JAX's keys (perf_counter on the CPU); trace writes a
    Chrome trace under the log directory."""
    x = torch.ones((64, 64))
    stats = prof_t.time_fn(lambda a: a @ a.T, x, reps=2)
    assert set(stats) == {"best_s", "mean_s", "reps"}
    assert stats["best_s"] > 0 and stats["mean_s"] >= stats["best_s"]
    assert stats["reps"] == 2.0
    with prof_t.trace(str(tmp_path)) as prof:
        (x @ x.T).sum()
    files = list(tmp_path.rglob("*"))
    assert any("trace" in p.name and p.suffix == ".json" for p in files), files
    assert any("mm" in e.key for e in prof.key_averages())


# ------------------------------------------------------ resume, debugging --

def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A (State, x) checkpoint written by the JAX package after 10 ticks of
    mpc_rollout resumes in the port's mpc_rollout to the JAX package's
    uninterrupted 20-tick mission (the JAX run continued in memory) within
    1e-6: the final plant state and the 10 applied controls. Float64: the
    packages' float32 scan tiers differ by more than the bar."""
    from accelerated_tinympc_tpu.api import mpc_rollout as rollout_j
    from accelerated_tinympc_tpu_torch.api import mpc_rollout as rollout_t

    with jax.enable_x64(True):
        pj, cj, x0 = hover_j()
        pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), pj)
        cj = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), cj)
        settings = atm_j.Settings(max_iter=15, check_termination=0)
        ten = jax.jit(lambda s, x: rollout_j(pj, cj, settings, x, 10,
                                             state=s))
        st10, x10, _ = ten(atm_j.init_state(12, 4, 10, jnp.float64),
                           jnp.asarray(x0, jnp.float64))
        ck = tmp_path / "state.npz"
        ser_j.save_pytree(ck, (st10, x10))
        _, x20, trace20 = ten(st10, x10)
        x20, u20 = np.asarray(x20), np.asarray(trace20.u)

    pt = problem_to_torch(pj, torch.float64)   # the same float64 values
    ct = cache_to_torch(cj, torch.float64)
    template = (atm_t.init_state(12, 4, 10, torch.float64, device=DEV),
                torch.zeros(12, dtype=torch.float64))
    st, x = ser_t.load_like(ck, template)
    assert isinstance(st, atm_t.State) and st.iter.dtype == torch.int32
    _, xf, trace = rollout_t(pt, ct, atm_t.Settings(
        max_iter=15, check_termination=0), x, 10, state=st)
    np.testing.assert_allclose(to_np(xf), x20, rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(trace.u), u20, rtol=0, atol=1e-6)


def test_health_on_a_diverging_batch_equals_jax(monkeypatch):
    """JAX's own unstable plant (A * 3, bounds off, 200 fixed iterations,
    tests/test_utils.py): finite_state and health_report equal the JAX
    package's; debug_nans makes the solve raise, naming the field; with it
    off the entry points do no check at all."""
    from accelerated_tinympc_tpu.solver.batched import (
        init_state_batched as init_j, solve_batched as solve_j,
    )
    from accelerated_tinympc_tpu_torch.solver.batched import (
        init_state_batched, solve_batched,
    )

    pj, cj, x0 = hover_j()
    pj = pj.replace(A=pj.A * 3.0)
    settings = dict(max_iter=200, check_termination=0,
                    en_state_bound=False, en_input_bound=False)
    x0s = np.stack([np.asarray(x0), np.zeros(12)]).astype(np.float32)
    sj = init_j(2, 12, 4, 10)
    sj = sj.replace(x=sj.x.at[:, 0, :].set(jnp.asarray(x0s)))
    out_j = jax.jit(lambda s: solve_j(s, pj, cj, atm_j.Settings(**settings)))(
        sj)

    pt, ct, _ = atm_t.models.quadrotor_hovering_setup(device=DEV)
    pt = pt.replace(A=pt.A * 3.0)
    st = init_state_batched(2, 12, 4, 10, device=DEV)
    x = st.x.clone()
    x[:, 0, :] = torch.as_tensor(x0s)
    st = st.replace(x=x)
    ts = atm_t.Settings(**settings)

    def guarded(*a, **k):
        raise AssertionError("a check ran with debug_nans off")

    monkeypatch.setattr(dbg_t, "_named_tensors", guarded)
    out_t = solve_batched(st, pt, ct, ts)       # off: no check runs
    monkeypatch.undo()

    np.testing.assert_array_equal(to_np(dbg_t.finite_state(out_t)),
                                  np.asarray(dbg_j.finite_state(out_j)))
    rep_t, rep_j = dbg_t.health_report(out_t), dbg_j.health_report(out_j)
    assert rep_t.keys() == rep_j.keys()
    assert not rep_j["all_finite"]
    for k in ("all_finite", "nonfinite_instances", "converged_fraction",
              "unconverged_instances"):
        assert rep_t[k] == rep_j[k], k
    mj, mt = rep_j["max_residual"], rep_t["max_residual"]
    assert (np.isnan(mj) and np.isnan(mt)) or mj == mt or \
        abs(mt - mj) <= 1e-3 * abs(mj)

    with dbg_t.debug_nans():
        with pytest.raises(FloatingPointError,
                           match=r"solve_batched: non-finite values in x\b"):
            solve_batched(st, pt, ct, ts)
    assert not dbg_t.DEBUG_NANS
    single = atm_t.set_x0(atm_t.init_state(12, 4, 10, device=DEV),
                          torch.as_tensor(x0s[0]))
    with dbg_t.debug_nans(), pytest.raises(FloatingPointError,
                                           match=r"^solve: "):
        atm_t.solve(single, pt, ct, ts)
