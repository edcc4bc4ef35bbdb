"""PyTorch port: data model, model setups and host precompute vs the JAX
package. Float64 host math must agree to 1e-12 (both sides run the same
numpy recipe; only the order of a few float64 products may differ)."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
import accelerated_tinympc_tpu.models as models_j
import accelerated_tinympc_tpu_torch as atm_t
import accelerated_tinympc_tpu_torch.models as models_t
from accelerated_tinympc_tpu.precompute import (
    condensed_operators as condensed_operators_j,
    riccati_cache as riccati_cache_j,
)

from torch_parity_utils import DEV, assert_fields_close, fields_of, to_np

F64_ATOL = 1e-12
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _plant(name):
    if name == "quadrotor":
        p, c, _ = models_j.quadrotor_hovering_setup()
        d = np.load(ROOT / "accelerated_tinympc_tpu/models/data/"
                    "quadrotor_20hz_params.npz")
        return d["Adyn"], d["Bdyn"], d["Q"], d["R"], float(d["rho"]), 10
    if name == "cartpole":
        from accelerated_tinympc_tpu.models import cartpole as cp
        return cp.A, cp.B, cp.Q_DIAG, cp.R_DIAG, cp.RHO, 10
    p, rho = models_j.random_lti_problem(5, 6, 3, 7)
    return (np.asarray(p.A), np.asarray(p.B), np.asarray(p.Q),
            np.asarray(p.R), rho, 7)


@pytest.mark.parametrize("name", ["quadrotor", "cartpole", "random_lti"])
def test_riccati_cache_matches_jax(name):
    A, B, Q, R, rho, _N = _plant(name)
    want = riccati_cache_j(A, B, Q, R, rho, dtype=np.float64)
    got = atm_t.riccati_cache(A, B, Q, R, rho, dtype=torch.float64, device=DEV)
    assert_fields_close(got, want, atol=F64_ATOL)


@pytest.mark.parametrize("name", ["quadrotor", "cartpole", "random_lti"])
def test_condensed_operators_match_jax(name):
    A, B, Q, R, rho, N = _plant(name)
    import jax

    cache_j = riccati_cache_j(A, B, Q, R, rho, dtype=np.float64)
    cache_t = atm_t.riccati_cache(A, B, Q, R, rho, dtype=torch.float64,
                                  device=DEV)
    with jax.enable_x64(True):  # the JAX function returns jnp arrays
        want = condensed_operators_j(cache_j, A, B, N, dtype=np.float64)
        want = fields_of(want)
    got = atm_t.condensed_operators(cache_t, A, B, N, dtype=torch.float64,
                                    device=DEV)
    assert_fields_close(got, want, atol=F64_ATOL)


@pytest.mark.parametrize("hz", [20, 50, 100])
def test_shipped_cache_loads_identically(hz):
    want = models_j.load_quadrotor_cache(hz)
    got = models_t.load_quadrotor_cache(hz, device=DEV)
    assert_fields_close(got, want, atol=0.0)
    wantp = models_j.load_quadrotor_problem(hz)
    gotp = models_t.load_quadrotor_problem(hz, device=DEV)
    assert_fields_close(gotp, wantp, atol=0.0)


@pytest.mark.parametrize("family", ["hovering", "tracking", "cartpole",
                                    "random_lti"])
def test_model_setups_match_jax(family):
    if family == "hovering":
        pj, cj, xj = models_j.quadrotor_hovering_setup()
        pt, ct, xt = models_t.quadrotor_hovering_setup(device=DEV)
        assert_fields_close(ct, cj, atol=0.0)
        np.testing.assert_array_equal(xt, xj)
    elif family == "tracking":
        pj, cj, xj, Xj = models_j.quadrotor_tracking_setup()
        pt, ct, xt, Xt = models_t.quadrotor_tracking_setup(device=DEV)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(Xt, Xj)
    elif family == "cartpole":
        pj = models_j.cartpole_problem(8)
        pt = models_t.cartpole_problem(8, device=DEV)
        assert models_t.CARTPOLE_RHO == models_j.CARTPOLE_RHO
    else:
        pj, rj = models_j.random_lti_problem(11, 5, 2, 6)
        pt, rt = models_t.random_lti_problem(11, 5, 2, 6, device=DEV)
        assert rj == rt
    assert_fields_close(pt, pj, atol=0.0)
    assert (pt.nx, pt.nu, pt.horizon) == (pj.nx, pj.nu, pj.horizon)


def test_state_helpers_match_jax():
    sj = atm_j.init_state(3, 2, 5)
    st = atm_t.init_state(3, 2, 5, device=DEV)
    assert_fields_close(st, sj, atol=0.0)
    x0 = np.arange(3, dtype=np.float32)
    sj = atm_j.set_x0(sj.replace(y=sj.y + 1.0, g=sj.g + 2.0), x0)
    st = atm_t.set_x0(st.replace(y=st.y + 1.0, g=st.g + 2.0), x0)
    assert_fields_close(st, sj, atol=0.0)
    assert_fields_close(atm_t.reset_duals(st), atm_j.reset_duals(sj), atol=0.0)
    assert (atm_t.SOLVED, atm_t.UNSOLVED) == (atm_j.SOLVED, atm_j.UNSOLVED)


def test_settings_defaults_and_replace():
    sj, st = atm_j.Settings(), atm_t.Settings()
    for k in ("max_iter", "check_termination", "en_state_bound",
              "en_input_bound", "alpha"):
        assert getattr(st, k) == getattr(sj, k)
    assert st.abs_pri_tol == float(sj.abs_pri_tol)
    assert st.replace(alpha=1.6).alpha == 1.6 and st.alpha == 1.0
    p = models_t.cartpole_problem(4, device=DEV)
    assert p.to(dtype=torch.float64).A.dtype == torch.float64


def test_device_defaults_to_cuda():
    """Entry points default to device="cuda": without a card and without
    device="cpu" they fail with torch's own error instead of carrying on."""
    if torch.cuda.is_available():
        assert atm_t.init_state(2, 1, 3).x.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            atm_t.init_state(2, 1, 3)
        with pytest.raises((RuntimeError, AssertionError)):
            models_t.quadrotor_hovering_setup()


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import accelerated_tinympc_tpu_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'accelerated_tinympc_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-S", "-c",
         "import sys, site; site.main() if False else None\n" + code],
        cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": _site_paths()},
    )
    assert out.returncode == 0, out.stdout + out.stderr


def _site_paths() -> str:
    """sys.path of this interpreter, for a child started with -S so that no
    start-up hook pre-imports anything."""
    return ":".join(p for p in sys.path if p)


def test_port_sources_name_no_jax():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|accelerated_tinympc_tpu)(\s|\.|$)")
    files = [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "accelerated_tinympc_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            assert not pat.match(line), f"{f}:{n}: {line}"
