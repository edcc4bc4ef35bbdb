"""The port's offline codegen (``accelerated_tinympc_tpu_torch.api.codegen``),
its CLI and its C shim, on the CPU.

The emitted projects are held byte for byte to the JAX package's
``tiny_codegen`` on the same numpy inputs: through the Python entry (six
configurations), through the port's CLI, and through the port's C shim
driving ``native/examples/codegen_cartpole_host.cpp``. Only
``test_generated_binary_matches_engine`` compiles an emitted project (the
JAX suite compiles the same bytes); it holds the binary's MPC to the port's
scan tier at ``tests/test_codegen.py``'s 1e-4.
"""

import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu.api import tiny_codegen as codegen_j
from accelerated_tinympc_tpu_torch.api import build_project
from accelerated_tinympc_tpu_torch.api import tiny_codegen as codegen_t
from accelerated_tinympc_tpu_torch.models import cartpole
from accelerated_tinympc_tpu_torch.models.quadrotor import (
    DATA_DIR, HOVER_SETPOINT,
)
from accelerated_tinympc_tpu_torch.native import CODEGEN_SHIM

ROOT = pathlib.Path(__file__).resolve().parents[1]
X0 = np.array([0.3, 0.0, 0.1, 0.0])
TICKS = 60

# The reference codegen example's data (codegen_cartpole.cpp:17-38,50-60;
# the C host's column-major A transposed to row-major, C-ordered as the CLI
# path reads it: an F-ordered view drifts the Riccati at 1e-13).
CP_A = cartpole.A.copy()
CP_B = cartpole.B.copy()
CP_SETS = dict(abs_pri_tol=1e-3, abs_dua_tol=1e-3, max_iter=100,
               check_termination=1)


def _landing():
    dt, I3 = 0.1, np.eye(3)
    A = np.block([[I3, dt * I3], [0 * I3, I3]])
    B = np.vstack([0.5 * dt * dt * I3, dt * I3])
    Q = np.concatenate([np.full(3, 10.0), np.full(3, 1.0)])
    return A, B, Q, np.full(3, 1.0)


def _cases():
    """name -> (positional args, keyword args, settings kw, cones or None);
    the JAX tests' configurations."""
    q = np.load(DATA_DIR / "quadrotor_20hz_params.npz")
    p, _rho = atm_t.models.random_lti_problem(seed=3, nx=8, nu=3,
                                              horizon=15, bound=5.0,
                                              q_scale=100.0, r_scale=0.1,
                                              device="cpu")
    rl, _rho = atm_t.models.random_lti_problem(seed=1604, nx=16, nu=4,
                                               horizon=20, device="cpu")
    cp = (cartpole.A, cartpole.B, cartpole.Q_DIAG, cartpole.R_DIAG)
    cp_box = dict(x_min=-5.0, x_max=5.0, u_min=-5.0, u_max=5.0)
    return {
        "quadrotor": ((q["Adyn"], q["Bdyn"], q["Q"], q["R"],
                       float(q["rho"]), 10),
                      dict(u_min=-0.5, u_max=0.5, x_min=-5.0, x_max=5.0,
                           Xref=np.tile(HOVER_SETPOINT, (10, 1)),
                           gen_wrapper=False),
                      dict(max_iter=30, check_termination=0), None),
        "cartpole_wrapper": ((*cp, cartpole.RHO, 10),
                             dict(**cp_box, augment_Q=False),
                             dict(max_iter=25, check_termination=0), None),
        "cones": ((*_landing(), 1.0, 15), dict(augment_Q=False),
                  dict(max_iter=150, check_termination=0), "thrust"),
        "adaptive_rho": ((p.A.numpy(), p.B.numpy(), p.Q.numpy(),
                          p.R.numpy(), 1e-2, 15),
                         dict(u_min=np.full((14, 3), -0.3),
                              u_max=np.full((14, 3), 0.3),
                              scalar_type="double"),
                         dict(max_iter=1500, check_termination=1,
                              abs_pri_tol=2e-3, abs_dua_tol=2e-3), None),
        "alpha": ((*cp, cartpole.RHO, 10), dict(**cp_box, augment_Q=False),
                  dict(max_iter=25, check_termination=0, alpha=1.6), None),
        "random_lti": ((rl.A.numpy(), rl.B.numpy(), rl.Q.numpy(),
                        rl.R.numpy(), 1.0, 20),
                       dict(u_min=rl.u_min[0].numpy(),
                            u_max=rl.u_max[0].numpy(), gen_wrapper=False),
                       dict(), None),
    }


def _cones(pkg, which):
    if which is None:
        return None
    c = pkg.solver.cones
    return c.ConeSet(input_cones=(c.Cone(ball=(0, 1), axis=2, mu=1.0),))


def _files(out: pathlib.Path) -> dict:
    return {str(p.relative_to(out)): p.read_bytes()
            for p in sorted(out.rglob("*")) if p.is_file()}


def _same_project(a: pathlib.Path, b: pathlib.Path) -> None:
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb) and fa
    for rel in fa:
        assert fa[rel] == fb[rel], rel


@pytest.mark.parametrize("name", sorted(_cases()))
def test_emitted_project_is_the_jax_projects_bytes(tmp_path, name):
    """The Python entry emits, file for file, the JAX package's bytes."""
    args, kw, sets, cones = _cases()[name]
    for pkg, gen, sub in ((atm_j, codegen_j, "jax"), (atm_t, codegen_t,
                                                       "torch")):
        gen(*args, tmp_path / sub, settings=pkg.Settings(**sets),
            cones=_cones(pkg, cones), **kw)
    _same_project(tmp_path / "jax", tmp_path / "torch")


def _argfile(path: pathlib.Path) -> None:
    """The shim's binary args (``api/codegen_cli.py``) for the reference
    cartpole example: column-major matrices, bounds (nx, N) / (nu, N-1)."""
    nx, nu, N = 4, 1, 10
    col = lambda a: np.asarray(a, "<f8").T.reshape(-1).tobytes()
    raw = (b"TINYCGC1"
           + struct.pack("<8i", nx, nu, N, 100, 1, 1, 1, 1)
           + struct.pack("<3d", 0.1, 1e-3, 1e-3)
           + col(CP_A) + col(CP_B)
           + np.asarray([10.0, 1.0, 10.0, 1.0], "<f8").tobytes()
           + np.asarray([1.0], "<f8").tobytes()
           + np.full(nx * N, -5.0, "<f8").tobytes()
           + np.full(nx * N, 5.0, "<f8").tobytes()
           + np.full(nu * (N - 1), -5.0, "<f8").tobytes()
           + np.full(nu * (N - 1), 5.0, "<f8").tobytes())
    path.write_bytes(raw)


def _python_entry(out: pathlib.Path, gen=codegen_t, pkg=atm_t) -> None:
    """What the CLI and the shim must emit: the reference example's
    arguments through the Python entry."""
    gen(CP_A, CP_B, np.array([10.0, 1.0, 10.0, 1.0]), np.array([1.0]),
        rho=0.1, horizon=10, output_dir=out,
        x_min=-5.0, x_max=5.0, u_min=-5.0, u_max=5.0,
        settings=pkg.Settings(**CP_SETS), gen_wrapper=True, augment_Q=True,
        scalar_type="float")


def test_cli_matches_jax_bytes(tmp_path):
    """``python -m accelerated_tinympc_tpu_torch.api.codegen_cli argfile
    outdir`` emits the JAX package's bytes, imports no JAX and starts no
    CUDA context."""
    _argfile(tmp_path / "args.bin")
    probe = ("import runpy, sys, torch; sys.argv = sys.argv[1:]\n"
             "had_jax = 'jax' in sys.modules\n"
             "try:\n"
             "    runpy.run_module('accelerated_tinympc_tpu_torch.api."
             "codegen_cli', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    assert e.code == 0, e.code\n"
             "assert had_jax or 'jax' not in sys.modules\n"
             "assert not torch.cuda.is_initialized()\n")
    subprocess.run(
        [sys.executable, "-c", probe, "codegen_cli",
         str(tmp_path / "args.bin"), str(tmp_path / "cli")],
        check=True, capture_output=True, timeout=300, cwd=ROOT)
    _python_entry(tmp_path / "jax", codegen_j, atm_j)
    _same_project(tmp_path / "cli", tmp_path / "jax")


def test_c_shim_matches_python_entry(tmp_path):
    """The port's C shim (same C ABI as ``native/src/tiny_codegen_c.cpp``)
    driven by the reference example's C++ host emits the Python entry's
    bytes; it builds as a library exporting ``tiny_codegen``."""
    import ctypes

    from accelerated_tinympc_tpu_torch.native import build_codegen_library

    exe = tmp_path / "codegen_cartpole_host"
    subprocess.run(
        ["g++", "-O2", "-std=c++17",
         str(ROOT / "native/examples/codegen_cartpole_host.cpp"),
         str(CODEGEN_SHIM), "-o", str(exe)],
        check=True, capture_output=True)
    res = subprocess.run(
        [str(exe), str(ROOT), str(tmp_path / "from_c")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "TINYMPC_PYTHON": sys.executable,
             "TMPDIR": str(tmp_path)})
    assert res.returncode == 0, res.stderr + res.stdout
    assert "HOORAY" in res.stdout
    assert not list(tmp_path.glob("tiny_codegen_args_*")), "args file left"
    _python_entry(tmp_path / "from_py")
    _same_project(tmp_path / "from_c", tmp_path / "from_py")
    lib = ctypes.CDLL(str(build_codegen_library()))
    assert hasattr(lib, "tiny_codegen")


def test_generated_binary_matches_engine(tmp_path):
    """JAX's ``test_generated_binary_matches_engine`` against the port: the
    emitted cartpole project, built, runs 60 MPC ticks within 1e-4 of the
    port's scan tier (float32 on the CPU)."""
    out = codegen_t(
        cartpole.A, cartpole.B, cartpole.Q_DIAG, cartpole.R_DIAG,
        rho=cartpole.RHO, horizon=10, output_dir=tmp_path / "cartpole",
        x_min=-5.0, x_max=5.0, u_min=-5.0, u_max=5.0,
        settings=atm_t.Settings(max_iter=25, check_termination=0),
        augment_Q=False)
    binary = build_project(out)
    res = subprocess.run([str(binary), *[str(v) for v in X0], str(TICKS)],
                         capture_output=True, text=True, check=True)
    rows = np.array([[float(v) for v in line.split(",")]
                     for line in res.stdout.strip().splitlines()])
    assert rows.shape[0] == TICKS
    problem = cartpole.cartpole_problem(10, device="cpu")
    cache = atm_t.riccati_cache(cartpole.A, cartpole.B, cartpole.Q_DIAG,
                                cartpole.R_DIAG, cartpole.RHO, device="cpu")
    _st, _x, trace = atm_t.mpc_rollout(
        problem, cache, atm_t.Settings(max_iter=25, check_termination=0),
        torch.as_tensor(X0, dtype=torch.float32), TICKS)
    np.testing.assert_allclose(rows[:, 5:6], trace.u.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(rows[:, 1:5], trace.x.numpy(), rtol=0,
                               atol=1e-4)


def test_codegen_examples_emit_their_twins_bytes(tmp_path):
    """``examples/torch_codegen_cartpole.py`` and ``torch_codegen_random.py``
    (no build) emit their JAX twins' projects byte for byte."""
    import runpy

    def run(name, *args):
        argv = sys.argv
        try:
            sys.argv = [name, *args]
            runpy.run_path(str(ROOT / "examples" / name), run_name="__main__")
        finally:
            sys.argv = argv

    for twin in ("", "torch_"):
        run(f"{twin}codegen_cartpole.py", "--no-build", "--out",
            str(tmp_path / f"{twin}cartpole"))
        run(f"{twin}codegen_random.py", "--out-root",
            str(tmp_path / f"{twin}random"), "--shapes", "2x2x3,12x4x10")
    for what in ("cartpole", "random"):
        _same_project(tmp_path / what, tmp_path / f"torch_{what}")
