"""Offline codegen: emit a standalone, dependency-free C++ deployment project.

Counterpart of the JAX package's ``api/codegen.py``, and host code only: the
Riccati precompute runs in float64 numpy on the CPU (the port's
:func:`..precompute.riccati_cache`, the same loop), and no tensor reaches a
device. For the same arguments the emitted project is byte-identical to the
JAX package's: the data arrays print every float64 at ``%.16e``, so the
inputs reach numpy as they were given (never through a float32 tensor), and
the templates, with the generator's name in their headers, are the same
text.

Capability parity with the reference's ``tiny_codegen`` (reference:
src/tinympc/codegen.cpp:218-696): run the Riccati precompute, freeze the whole
solver into source files, and emit a buildable project with an optional C FFI
wrapper for host languages. The *design* is different by intent:

- The reference copies its Eigen tree + its own solver sources into the output
  (codegen.cpp:615-654). Here the emitted project is self-contained C++17 with
  **no third-party dependencies**: a flat-array ADMM solver (~150 LoC) written
  for MCU-class targets, plus baked ``constexpr`` problem data.
- The reference bakes double-precision values into ``float`` storage
  (codegen.cpp:152 emits ``typedef float tinytype``); we default to float too
  (configurable), with the precompute always in float64 on the host.
- The emitted C API matches the reference wrapper's symbol set
  (``set_x0`` ... ``call_tiny_solve``/``get_x``/``get_u``, reference:
  src/tinympc/tiny_wrapper.hpp:14-23) so existing ctypes/MATLAB-style bindings
  port over unchanged.

C and C++ hosts drive the generator through :mod:`.codegen_cli` and the C
shim ``native/src/tiny_codegen_c.cpp`` of this package. The device-side
analogue of codegen, AOT export of the solve, lives in :mod:`.export`.
"""

from __future__ import annotations

import pathlib
import subprocess

import numpy as np
import torch

from ..precompute import riccati_cache
from ..types import Settings

_WRAPPER_SYMBOLS = (
    "set_x0", "set_xref", "set_umin", "set_umax", "set_xmin", "set_xmax",
    "reset_dual_variables", "call_tiny_solve", "get_x", "get_u",
)


def _carray(name: str, arr: np.ndarray) -> str:
    """Emit a flat row-major C array literal at full precision."""
    flat = np.asarray(arr, np.float64).reshape(-1)
    # %.16e always renders a decimal point + exponent — "%.16g" can emit bare
    # integers ("1f" is not a valid literal).
    vals = ",\n    ".join(
        ", ".join(f"{v:.16e}" for v in flat[i:i + 4])
        for i in range(0, len(flat), 4)
    )
    # "extern": const globals default to internal linkage in C++.
    return f"extern const tinytype {name}[{len(flat)}] = {{\n    {vals}\n}};\n"


def _iarray(name: str, arr) -> str:
    """Emit a flat C int array literal."""
    flat = np.asarray(arr, np.int64).reshape(-1)
    vals = ", ".join(str(int(v)) for v in flat)
    return f"extern const int {name}[{len(flat)}] = {{ {vals} }};\n"


def _cone_data(prefix: str, cone_list, max_ball: int) -> str:
    """Emit one cone group's data arrays (size-1 dummies when empty so the
    solver template's extern declarations always link)."""
    if not cone_list:
        return (
            _iarray(f"tiny_{prefix}cone_nball", [0])
            + _iarray(f"tiny_{prefix}cone_ball", [0] * max(1, max_ball))
            + _iarray(f"tiny_{prefix}cone_axis", [0])
            + _carray(f"tiny_{prefix}cone_mu", [0.0])
            + _carray(f"tiny_{prefix}cone_shift", [0.0])
        )
    nball = [len(c.ball) for c in cone_list]
    ball = np.zeros((len(cone_list), max_ball), np.int64)
    for i, c in enumerate(cone_list):
        ball[i, : len(c.ball)] = c.ball
    return (
        _iarray(f"tiny_{prefix}cone_nball", nball)
        + _iarray(f"tiny_{prefix}cone_ball", ball)
        + _iarray(f"tiny_{prefix}cone_axis", [c.axis for c in cone_list])
        + _carray(f"tiny_{prefix}cone_mu", [c.mu for c in cone_list])
        + _carray(f"tiny_{prefix}cone_shift", [c.shift for c in cone_list])
    )


def tiny_codegen(
    A: np.ndarray,
    B: np.ndarray,
    Q: np.ndarray,
    R: np.ndarray,
    rho: float,
    horizon: int,
    output_dir: str | pathlib.Path,
    *,
    x_min: np.ndarray | None = None,
    x_max: np.ndarray | None = None,
    u_min: np.ndarray | None = None,
    u_max: np.ndarray | None = None,
    Xref: np.ndarray | None = None,
    settings: Settings | None = None,
    gen_wrapper: bool = True,
    augment_Q: bool = True,
    scalar_type: str = "float",
    cones=None,
    editable: bool = False,
) -> pathlib.Path:
    """Generate the standalone project. Returns the output directory.

    ``editable=True`` marks the emitted solver source as user-editable and
    makes re-generation *preserve* an existing ``src/tiny_solver.cpp``
    while refreshing the data/dims/build files — the reference's
    modify-the-solver-on-target deployment workflow (its codegen copies
    the library's own solver sources into the output,
    reference: src/tinympc/codegen.cpp:615-654; here the emitted source
    plays that role, and problem-data updates never clobber user edits).

    ``cones`` (a :class:`..solver.cones.ConeSet`) emits second-order-cone
    projections into the generated solver's slack stage — the
    beyond-reference SOC capability (solver/cones.py) carried to the
    embedded C++ deployment path; the emitted projection is the same exact
    closed form, applied after the box clip per knot.

    Interface parity with reference codegen.hpp:10-15 (dims are inferred from
    the array shapes; bounds enable iff provided, mirroring the nullptr checks
    at codegen.cpp:227-243).

    ``augment_Q``: the reference has two conventions for the workspace cost
    diagonal consumed by update_linear_cost's ``-Xref .* Q`` term (SURVEY.md
    §3.1 quirk): its codegen bakes the *rho-augmented* diagonal into generated
    workspaces (reference: codegen.cpp:254-258), while its examples load the
    raw diagonal (examples/quadrotor_hovering.cpp:42-43). Default True mirrors
    reference-codegen output; pass False to reproduce the examples pipeline.
    The Riccati cache itself always uses the augmented costs, as in both
    reference paths.
    """
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    Q = np.asarray(Q, np.float64).reshape(-1)
    R = np.asarray(R, np.float64).reshape(-1)
    nx, nu = B.shape
    N, m = horizon, horizon - 1
    settings = settings or Settings()
    en_input = int(u_min is not None and u_max is not None)
    en_state = int(x_min is not None and x_max is not None)

    def expand(v, default, shape):
        if v is None:
            return np.full(shape, default)
        v = np.asarray(v, np.float64)
        return np.broadcast_to(v, shape).copy()

    u_min_a = expand(u_min, -1e17, (m, nu))
    u_max_a = expand(u_max, 1e17, (m, nu))
    x_min_a = expand(x_min, -1e17, (N, nx))
    x_max_a = expand(x_max, 1e17, (N, nx))
    Xref_a = expand(Xref, 0.0, (N, nx))

    # Offline half: float64 Riccati fixed point (reference codegen.cpp:268-292).
    cache = riccati_cache(A, B, Q, R, rho, dtype=torch.float64,
                          device="cpu")
    Q_emit = Q + rho if augment_Q else Q  # see augment_Q in the docstring

    ucones = tuple(cones.input_cones) if cones is not None else ()
    xcones = tuple(cones.state_cones) if cones is not None else ()
    n_ucones, n_xcones = len(ucones), len(xcones)
    cone_max_ball = max(
        [len(c.ball) for c in ucones + xcones] or [1]
    )
    for c in ucones:
        if c.axis >= nu or any(b >= nu for b in c.ball):
            raise ValueError(f"input cone indices out of range for nu={nu}")
    for c in xcones:
        if c.axis >= nx or any(b >= nx for b in c.ball):
            raise ValueError(f"state cone indices out of range for nx={nx}")

    out = pathlib.Path(output_dir)
    (out / "src").mkdir(parents=True, exist_ok=True)
    (out / "include").mkdir(parents=True, exist_ok=True)

    dims_h = f"""// Generated by accelerated_tinympc_tpu.api.codegen — do not edit.
#pragma once
typedef {scalar_type} tinytype;
enum {{
    TINY_NX = {nx},
    TINY_NU = {nu},
    TINY_N = {N},
    TINY_EN_STATE_BOUND = {en_state},
    TINY_EN_INPUT_BOUND = {en_input},
    TINY_N_INPUT_CONES = {n_ucones},
    TINY_N_STATE_CONES = {n_xcones},
    TINY_CONE_MAX_BALL = {cone_max_ball},
}};
#define TINY_MAX_ITER {int(settings.max_iter)}
#define TINY_CHECK_TERMINATION {int(settings.check_termination)}
#define TINY_ABS_PRI_TOL {float(settings.abs_pri_tol):.9g}
#define TINY_ABS_DUA_TOL {float(settings.abs_dua_tol):.9g}
#define TINY_ALPHA ((tinytype){float(getattr(settings, "alpha", 1.0)):.9g})
"""
    (out / "include" / "tiny_dims.h").write_text(dims_h)

    data_cpp = (
        '#include "../include/tiny_dims.h"\n\n'
        + f"extern const tinytype tiny_rho = {float(cache.rho):.16e};\n"
        + _carray("tiny_Adyn", A)
        + _carray("tiny_Bdyn", B)
        + _carray("tiny_Q", Q_emit)
        + _carray("tiny_Qraw", Q)      # raw diagonals for the runtime
        + _carray("tiny_R", R)         # Riccati refresh (adaptive rho)
        + _carray("tiny_Kinf", np.asarray(cache.Kinf))
        + _carray("tiny_Pinf", np.asarray(cache.Pinf))
        + _carray("tiny_Quu_inv", np.asarray(cache.Quu_inv))
        + _carray("tiny_AmBKt", np.asarray(cache.AmBKt))
        + _carray("tiny_coeff_d2p", np.asarray(cache.coeff_d2p))
        + _carray("tiny_u_min", u_min_a)
        + _carray("tiny_u_max", u_max_a)
        + _carray("tiny_x_min", x_min_a)
        + _carray("tiny_x_max", x_max_a)
        + _carray("tiny_Xref_init", Xref_a)
        + _cone_data("u", ucones, cone_max_ball)
        + _cone_data("x", xcones, cone_max_ball)
    )
    (out / "src" / "tiny_data.cpp").write_text(data_cpp)

    solver_path = out / "src" / "tiny_solver.cpp"
    if editable:
        if not solver_path.exists():
            solver_path.write_text(
                "// User-editable solver source (generated once by\n"
                "// accelerated_tinympc_tpu.api.codegen; re-running\n"
                "// tiny_codegen(editable=True) preserves this file while\n"
                "// regenerating data/dims/build files).\n"
                + _SOLVER_CPP.split("\n", 1)[1]
            )
    else:
        solver_path.write_text(_SOLVER_CPP)
    (out / "src" / "tiny_main.cpp").write_text(_MAIN_CPP)
    if gen_wrapper:
        (out / "src" / "tiny_api.cpp").write_text(_API_CPP)
        (out / "include" / "tiny_api.h").write_text(_API_H)

    wrapper_target = (
        """
add_library(tinympc_deploy SHARED src/tiny_solver.cpp src/tiny_data.cpp src/tiny_api.cpp)
target_include_directories(tinympc_deploy PUBLIC include)
"""
        if gen_wrapper else ""
    )
    (out / "CMakeLists.txt").write_text(f"""cmake_minimum_required(VERSION 3.10)
project(tinympc_deploy CXX)
set(CMAKE_CXX_STANDARD 17)
set(CMAKE_CXX_FLAGS "${{CMAKE_CXX_FLAGS}} -O2")
add_executable(tiny_main src/tiny_main.cpp src/tiny_solver.cpp src/tiny_data.cpp)
target_include_directories(tiny_main PUBLIC include)
{wrapper_target}""")
    all_targets = "tiny_main libtinympc_deploy.so" if gen_wrapper else "tiny_main"
    lib_rule = (
        """libtinympc_deploy.so: src/tiny_solver.cpp src/tiny_data.cpp src/tiny_api.cpp
\t$(CXX) $(CXXFLAGS) -fPIC -shared $^ -o $@
"""
        if gen_wrapper else ""
    )
    (out / "Makefile").write_text(f"""CXX ?= g++
CXXFLAGS ?= -O2 -std=c++17 -Iinclude
all: {all_targets}
tiny_main: src/tiny_main.cpp src/tiny_solver.cpp src/tiny_data.cpp
\t$(CXX) $(CXXFLAGS) $^ -o $@
{lib_rule}clean:
\trm -f tiny_main libtinympc_deploy.so
""")
    wrapper_doc = (
        "The shared library exports the classic TinyMPC\n"
        f"C API: {', '.join(_WRAPPER_SYMBOLS)}.\n"
        if gen_wrapper else
        "Generated without the FFI wrapper (gen_wrapper=False): only the\n"
        "tiny_main binary is built.\n"
    )
    (out / "README.md").write_text(
        "# Generated TinyMPC deployment project\n\n"
        "Self-contained C++17 ADMM MPC solver (no third-party dependencies),\n"
        "generated by accelerated_tinympc_tpu. Build: `make` (or CMake).\n"
        "`./tiny_main x0_0 x0_1 ...` runs one MPC rollout and prints CSV\n"
        "(tick, x..., u...). " + wrapper_doc
    )
    return out


def build_project(out_dir: str | pathlib.Path) -> pathlib.Path:
    """Compile the generated project with make; returns the binary path."""
    out_dir = pathlib.Path(out_dir)
    subprocess.run(["make", "-C", str(out_dir)], check=True,
                   capture_output=True)
    return out_dir / "tiny_main"


# ----------------------------------------------------------------------------
# Templates. The solver below is an original flat-array implementation of the
# same ADMM schedule as the reference hot loop (semantics documented against
# reference src/tinympc/admm.cpp); it shares no code or structure with the
# Eigen-based reference implementation.
# ----------------------------------------------------------------------------

_SOLVER_CPP = r"""// Generated by accelerated_tinympc_tpu.api.codegen — do not edit.
// Flat-array ADMM solver for box-constrained LQR tracking MPC.
// Schedule matches TinyMPC semantics: forward rollout with cached gains,
// slack projection, dual ascent, linear-cost refresh, residual check,
// backward gradient recursion (early exit skips slack save + backward pass).
#include "../include/tiny_dims.h"
#include <cmath>

extern const tinytype tiny_rho;
extern const tinytype tiny_Adyn[];      // (NX, NX) row-major
extern const tinytype tiny_Bdyn[];      // (NX, NU)
extern const tinytype tiny_Q[];         // (NX,) diagonal (workspace convention)
extern const tinytype tiny_Qraw[];      // (NX,) raw diagonal (adaptive refresh)
extern const tinytype tiny_R[];         // (NU,) raw diagonal
extern const tinytype tiny_Kinf[];      // (NU, NX)
extern const tinytype tiny_Pinf[];      // (NX, NX)
extern const tinytype tiny_Quu_inv[];   // (NU, NU)
extern const tinytype tiny_AmBKt[];     // (NX, NX)
extern const tinytype tiny_coeff_d2p[]; // (NX, NU) (unused at runtime; kept
                                        // for parity with the cached set)
extern const tinytype tiny_u_min[];     // (N-1, NU)
extern const tinytype tiny_u_max[];
extern const tinytype tiny_x_min[];     // (N, NX)
extern const tinytype tiny_x_max[];
extern const tinytype tiny_Xref_init[]; // (N, NX)
// Second-order cones ||w[ball]|| <= mu * (w[axis] + shift), applied per knot
// after the box clip (size-1 dummies emitted when a group is empty).
extern const int tiny_ucone_nball[];    // (max(1, N_INPUT_CONES),)
extern const int tiny_ucone_ball[];     // flattened (.., CONE_MAX_BALL)
extern const int tiny_ucone_axis[];
extern const tinytype tiny_ucone_mu[];
extern const tinytype tiny_ucone_shift[];
extern const int tiny_xcone_nball[];
extern const int tiny_xcone_ball[];
extern const int tiny_xcone_axis[];
extern const tinytype tiny_xcone_mu[];
extern const tinytype tiny_xcone_shift[];

namespace {
constexpr int NX = TINY_NX, NU = TINY_NU, N = TINY_N;

struct Workspace {
    tinytype x[N][NX], u[N - 1][NU];
    tinytype q[N][NX], r[N - 1][NU];
    tinytype p[N][NX], d[N - 1][NU];
    tinytype v[N][NX], vnew[N][NX];
    tinytype z[N - 1][NU], znew[N - 1][NU];
    tinytype g[N][NX], y[N - 1][NU];
    tinytype Xref[N][NX];
    // Runtime-mutable copies of the baked bounds (the reference's generated
    // wrapper exposes bound setters over its mutable workspace).
    tinytype u_min[N - 1][NU], u_max[N - 1][NU];
    tinytype x_min[N][NX], x_max[N][NX];
    // Runtime-mutable cache copies (adaptive rho refreshes them; loaded
    // from the baked consts at init — identical values on the fixed path).
    tinytype Kinf[NU][NX], Pinf[NX][NX], Quu_inv[NU][NU], AmBKt[NX][NX];
    tinytype rho = 0;
    int iter = 0, status = 11;
    tinytype pri_state = 0, pri_input = 0, dua_state = 0, dua_input = 0;
};
Workspace W;
bool xref_initialized = false;

inline void matvec(const tinytype *M, const tinytype *vec, tinytype *out,
                   int rows, int cols) {
    for (int i = 0; i < rows; ++i) {
        tinytype acc = 0;
        for (int j = 0; j < cols; ++j) acc += M[i * cols + j] * vec[j];
        out[i] = acc;
    }
}
// out = M^T vec  (M stored (rows, cols); out has cols entries)
inline void matvec_t(const tinytype *M, const tinytype *vec, tinytype *out,
                     int rows, int cols) {
    for (int j = 0; j < cols; ++j) out[j] = 0;
    for (int i = 0; i < rows; ++i)
        for (int j = 0; j < cols; ++j) out[j] += M[i * cols + j] * vec[i];
}

void forward_pass() {
    for (int k = 0; k < N - 1; ++k) {
        tinytype Kx[NU];
        matvec(&W.Kinf[0][0], W.x[k], Kx, NU, NX);
        for (int i = 0; i < NU; ++i) W.u[k][i] = -Kx[i] - W.d[k][i];
        tinytype Ax[NX], Bu[NX];
        matvec(tiny_Adyn, W.x[k], Ax, NX, NX);
        matvec(tiny_Bdyn, W.u[k], Bu, NX, NU);
        for (int i = 0; i < NX; ++i) W.x[k + 1][i] = Ax[i] + Bu[i];
    }
}

// Exact Euclidean projection of w onto ||w[ball]|| <= mu * (w[axis] + shift)
// (same closed form as solver/cones.py project_cone: interior unchanged,
// polar cone to the apex, otherwise onto the boundary).
inline void project_soc(tinytype *w, const int *ball, int nball, int axis,
                        tinytype mu, tinytype shift) {
    tinytype a2 = 0;
    for (int j = 0; j < nball; ++j) a2 += w[ball[j]] * w[ball[j]];
    const tinytype a = std::sqrt(a2);
    const tinytype s = w[axis] + shift;
    if (a <= mu * s) return;
    if (mu * a <= -s) {
        for (int j = 0; j < nball; ++j) w[ball[j]] = 0;
        w[axis] = -shift;
        return;
    }
    const tinytype c = (mu * a + s) / (mu * mu + 1);
    const tinytype scale = a > 0 ? mu * c / a : 0;
    for (int j = 0; j < nball; ++j) w[ball[j]] *= scale;
    w[axis] = c - shift;
}

void update_slack() {
    for (int k = 0; k < N - 1; ++k)
        for (int i = 0; i < NU; ++i) {
            // TINY_ALPHA != 1: OSQP-style over-relaxation (opt-in;
            // alpha = 1 is the reference schedule).
            const tinytype ur = TINY_ALPHA * W.u[k][i]
                + ((tinytype)1 - TINY_ALPHA) * W.z[k][i];
            tinytype zi = ur + W.y[k][i];
            if (TINY_EN_INPUT_BOUND) {
                const tinytype lo = W.u_min[k][i];
                const tinytype hi = W.u_max[k][i];
                zi = zi < lo ? lo : (zi > hi ? hi : zi);
            }
            W.znew[k][i] = zi;
        }
    // Zero-trip when no input cones (TINY_N_INPUT_CONES is an enum, so a
    // plain loop bound — NOT an #if, which would see an undefined macro).
    for (int k = 0; k < N - 1; ++k)
        for (int c = 0; c < TINY_N_INPUT_CONES; ++c)
            project_soc(W.znew[k],
                        tiny_ucone_ball + c * TINY_CONE_MAX_BALL,
                        tiny_ucone_nball[c], tiny_ucone_axis[c],
                        tiny_ucone_mu[c], tiny_ucone_shift[c]);
    for (int k = 0; k < N; ++k)
        for (int i = 0; i < NX; ++i) {
            const tinytype xr = TINY_ALPHA * W.x[k][i]
                + ((tinytype)1 - TINY_ALPHA) * W.v[k][i];
            tinytype vi = xr + W.g[k][i];
            if (TINY_EN_STATE_BOUND) {
                const tinytype lo = W.x_min[k][i];
                const tinytype hi = W.x_max[k][i];
                vi = vi < lo ? lo : (vi > hi ? hi : vi);
            }
            W.vnew[k][i] = vi;
        }
    for (int k = 0; k < N; ++k)
        for (int c = 0; c < TINY_N_STATE_CONES; ++c)
            project_soc(W.vnew[k],
                        tiny_xcone_ball + c * TINY_CONE_MAX_BALL,
                        tiny_xcone_nball[c], tiny_xcone_axis[c],
                        tiny_xcone_mu[c], tiny_xcone_shift[c]);
}

void update_dual() {
    for (int k = 0; k < N - 1; ++k)
        for (int i = 0; i < NU; ++i)
            W.y[k][i] += TINY_ALPHA * W.u[k][i]
                + ((tinytype)1 - TINY_ALPHA) * W.z[k][i]
                - W.znew[k][i];
    for (int k = 0; k < N; ++k)
        for (int i = 0; i < NX; ++i)
            W.g[k][i] += TINY_ALPHA * W.x[k][i]
                + ((tinytype)1 - TINY_ALPHA) * W.v[k][i]
                - W.vnew[k][i];
}

void update_linear_cost() {
    for (int k = 0; k < N - 1; ++k)
        for (int i = 0; i < NU; ++i)
            W.r[k][i] = -W.rho * (W.znew[k][i] - W.y[k][i]);
    for (int k = 0; k < N; ++k)
        for (int i = 0; i < NX; ++i)
            W.q[k][i] = -W.Xref[k][i] * tiny_Q[i]
                        - W.rho * (W.vnew[k][i] - W.g[k][i]);
    // terminal costate: p[N-1] = -Pinf^T Xref[N-1] - rho (vnew - g)
    tinytype Px[NX];
    matvec_t(&W.Pinf[0][0], W.Xref[N - 1], Px, NX, NX);
    for (int i = 0; i < NX; ++i)
        W.p[N - 1][i] = -Px[i]
                        - W.rho * (W.vnew[N - 1][i] - W.g[N - 1][i]);
}

bool termination() {
    constexpr int check = TINY_CHECK_TERMINATION > 0 ? TINY_CHECK_TERMINATION : 1;
    if (TINY_CHECK_TERMINATION <= 0) return false;
    if (W.iter % check != 0) return false;
    tinytype ps = 0, pi = 0, ds = 0, di = 0;
    for (int k = 0; k < N; ++k)
        for (int i = 0; i < NX; ++i) {
            ps = std::fmax(ps, std::fabs(W.x[k][i] - W.vnew[k][i]));
            ds = std::fmax(ds, std::fabs(W.v[k][i] - W.vnew[k][i]));
        }
    for (int k = 0; k < N - 1; ++k)
        for (int i = 0; i < NU; ++i) {
            pi = std::fmax(pi, std::fabs(W.u[k][i] - W.znew[k][i]));
            di = std::fmax(di, std::fabs(W.z[k][i] - W.znew[k][i]));
        }
    W.pri_state = ps; W.pri_input = pi;
    W.dua_state = ds * W.rho; W.dua_input = di * W.rho;
    return ps < TINY_ABS_PRI_TOL && pi < TINY_ABS_PRI_TOL &&
           W.dua_state < TINY_ABS_DUA_TOL && W.dua_input < TINY_ABS_DUA_TOL;
}

void backward_pass() {
    for (int k = N - 2; k >= 0; --k) {
        tinytype Btp[NU];
        matvec_t(tiny_Bdyn, W.p[k + 1], Btp, NX, NU);
        for (int i = 0; i < NU; ++i) Btp[i] += W.r[k][i];
        matvec(&W.Quu_inv[0][0], Btp, W.d[k], NU, NU);
        tinytype Mp[NX], Kr[NX];
        matvec(&W.AmBKt[0][0], W.p[k + 1], Mp, NX, NX);
        matvec_t(&W.Kinf[0][0], W.r[k], Kr, NU, NX);
        for (int i = 0; i < NX; ++i) W.p[k][i] = W.q[k][i] + Mp[i] - Kr[i];
    }
}
}  // namespace

extern "C" {

void tiny_init() {
    if (!xref_initialized) {
        for (int i = 0; i < NU; ++i)
            for (int j = 0; j < NX; ++j) W.Kinf[i][j] = tiny_Kinf[i * NX + j];
        for (int i = 0; i < NX; ++i)
            for (int j = 0; j < NX; ++j) {
                W.Pinf[i][j] = tiny_Pinf[i * NX + j];
                W.AmBKt[i][j] = tiny_AmBKt[i * NX + j];
            }
        for (int i = 0; i < NU; ++i)
            for (int j = 0; j < NU; ++j)
                W.Quu_inv[i][j] = tiny_Quu_inv[i * NU + j];
        W.rho = tiny_rho;
        for (int k = 0; k < N; ++k)
            for (int i = 0; i < NX; ++i) {
                W.Xref[k][i] = tiny_Xref_init[k * NX + i];
                W.x_min[k][i] = tiny_x_min[k * NX + i];
                W.x_max[k][i] = tiny_x_max[k * NX + i];
            }
        for (int k = 0; k < N - 1; ++k)
            for (int i = 0; i < NU; ++i) {
                W.u_min[k][i] = tiny_u_min[k * NU + i];
                W.u_max[k][i] = tiny_u_max[k * NU + i];
            }
        xref_initialized = true;
    }
}

int tiny_solve() {
    tiny_init();
    W.status = 11;
    W.iter = 0;
    for (int it = 0; it < TINY_MAX_ITER; ++it) {
        W.iter = it + 1;
        forward_pass();
        update_slack();
        update_dual();
        update_linear_cost();
        if (termination()) {
            W.status = 1;
            return 0;
        }
        for (int k = 0; k < N; ++k)
            for (int i = 0; i < NX; ++i) W.v[k][i] = W.vnew[k][i];
        for (int k = 0; k < N - 1; ++k)
            for (int i = 0; i < NU; ++i) W.z[k][i] = W.znew[k][i];
        backward_pass();
    }
    return 1;
}

// ---- adaptive rho (beyond the reference; mirrors the engine's
// solver/adaptive_rho.py and the native runtime's tn_solve_adaptive_rho).
// The Riccati refresh runs in double regardless of tinytype — the
// reference insists the precompute run in double for robustness
// (examples/codegen_cartpole.cpp:9-11).
static bool rt_invert(double *M, double *out, int n) {
    double I[NX * NX];
    for (int i = 0; i < n * n; ++i) I[i] = 0;
    for (int i = 0; i < n; ++i) I[i * n + i] = 1.0;
    for (int col = 0; col < n; ++col) {
        int piv = col;
        for (int i = col + 1; i < n; ++i)
            if (std::fabs(M[i * n + col]) > std::fabs(M[piv * n + col]))
                piv = i;
        if (std::fabs(M[piv * n + col]) < 1e-300) return false;
        if (piv != col)
            for (int j = 0; j < n; ++j) {
                std::swap(M[piv * n + j], M[col * n + j]);
                std::swap(I[piv * n + j], I[col * n + j]);
            }
        const double inv = 1.0 / M[col * n + col];
        for (int j = 0; j < n; ++j) { M[col * n + j] *= inv; I[col * n + j] *= inv; }
        for (int i = 0; i < n; ++i) {
            if (i == col) continue;
            const double f = M[i * n + col];
            for (int j = 0; j < n; ++j) {
                M[i * n + j] -= f * M[col * n + j];
                I[i * n + j] -= f * I[col * n + j];
            }
        }
    }
    for (int i = 0; i < n * n; ++i) out[i] = I[i];
    return true;
}

static bool rt_riccati(double rho) {
    // Double-precision infinite-horizon fixed point (reference
    // codegen.cpp:268-292), writing the workspace cache copies.
    static double P[NX * NX], Pn[NX * NX], K[NU * NX], Kp[NU * NX];
    static double BtP[NU * NX], M[NU * NU], Minv[NU * NU], BtPA[NU * NX];
    static double AmBK[NX * NX];
    for (int i = 0; i < NX * NX; ++i) P[i] = 0;
    for (int i = 0; i < NX; ++i) P[i * NX + i] = rho;
    for (int i = 0; i < NU * NX; ++i) Kp[i] = 0;
    for (int it = 0; it < 1000; ++it) {
        for (int i = 0; i < NU; ++i)
            for (int j = 0; j < NX; ++j) {
                double acc = 0;
                for (int t = 0; t < NX; ++t)
                    acc += (double)tiny_Bdyn[t * NU + i] * P[t * NX + j];
                BtP[i * NX + j] = acc;
            }
        for (int i = 0; i < NU; ++i)
            for (int j = 0; j < NU; ++j) {
                double acc = 0;
                for (int t = 0; t < NX; ++t)
                    acc += BtP[i * NX + t] * (double)tiny_Bdyn[t * NU + j];
                M[i * NU + j] = acc + (i == j ? (double)tiny_R[i] + rho : 0.0);
            }
        for (int i = 0; i < NU; ++i)
            for (int j = 0; j < NX; ++j) {
                double acc = 0;
                for (int t = 0; t < NX; ++t)
                    acc += BtP[i * NX + t] * (double)tiny_Adyn[t * NX + j];
                BtPA[i * NX + j] = acc;
            }
        if (!rt_invert(M, Minv, NU)) return false;
        for (int i = 0; i < NU; ++i)
            for (int j = 0; j < NX; ++j) {
                double acc = 0;
                for (int t = 0; t < NU; ++t)
                    acc += Minv[i * NU + t] * BtPA[t * NX + j];
                K[i * NX + j] = acc;
            }
        for (int i = 0; i < NX; ++i)
            for (int j = 0; j < NX; ++j) {
                double acc = 0;
                for (int t = 0; t < NU; ++t)
                    acc += (double)tiny_Bdyn[i * NU + t] * K[t * NX + j];
                AmBK[i * NX + j] = (double)tiny_Adyn[i * NX + j] - acc;
            }
        for (int i = 0; i < NX; ++i)
            for (int j = 0; j < NX; ++j) {
                double acc = 0;
                for (int t = 0; t < NX; ++t) {
                    double pa = 0;
                    for (int t2 = 0; t2 < NX; ++t2)
                        pa += P[t * NX + t2] * AmBK[t2 * NX + j];
                    acc += (double)tiny_Adyn[t * NX + i] * pa;
                }
                Pn[i * NX + j] = acc
                    + (i == j ? (double)tiny_Qraw[i] + rho : 0.0);
            }
        double dmax = 0;
        for (int i = 0; i < NU * NX; ++i)
            dmax = std::fmax(dmax, std::fabs(K[i] - Kp[i]));
        for (int i = 0; i < NX * NX; ++i) P[i] = Pn[i];
        for (int i = 0; i < NU * NX; ++i) Kp[i] = K[i];
        if (dmax < 1e-5) break;
    }
    // refresh the workspace cache copies
    for (int i = 0; i < NU; ++i)
        for (int j = 0; j < NX; ++j) W.Kinf[i][j] = (tinytype)K[i * NX + j];
    for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NX; ++j) W.Pinf[i][j] = (tinytype)P[i * NX + j];
    // Quu_inv at the converged P
    for (int i = 0; i < NU; ++i)
        for (int j = 0; j < NX; ++j) {
            double acc = 0;
            for (int t = 0; t < NX; ++t)
                acc += (double)tiny_Bdyn[t * NU + i] * P[t * NX + j];
            BtP[i * NX + j] = acc;
        }
    for (int i = 0; i < NU; ++i)
        for (int j = 0; j < NU; ++j) {
            double acc = 0;
            for (int t = 0; t < NX; ++t)
                acc += BtP[i * NX + t] * (double)tiny_Bdyn[t * NU + j];
            M[i * NU + j] = acc + (i == j ? (double)tiny_R[i] + rho : 0.0);
        }
    if (!rt_invert(M, Minv, NU)) return false;
    for (int i = 0; i < NU; ++i)
        for (int j = 0; j < NU; ++j)
            W.Quu_inv[i][j] = (tinytype)Minv[i * NU + j];
    for (int i = 0; i < NU; ++i)
        for (int j = 0; j < NX; ++j) {
            double acc = 0;
            for (int t = 0; t < NU; ++t)
                acc += Minv[i * NU + t] * BtPA[t * NX + j];
            K[i * NX + j] = acc;
        }
    for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NX; ++j) {
            double acc = 0;
            for (int t = 0; t < NU; ++t)
                acc += (double)tiny_Bdyn[i * NU + t] * K[t * NX + j];
            W.AmBKt[j][i] = (tinytype)((double)tiny_Adyn[i * NX + j] - acc);
        }
    W.rho = (tinytype)rho;
    return true;
}

int tiny_solve_adaptive_rho(int chunk, int max_total_iter,
                            double adapt_factor, double stall_factor,
                            double rho_min, double rho_max) {
    tiny_init();
    if (chunk < 1) chunk = 25;
    double prev_max = 1e300;
    int total = 0;
    W.status = 11;
    while (total < max_total_iter) {
        for (int it = 0; it < chunk; ++it) {
            W.iter = it + 1;
            forward_pass();
            update_slack();
            update_dual();
            update_linear_cost();
            // residuals recorded every iteration; outer loop owns exit
            tinytype ps = 0, pi = 0, ds = 0, di = 0;
            for (int k = 0; k < N; ++k)
                for (int i = 0; i < NX; ++i) {
                    ps = std::fmax(ps, std::fabs(W.x[k][i] - W.vnew[k][i]));
                    ds = std::fmax(ds, std::fabs(W.v[k][i] - W.vnew[k][i]));
                }
            for (int k = 0; k < N - 1; ++k)
                for (int i = 0; i < NU; ++i) {
                    pi = std::fmax(pi, std::fabs(W.u[k][i] - W.znew[k][i]));
                    di = std::fmax(di, std::fabs(W.z[k][i] - W.znew[k][i]));
                }
            W.pri_state = ps; W.pri_input = pi;
            W.dua_state = ds * W.rho; W.dua_input = di * W.rho;
            for (int k = 0; k < N; ++k)
                for (int i = 0; i < NX; ++i) W.v[k][i] = W.vnew[k][i];
            for (int k = 0; k < N - 1; ++k)
                for (int i = 0; i < NU; ++i) W.z[k][i] = W.znew[k][i];
            backward_pass();
        }
        total += chunk;
        const double pri = std::fmax((double)W.pri_state, (double)W.pri_input);
        const double dua = std::fmax((double)W.dua_state, (double)W.dua_input);
        if (pri < TINY_ABS_PRI_TOL && dua < TINY_ABS_DUA_TOL) {
            W.status = 1;
            break;
        }
        const double max_res = std::fmax(pri, dua);
        const bool stalled = max_res * stall_factor > prev_max;
        prev_max = max_res;
        const double ratio = std::sqrt(std::fmax(pri, 1e-12) /
                                       std::fmax(dua, 1e-12));
        if (stalled && (ratio > adapt_factor || ratio < 1.0 / adapt_factor)) {
            double new_rho = (double)W.rho * ratio;
            new_rho = std::fmin(std::fmax(new_rho, rho_min), rho_max);
            if (new_rho != (double)W.rho) {
                const double scale = (double)W.rho / new_rho;
                for (int k = 0; k < N - 1; ++k)
                    for (int i = 0; i < NU; ++i)
                        W.y[k][i] = (tinytype)(W.y[k][i] * scale);
                for (int k = 0; k < N; ++k)
                    for (int i = 0; i < NX; ++i)
                        W.g[k][i] = (tinytype)(W.g[k][i] * scale);
                if (!rt_riccati(new_rho)) return 2;
                prev_max = 1e300;
            }
        }
    }
    W.iter = total;
    return W.status == 1 ? 0 : 1;
}

// Accessors used by the API wrapper and main.
tinytype *tiny_x_ptr() { return &W.x[0][0]; }
tinytype *tiny_u_ptr() { return &W.u[0][0]; }
tinytype *tiny_y_ptr() { return &W.y[0][0]; }
tinytype *tiny_g_ptr() { return &W.g[0][0]; }
tinytype *tiny_xref_ptr() { tiny_init(); return &W.Xref[0][0]; }
tinytype *tiny_umin_ptr() { tiny_init(); return &W.u_min[0][0]; }
tinytype *tiny_umax_ptr() { tiny_init(); return &W.u_max[0][0]; }
tinytype *tiny_xmin_ptr() { tiny_init(); return &W.x_min[0][0]; }
tinytype *tiny_xmax_ptr() { tiny_init(); return &W.x_max[0][0]; }
int tiny_iter() { return W.iter; }
int tiny_status() { return W.status; }

}  // extern "C"
"""

_API_H = r"""// Generated by accelerated_tinympc_tpu.api.codegen — do not edit.
// C API with the classic TinyMPC wrapper symbol set (ctypes/MATLAB-friendly).
//
// NB: this surface is float32 by design, matching the reference wrapper's
// signatures (tiny_wrapper.hpp:14-23) regardless of the workspace scalar
// type; data round-trips through float here even when tinytype is double.
// Callers needing full tinytype precision should use the direct workspace
// accessors (tiny_x_ptr()/tiny_u_ptr()/... in tiny_data_workspace.cpp),
// which return tinytype* into the live workspace.
#pragma once
#include "tiny_dims.h"
#ifdef __cplusplus
extern "C" {
#endif
void set_x0(float *x0, int verbose);
void set_xref(float *xref, int verbose);          // (N * NX) row-major
void set_umin(float *umin, int verbose);          // ((N-1) * NU)
void set_umax(float *umax, int verbose);
void set_xmin(float *xmin, int verbose);          // (N * NX)
void set_xmax(float *xmax, int verbose);
void reset_dual_variables(int verbose);
int call_tiny_solve(int verbose);
// Adaptive-rho solve (beyond the reference): chunked stall-guarded rho
// rescaling with a double-precision in-binary Riccati refresh.
int call_tiny_solve_adaptive(int chunk, int max_total_iter,
                             double adapt_factor, double stall_factor,
                             double rho_min, double rho_max, int verbose);
void get_x(float *out, int verbose);              // (N * NX)
void get_u(float *out, int verbose);              // ((N-1) * NU)
#ifdef __cplusplus
}
#endif
"""

_API_CPP = r"""// Generated by accelerated_tinympc_tpu.api.codegen — do not edit.
#include "../include/tiny_api.h"
#include <cstdio>

extern "C" {
int tiny_solve();
void tiny_init();
int tiny_solve_adaptive_rho(int, int, double, double, double, double);
tinytype *tiny_x_ptr();
tinytype *tiny_u_ptr();
tinytype *tiny_y_ptr();
tinytype *tiny_g_ptr();
tinytype *tiny_xref_ptr();
tinytype *tiny_umin_ptr();
tinytype *tiny_umax_ptr();
tinytype *tiny_xmin_ptr();
tinytype *tiny_xmax_ptr();
}

extern "C" {

void set_x0(float *x0, int verbose) {
    tiny_init();
    tinytype *x = tiny_x_ptr();
    for (int i = 0; i < TINY_NX; ++i) x[i] = (tinytype)x0[i];
    if (verbose) std::printf("set_x0 done\n");
}

void set_xref(float *xref, int verbose) {
    tinytype *ref = tiny_xref_ptr();
    for (int i = 0; i < TINY_N * TINY_NX; ++i) ref[i] = (tinytype)xref[i];
    if (verbose) std::printf("set_xref done\n");
}

// Bound setters write the workspace's runtime-mutable bound copies
// (interface parity with the reference wrapper, tiny_wrapper.cpp:43-129).
void set_umin(float *umin, int verbose) {
    tinytype *b = tiny_umin_ptr();
    for (int i = 0; i < (TINY_N - 1) * TINY_NU; ++i) b[i] = (tinytype)umin[i];
    if (verbose) std::printf("set_umin done\n");
}
void set_umax(float *umax, int verbose) {
    tinytype *b = tiny_umax_ptr();
    for (int i = 0; i < (TINY_N - 1) * TINY_NU; ++i) b[i] = (tinytype)umax[i];
    if (verbose) std::printf("set_umax done\n");
}
void set_xmin(float *xmin, int verbose) {
    tinytype *b = tiny_xmin_ptr();
    for (int i = 0; i < TINY_N * TINY_NX; ++i) b[i] = (tinytype)xmin[i];
    if (verbose) std::printf("set_xmin done\n");
}
void set_xmax(float *xmax, int verbose) {
    tinytype *b = tiny_xmax_ptr();
    for (int i = 0; i < TINY_N * TINY_NX; ++i) b[i] = (tinytype)xmax[i];
    if (verbose) std::printf("set_xmax done\n");
}

void reset_dual_variables(int verbose) {
    tinytype *y = tiny_y_ptr();
    tinytype *g = tiny_g_ptr();
    for (int i = 0; i < (TINY_N - 1) * TINY_NU; ++i) y[i] = 0;
    for (int i = 0; i < TINY_N * TINY_NX; ++i) g[i] = 0;
    if (verbose) std::printf("reset_dual_variables done\n");
}

int call_tiny_solve(int verbose) {
    int flag = tiny_solve();
    if (verbose) std::printf("tiny_solve exit %d\n", flag);
    return flag;
}

int call_tiny_solve_adaptive(int chunk, int max_total_iter,
                             double adapt_factor, double stall_factor,
                             double rho_min, double rho_max, int verbose) {
    int flag = tiny_solve_adaptive_rho(chunk, max_total_iter, adapt_factor,
                                       stall_factor, rho_min, rho_max);
    if (verbose) std::printf("tiny_solve_adaptive exit %d\n", flag);
    return flag;
}

void get_x(float *out, int verbose) {
    tinytype *x = tiny_x_ptr();
    for (int i = 0; i < TINY_N * TINY_NX; ++i) out[i] = (float)x[i];
    if (verbose) std::printf("get_x done\n");
}

void get_u(float *out, int verbose) {
    tinytype *u = tiny_u_ptr();
    for (int i = 0; i < (TINY_N - 1) * TINY_NU; ++i) out[i] = (float)u[i];
    if (verbose) std::printf("get_u done\n");
}

}  // extern "C"
"""

_MAIN_CPP = r"""// Generated by accelerated_tinympc_tpu.api.codegen — do not edit.
// Demo MPC loop: reads x0 from argv (defaults to zeros), runs 100 receding-
// horizon ticks against the nominal plant, prints CSV rows
// "tick,x...,u...,iter,status".
#include "../include/tiny_dims.h"
#include <cstdio>
#include <cstdlib>

extern "C" {
int tiny_solve();
void tiny_init();
tinytype *tiny_x_ptr();
tinytype *tiny_u_ptr();
tinytype *tiny_y_ptr();
tinytype *tiny_g_ptr();
int tiny_iter();
int tiny_status();
}
extern const tinytype tiny_Adyn[];
extern const tinytype tiny_Bdyn[];

int main(int argc, char **argv) {
    const int NX = TINY_NX, NU = TINY_NU;
    tinytype x0[TINY_NX] = {0};
    int ticks = 100;
    for (int i = 0; i < NX && i + 1 < argc; ++i)
        x0[i] = (tinytype)std::atof(argv[i + 1]);
    if (argc > NX + 1) ticks = std::atoi(argv[NX + 1]);

    tiny_init();
    tinytype *x = tiny_x_ptr();
    tinytype *u = tiny_u_ptr();
    tinytype *y = tiny_y_ptr();
    tinytype *g = tiny_g_ptr();

    for (int t = 0; t < ticks; ++t) {
        for (int i = 0; i < NX; ++i) x[i] = x0[i];
        for (int i = 0; i < (TINY_N - 1) * NU; ++i) y[i] = 0;
        for (int i = 0; i < TINY_N * NX; ++i) g[i] = 0;
        tiny_solve();
        std::printf("%d", t);
        for (int i = 0; i < NX; ++i) std::printf(",%.9g", (double)x0[i]);
        for (int i = 0; i < NU; ++i) std::printf(",%.9g", (double)u[i]);
        std::printf(",%d,%d\n", tiny_iter(), tiny_status());
        // nominal plant step x0 = A x0 + B u0 (pre-projection u, as in the
        // reference examples)
        tinytype xn[TINY_NX];
        for (int i = 0; i < NX; ++i) {
            tinytype acc = 0;
            for (int j = 0; j < NX; ++j) acc += tiny_Adyn[i * NX + j] * x0[j];
            for (int j = 0; j < NU; ++j) acc += tiny_Bdyn[i * NU + j] * u[j];
            xn[i] = acc;
        }
        for (int i = 0; i < NX; ++i) x0[i] = xn[i];
    }
    return 0;
}
"""
