"""CLI entry for C/C++-hosted code generation.

The reference exposes ``tiny_codegen`` as a C-ABI symbol so native hosts can
drive generation (reference: src/tinympc/codegen.hpp:10-15, used by
examples/codegen_cartpole.cpp:63-66). Here the generator lives in Python
(:func:`.codegen.tiny_codegen`); the C shim of this package,
``accelerated_tinympc_tpu_torch/native/src/tiny_codegen_c.cpp``, marshals the
reference's exact argument list into a small binary file and exec's this
module, which unmarshals and generates. Generation is float64 numpy on the
host: this entry initialises no CUDA context.

Binary args-file layout (little-endian, written by the shim):

  char[8]  magic  "TINYCGC1"
  int32    nx, nu, N, max_iters, check_termination, gen_wrapper,
           has_x_bounds, has_u_bounds
  float64  rho, abs_pri_tol, abs_dua_tol
  float64  A[nx*nx]        column-major (Eigen Map order, codegen.cpp:245-252)
  float64  B[nx*nu]        column-major
  float64  Q[nx], R[nu]    cost diagonals
  float64  x_min[nx*N], x_max[nx*N]          (iff has_x_bounds; col-major)
  float64  u_min[nu*(N-1)], u_max[nu*(N-1)]  (iff has_u_bounds; col-major)

Usage: ``python -m accelerated_tinympc_tpu_torch.api.codegen_cli <argfile> <outdir>``
"""

from __future__ import annotations

import struct
import sys

import numpy as np

MAGIC = b"TINYCGC1"


def _read_args(path: str) -> dict:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != MAGIC:
        raise ValueError(f"{path}: bad magic {raw[:8]!r} (want {MAGIC!r})")
    off = 8
    ints = struct.unpack_from("<8i", raw, off)
    off += 8 * 4
    nx, nu, N, max_iters, check_term, gen_wrapper, has_xb, has_ub = ints
    if not (0 < nx <= 4096 and 0 < nu <= 4096 and 1 < N <= 65536):
        raise ValueError(f"{path}: implausible dims nx={nx} nu={nu} N={N}")
    rho, pri_tol, dua_tol = struct.unpack_from("<3d", raw, off)
    off += 3 * 8

    def mat(rows, cols):
        nonlocal off
        n = rows * cols
        a = np.frombuffer(raw, np.dtype("<f8"), count=n, offset=off)
        off += n * 8
        # Column-major on the wire -> (cols, rows) C-order view transposed.
        return a.reshape(cols, rows).T.copy()

    out = {
        "nx": nx, "nu": nu, "N": N, "rho": rho,
        "abs_pri_tol": pri_tol, "abs_dua_tol": dua_tol,
        "max_iters": max_iters, "check_termination": check_term,
        "gen_wrapper": bool(gen_wrapper),
        "A": mat(nx, nx), "B": mat(nx, nu),
        "Q": mat(nx, 1).reshape(-1), "R": mat(nu, 1).reshape(-1),
        "x_min": None, "x_max": None, "u_min": None, "u_max": None,
    }
    if has_xb:
        # Reference convention: (nx, N) col-major -> time-major (N, nx).
        out["x_min"] = mat(nx, N).T
        out["x_max"] = mat(nx, N).T
    if has_ub:
        out["u_min"] = mat(nu, N - 1).T
        out["u_max"] = mat(nu, N - 1).T
    if off != len(raw):
        raise ValueError(
            f"{path}: trailing/missing bytes (read {off}, file {len(raw)})"
        )
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: codegen_cli <argfile> <output_dir>", file=sys.stderr)
        return 2
    a = _read_args(argv[0])

    from ..types import Settings
    from .codegen import tiny_codegen

    settings = Settings(
        abs_pri_tol=a["abs_pri_tol"], abs_dua_tol=a["abs_dua_tol"],
        max_iter=a["max_iters"], check_termination=a["check_termination"],
        en_state_bound=a["x_min"] is not None,
        en_input_bound=a["u_min"] is not None,
    )
    tiny_codegen(
        a["A"], a["B"], a["Q"], a["R"], a["rho"], a["N"], argv[1],
        x_min=a["x_min"], x_max=a["x_max"],
        u_min=a["u_min"], u_max=a["u_max"],
        settings=settings, gen_wrapper=a["gen_wrapper"],
        augment_Q=True, scalar_type="float",
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
