"""ctypes bindings for the native host solver (native/src/tinympc_native.cpp),
and the build of this package's C code-generation shim.

Counterpart of the JAX package's ``native/__init__.py``: the same
:class:`NativeSolver` methods over the same C functions. The native library
is a runtime-dimensioned, double-precision ADMM solver with its own Riccati
precompute, used for host-side deployment and as an independent float64
cross-check of the port's tiers. It is built at first use with the flags of
``native/Makefile`` (g++, no dependencies) into ``build/native/`` beside the
package, under a name that carries a hash of the source and the flags; the
repo's ``native/`` directory is only read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Any

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
NATIVE_SOURCE = _ROOT / "native" / "src" / "tinympc_native.cpp"
CODEGEN_SHIM = pathlib.Path(__file__).parent / "src" / "tiny_codegen_c.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-fopenmp", "-shared")

_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def build_dir() -> pathlib.Path:
    return _ROOT / "build" / "native"


def _build(source: pathlib.Path, name: str) -> pathlib.Path:
    """``source`` compiled by g++ into ``build/native/lib<name>_<hash>.so``
    (reused while the source and flags are unchanged)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    out = build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        subprocess.run(["g++", *CXX_FLAGS, str(source), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def build_native_library() -> pathlib.Path:
    """The native solver's shared library, built first if needed."""
    return _build(NATIVE_SOURCE, "tinympc_native")


def build_codegen_library() -> pathlib.Path:
    """This package's C shim (``tiny_codegen``, which runs
    ``python -m accelerated_tinympc_tpu_torch.api.codegen_cli``) as a shared
    library, built first if needed."""
    return _build(CODEGEN_SHIM, "tinympc_codegen")


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native_library()))
    lib.tn_create.restype = ctypes.c_void_p
    lib.tn_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _f64, _f64, _f64, _f64, ctypes.c_double,
    ]
    lib.tn_destroy.argtypes = [ctypes.c_void_p]
    lib.tn_set_settings.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.tn_set_bounds.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_double)
    ] * 4
    lib.tn_set_xref.argtypes = [ctypes.c_void_p, _f64]
    lib.tn_set_x0.argtypes = [ctypes.c_void_p, _f64]
    lib.tn_reset_duals.argtypes = [ctypes.c_void_p]
    lib.tn_solve.argtypes = [ctypes.c_void_p]
    lib.tn_solve.restype = ctypes.c_int
    lib.tn_iter.argtypes = [ctypes.c_void_p]
    lib.tn_iter.restype = ctypes.c_int
    lib.tn_status.argtypes = [ctypes.c_void_p]
    lib.tn_status.restype = ctypes.c_int
    lib.tn_get_u.argtypes = [ctypes.c_void_p, _f64]
    lib.tn_get_x.argtypes = [ctypes.c_void_p, _f64]
    lib.tn_get_cache.argtypes = [ctypes.c_void_p, _f64, _f64, _f64, _f64]
    lib.tn_solve_batch.argtypes = [
        ctypes.c_void_p, _f64, ctypes.c_int, _f64, _i32, _i32,
    ]
    lib.tn_solve_adaptive_rho.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
    ]
    lib.tn_solve_adaptive_rho.restype = ctypes.c_int
    lib.tn_solve_batch_adaptive.argtypes = [
        ctypes.c_void_p, _f64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        _f64, _f64, _i32, _i32,
    ]
    lib.tn_add_cone.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _i32,
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
    ]
    lib.tn_clear_cones.argtypes = [ctypes.c_void_p]
    return lib


_lib: ctypes.CDLL | None = None


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


class NativeSolver:
    """Instance-handle wrapper (no global singleton — any number coexist)."""

    def __init__(
        self,
        A: np.ndarray,
        B: np.ndarray,
        Q: np.ndarray,
        R: np.ndarray,
        rho: float,
        horizon: int,
        *,
        max_iter: int = 100,
        check_termination: int = 1,
        abs_pri_tol: float = 1e-3,
        abs_dua_tol: float = 1e-3,
    ) -> None:
        self._lib = get_lib()
        A = np.ascontiguousarray(A, np.float64)
        B = np.ascontiguousarray(B, np.float64)
        self.nx, self.nu = B.shape
        self.N = horizon
        self._h = self._lib.tn_create(
            self.nx, self.nu, horizon, A, B,
            np.ascontiguousarray(Q, np.float64),
            np.ascontiguousarray(R, np.float64),
            float(rho),
        )
        if not self._h:
            raise RuntimeError("native Riccati precompute failed")
        self._lib.tn_set_settings(
            self._h, max_iter, check_termination, abs_pri_tol, abs_dua_tol
        )

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tn_destroy(self._h)
            self._h = None

    def set_bounds(self, u_min=None, u_max=None, x_min=None, x_max=None):
        keep = []  # keeps the arrays alive for the duration of the call

        def ptr(v, size):
            if v is None:
                return None
            arr = np.ascontiguousarray(
                np.broadcast_to(np.asarray(v, np.float64), size).reshape(-1)
            )
            keep.append(arr)
            return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

        su = (self.N - 1, self.nu)
        sx = (self.N, self.nx)
        self._lib.tn_set_bounds(
            self._h, ptr(u_min, su), ptr(u_max, su), ptr(x_min, sx),
            ptr(x_max, sx),
        )

    def set_cones(self, cones) -> None:
        """Install a :class:`..solver.cones.ConeSet` (replaces any previous
        set): exact per-knot SOC projection after the box clip, parity with
        the engine tiers' cone support."""
        self._lib.tn_clear_cones(self._h)
        for is_state, group in (
            (0, cones.input_cones), (1, cones.state_cones),
        ):
            for c in group:
                ball = np.ascontiguousarray(c.ball, np.int32)
                self._lib.tn_add_cone(
                    self._h, is_state, len(c.ball), ball,
                    int(c.axis), float(c.mu), float(c.shift),
                )

    def set_xref(self, Xref: np.ndarray) -> None:
        self._lib.tn_set_xref(
            self._h,
            np.ascontiguousarray(
                np.broadcast_to(np.asarray(Xref, np.float64),
                                (self.N, self.nx)).reshape(-1)
            ),
        )

    def set_x0(self, x0: np.ndarray) -> None:
        x0 = np.ascontiguousarray(x0, np.float64)
        if x0.shape != (self.nx,):
            raise ValueError(f"x0 shape {x0.shape} != ({self.nx},)")
        self._lib.tn_set_x0(self._h, x0)

    def reset_duals(self) -> None:
        self._lib.tn_reset_duals(self._h)

    def solve_adaptive_rho(
        self,
        chunk: int = 25,
        max_total_iter: int = 2000,
        adapt_factor: float = 5.0,
        stall_factor: float = 1.5,
        rho_min: float = 1e-2,
        rho_max: float = 1e3,
    ) -> dict[str, Any]:
        """Stall-guarded OSQP-style rho adaptation (the native counterpart
        of solver/adaptive_rho.py): chunked iterations, rho rescaled by
        sqrt(pri/dua) on stalls, duals rescaled, double-precision Riccati
        refresh. The adapted rho persists for subsequent solves."""
        rho = ctypes.c_double(0.0)
        iters = ctypes.c_int(0)
        flag = self._lib.tn_solve_adaptive_rho(
            self._h, chunk, max_total_iter, adapt_factor, stall_factor,
            rho_min, rho_max, ctypes.byref(rho), ctypes.byref(iters),
        )
        return {
            "exitflag": flag,
            "solved": flag == 0,
            "rho": rho.value,
            "iterations": iters.value,
        }

    def solve_batch_adaptive(
        self, x0s: np.ndarray, chunk: int = 25,
        max_total_iter: int = 2000, adapt_factor: float = 5.0,
        stall_factor: float = 1.5, rho_min: float = 1e-2,
        rho_max: float = 1e3,
    ):
        """Batched per-instance rho adaptation (OpenMP; the host mirror of
        solver/batched_ops.solve_adaptive_rho_batched). Returns
        (u (B, N-1, nu), rho (B,), iters (B,), solved (B,))."""
        x0s = np.ascontiguousarray(x0s, np.float64)
        Bn = x0s.shape[0]
        u = np.zeros((Bn, (self.N - 1) * self.nu), np.float64)
        rho = np.zeros(Bn, np.float64)
        iters = np.zeros(Bn, np.int32)
        status = np.zeros(Bn, np.int32)
        self._lib.tn_solve_batch_adaptive(
            self._h, x0s, Bn, chunk, max_total_iter, adapt_factor,
            stall_factor, rho_min, rho_max, u, rho, iters, status,
        )
        return (u.reshape(Bn, self.N - 1, self.nu), rho, iters,
                status == 1)

    def solve(self) -> dict[str, Any]:
        flag = self._lib.tn_solve(self._h)
        return {
            "exitflag": flag,
            "iterations": self._lib.tn_iter(self._h),
            "solved": self._lib.tn_status(self._h) == 1,
        }

    def get_u(self) -> np.ndarray:
        out = np.zeros((self.N - 1) * self.nu, np.float64)
        self._lib.tn_get_u(self._h, out)
        return out.reshape(self.N - 1, self.nu)

    def get_x(self) -> np.ndarray:
        out = np.zeros(self.N * self.nx, np.float64)
        self._lib.tn_get_x(self._h, out)
        return out.reshape(self.N, self.nx)

    def get_cache(self) -> dict[str, np.ndarray]:
        nx, nu = self.nx, self.nu
        Kinf = np.zeros(nu * nx)
        Pinf = np.zeros(nx * nx)
        Quu = np.zeros(nu * nu)
        AmBKt = np.zeros(nx * nx)
        self._lib.tn_get_cache(self._h, Kinf, Pinf, Quu, AmBKt)
        return {
            "Kinf": Kinf.reshape(nu, nx), "Pinf": Pinf.reshape(nx, nx),
            "Quu_inv": Quu.reshape(nu, nu), "AmBKt": AmBKt.reshape(nx, nx),
        }

    def solve_batch(self, x0s: np.ndarray):
        x0s = np.ascontiguousarray(x0s, np.float64)
        if x0s.ndim != 2 or x0s.shape[1] != self.nx:
            raise ValueError(f"x0s shape {x0s.shape} != (B, {self.nx})")
        Bn = x0s.shape[0]
        u = np.zeros((Bn, (self.N - 1) * self.nu), np.float64)
        iters = np.zeros(Bn, np.int32)
        status = np.zeros(Bn, np.int32)
        self._lib.tn_solve_batch(self._h, x0s, Bn, u, iters, status)
        return u.reshape(Bn, self.N - 1, self.nu), iters, status
