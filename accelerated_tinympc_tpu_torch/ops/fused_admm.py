"""Fused ADMM solve: the entire batched solve in one CUDA kernel launch.

Counterpart of the JAX package's ``ops/fused_admm.py``. The condensed
formulation (:mod:`..solver.condensed`) turns each ADMM iteration into a
handful of small products plus elementwise chains; as separate tensor ops
every ``(B, .)`` intermediate goes through device memory once per
iteration. Here the whole solve loop runs inside one kernel
(``csrc/fused_admm.cu``): per tile of instances every iterate and every
operator stays in one block's shared memory for all iterations, so device
memory is read once and written once per *solve*.

Semantics: stage for stage the reference iteration (reference:
src/tinympc/admm.cpp:111-152) in a fixed-iteration mode and an adaptive mode
with per-instance early exit (residuals per admm.cpp:91-109; the exit skips
the slack save and the backward pass, admm.cpp:135-144).

**Folded iteration.** With ``Q = xref_q - rho (Vnew - Gn)``,
``R = -rho (Znew - Yn)`` and the terminal costate refresh, the condensed
backward output is ``Dn = (Vnew-Gn) @ W_q + (Znew-Yn) @ W_r + const_d`` where
``W_q = -rho [Eq^T; Ep^T]``, ``W_r = -rho Er^T`` are baked on the host in
float64 and ``const_d = xref_q @ W_eq + pterm_c @ W_ep`` depends on the
reference but not on the iteration, so it is hoisted out of the loop.

**Layout.** Unpadded and one instance per row: ``D, Y, Z, U (B, Du)``,
``G, V, X (B, Dx)`` with ``Du = (N-1) nu``, ``Dx = N nx``; ``stats (B, 6)``
= iterations, solved, pri_state, dua_state, pri_input, dua_input. The
kernel sees the two spaces concatenated, ``z = [x | u]``.

Beside the kernel sits :func:`fused_solve_plain`, batched tensor code that
repeats the kernel's arithmetic stage by stage. :func:`fused_solve` takes it
only for tensors that lie on the CPU; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..precompute import CondensedOperators
from ..types import DEFAULT_DEVICE, Cache, Problem, _Struct

torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 products

# Launches per kernel, counted where (and only where) a wrapper launches it.
LAUNCH_COUNTS = {
    "fused_solve_fixed": 0,
    "fused_solve_adaptive": 0,
    "fused_rollout": 0,
}

# Kernel geometry. Instances per block are a multiple of the register tile;
# the shared-memory budget is the 227 KB a Hopper block may take. Threads
# per block follow the tile (16 per instance, at most 256): the best pairs
# of tools/torch_kernel_sweep.py's table on an H100.
REGISTER_TILE = 8
MAX_TILE = 64
MAX_THREADS = 256
THREADS_PER_INSTANCE = 16
SMEM_LIMIT_BYTES = 232_448


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


@dataclasses.dataclass(frozen=True)
class PaddedProblem(_Struct):
    """Condensed operators + problem vectors, kernel-ready. (The name is the
    JAX counterpart's; nothing here is padded.)

    All ``W_*`` are stored transposed, ``(in, out)``, so every contraction is
    ``Y = X @ W``. ``W_eq_u``/``W_ep_u`` are used only outside the kernel to
    fold the reference vectors into ``const_d``. ``W_x``, ``W_f``, ``W_b``,
    ``lo``, ``hi`` are the kernel's operands: the same data concatenated over
    ``z = [x | u]``.
    """

    W_fx: torch.Tensor    # (nx, Dx)  x0 -> X
    W_fd: torch.Tensor    # (Du, Dx)  D  -> X
    W_gx: torch.Tensor    # (nx, Du)  x0 -> U
    W_gd: torch.Tensor    # (Du, Du)  D  -> U
    W_q: torch.Tensor     # (Dx, Du)  (Vnew-Gn) -> D   [-rho folded]
    W_r: torch.Tensor     # (Du, Du)  (Znew-Yn) -> D   [-rho folded]
    W_eq_u: torch.Tensor  # (Dx, Du)  Eq^T (zero terminal rows)
    W_ep_u: torch.Tensor  # (Dx, Du)  Ep^T at the terminal rows
    xref_q: torch.Tensor  # (1, Dx) = -(Xref * Qdiag)
    pterm_c: torch.Tensor  # (1, Dx) = -Xref[-1] @ Pinf in the terminal knot
    u_min: torch.Tensor   # (1, Du)
    u_max: torch.Tensor
    x_min: torch.Tensor   # (1, Dx)
    x_max: torch.Tensor
    rho: torch.Tensor     # scalar
    W_x: torch.Tensor     # (nx, Dz) = [W_fx | W_gx]
    W_f: torch.Tensor     # (Du, Dz) = [W_fd | W_gd]
    W_b: torch.Tensor     # (Dz, Du) = [W_q ; W_r]
    lo: torch.Tensor      # (Dz,)    = [x_min | u_min]
    hi: torch.Tensor      # (Dz,)
    dims: tuple = ()      # (nx, nu, horizon)
    rho_f: float = 1.0    # rho as a host float (a kernel argument)

    @property
    def Dx(self) -> int:
        nx, _nu, N = self.dims
        return N * nx

    @property
    def Du(self) -> int:
        _nx, nu, N = self.dims
        return (N - 1) * nu


def _np64(a) -> np.ndarray:
    return np.asarray(a.detach().cpu().numpy(), np.float64)


def pad_problem(
    problem: Problem, cache: Cache, ops: CondensedOperators,
    dtype: Any = torch.float32, device: Any = DEFAULT_DEVICE,
) -> PaddedProblem:
    """Build the kernel operands (host-side, float64 until the final cast)."""
    nx, nu, N = problem.nx, problem.nu, problem.horizon
    Dx = N * nx
    t0 = Dx - nx  # first terminal-knot column

    o = {k: _np64(getattr(ops, k)) for k in ops._fields}
    rho_f = float(_np64(cache.rho))
    Xref = _np64(problem.Xref)

    # Backward operator with the terminal-costate rows folded in (reference:
    # admm.cpp:15-22 backward sweep + admm.cpp:83-84 terminal costate
    # refresh -- both rho-scaled linear-cost contractions).
    W_q = -rho_f * np.vstack([o["Eq"].T, o["Ep"].T])   # (Dx, Du)
    W_r = -rho_f * o["Er"].T
    W_eq_u = np.vstack([o["Eq"].T, np.zeros((nx, o["Eq"].shape[0]))])
    W_ep_u = np.zeros_like(W_eq_u)
    W_ep_u[t0:] = o["Ep"].T
    pterm = np.zeros(Dx)
    pterm[t0:] = -Xref[-1] @ _np64(cache.Pinf)
    W_fx, W_fd = o["Fx0"].T, o["Fd"].T
    W_gx, W_gd = o["Gx0"].T, o["Gd"].T
    flat = lambda a: _np64(a).reshape(1, -1)
    u_min, u_max = flat(problem.u_min), flat(problem.u_max)
    x_min, x_max = flat(problem.x_min), flat(problem.x_max)

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)
    return PaddedProblem(
        W_fx=t(W_fx), W_fd=t(W_fd), W_gx=t(W_gx), W_gd=t(W_gd),
        W_q=t(W_q), W_r=t(W_r), W_eq_u=t(W_eq_u), W_ep_u=t(W_ep_u),
        xref_q=t(-(Xref * _np64(problem.Q)).reshape(1, -1)),
        pterm_c=t(pterm.reshape(1, -1)),
        u_min=t(u_min), u_max=t(u_max), x_min=t(x_min), x_max=t(x_max),
        rho=t(rho_f),
        W_x=t(np.hstack([W_fx, W_gx])),
        W_f=t(np.hstack([W_fd, W_gd])),
        W_b=t(np.vstack([W_q, W_r])),
        lo=t(np.hstack([x_min, u_min]).reshape(-1)),
        hi=t(np.hstack([x_max, u_max]).reshape(-1)),
        dims=(nx, nu, N),
        rho_f=rho_f,
    )


def ref_vectors(
    pp: PaddedProblem, Q: torch.Tensor, Pinf: torch.Tensor,
    Xref: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference-dependent operands for a new horizon window (tracking
    mode, reference: quadrotor_tracking.cpp:101 sliding the window each
    tick): the baked ``xref_q``/``pterm_c`` of :func:`pad_problem` are just
    these two vectors, so updating the reference costs two tiny tensor ops
    (``const_d`` is folded from them inside :func:`fused_solve`).

    ``Q`` is the (nx,) workspace cost diagonal, ``Pinf`` the (nx, nx) cache
    matrix, ``Xref`` the (N, nx) window. Returns ``(xref_q, pterm_c)`` shaped
    ``(1, Dx)``.
    """
    nx, _nu, N = pp.dims
    dtype, device = pp.xref_q.dtype, pp.xref_q.device
    Xref = torch.as_tensor(Xref, dtype=dtype, device=device)
    xref_q = -(Xref * Q).reshape(1, -1)
    pterm_c = torch.zeros((1, N * nx), dtype=dtype, device=device)
    pterm_c[0, (N - 1) * nx:] = -torch.matmul(Xref[-1], Pinf)
    return xref_q, pterm_c


def fold_const_d(pp: PaddedProblem, xref_q=None, pterm_c=None) -> torch.Tensor:
    """``const_d = xref_q @ W_eq + pterm_c @ W_ep`` -- the iteration-invariant
    part of the folded linear-cost/backward stage. Shape ``(rows, Du)``."""
    xq = pp.xref_q if xref_q is None else xref_q
    pc = pp.pterm_c if pterm_c is None else pterm_c
    return torch.matmul(xq, pp.W_eq_u) + torch.matmul(pc, pp.W_ep_u)


class FusedCarry(NamedTuple):
    """Warm-start carries persisting across MPC ticks, ``(B, .)`` unpadded.
    The reference keeps these in its global workspace between tiny_solve
    calls (examples/quadrotor_hovering.cpp:99-104 resets only the duals)."""

    D: torch.Tensor  # (B, Du)
    Y: torch.Tensor  # (B, Du)
    G: torch.Tensor  # (B, Dx)
    Z: torch.Tensor  # (B, Du)
    V: torch.Tensor  # (B, Dx)

    @staticmethod
    def zeros(batch: int, pp: PaddedProblem, dtype=torch.float32,
              device: Any = DEFAULT_DEVICE) -> "FusedCarry":
        fu = lambda: torch.zeros((batch, pp.Du), dtype=dtype, device=device)
        fx = lambda: torch.zeros((batch, pp.Dx), dtype=dtype, device=device)
        return FusedCarry(D=fu(), Y=fu(), G=fx(), Z=fu(), V=fx())

    def reset_duals(self) -> "FusedCarry":
        """Zero y/g between ticks (reference: tiny_wrapper.cpp:131-140)."""
        return self._replace(
            Y=torch.zeros_like(self.Y), G=torch.zeros_like(self.G))


class FusedResult(NamedTuple):
    """Solve outputs. ``U``/``X`` are the final pre-projection iterates (the
    reference applies pre-projection u --
    examples/quadrotor_hovering.cpp:104-110). ``stats[:, 0]`` iterations,
    ``stats[:, 1]`` solved flag, ``stats[:, 2:6]`` residuals [pri_state,
    dua_state, pri_input, dua_input]."""

    U: torch.Tensor
    X: torch.Tensor
    carry: FusedCarry
    stats: torch.Tensor  # (B, 6)


# ------------------------------------------------------------ plain version --

def _iteration(D, Y, G, Z, V, pp: PaddedProblem, Xb, Ub, const_d, alpha):
    """One folded condensed ADMM iteration on ``(B, .)`` tensors -- the
    arithmetic of the kernel's forward/clip/dual/backward stages. Stage order
    is the reference's (src/tinympc/admm.cpp:117-150)."""
    X = Xb + torch.matmul(D, pp.W_fd)
    U = Ub + torch.matmul(D, pp.W_gd)
    if alpha != 1.0:
        Ur = alpha * U + (1.0 - alpha) * Z
        Xr = alpha * X + (1.0 - alpha) * V
    else:
        Ur, Xr = U, X
    S = Ur + Y
    Znew = torch.minimum(torch.maximum(S, pp.u_min), pp.u_max)
    Yn = S - Znew
    T = Xr + G
    Vnew = torch.minimum(torch.maximum(T, pp.x_min), pp.x_max)
    Gn = T - Vnew
    Dn = (torch.matmul(Vnew - Gn, pp.W_q)
          + torch.matmul(Znew - Yn, pp.W_r) + const_d)
    return Dn, Yn, Gn, Znew, Vnew, U, X


def _residuals(X, U, Z, V, Znew, Vnew, rho):
    """[pri_state, dua_state, pri_input, dua_input] per instance (reference
    admm.cpp:95-98: pre-projection iterates vs new slacks; old-vs-new slacks
    scaled by rho)."""
    amax = lambda a: a.abs().amax(dim=-1)
    return (amax(X - Vnew), amax(V - Vnew) * rho,
            amax(U - Znew), amax(Z - Znew) * rho)


def fused_solve_plain(
    x0: torch.Tensor, carry: FusedCarry, pp: PaddedProblem, *,
    max_iter: int = 100, check_termination: int = 0,
    abs_pri_tol: float = 1e-3, abs_dua_tol: float = 1e-3,
    warmup_iters: int = 0, xref_q=None, pterm_c=None, alpha: float = 1.0,
    const_d: torch.Tensor | None = None,
) -> FusedResult:
    """Plain PyTorch version of the fused solve (fixed and adaptive): the
    kernel's arithmetic, stage by stage, on whole-batch tensors. Runs on any
    device and in float32 or float64. ``const_d`` (``(1, Du)``) gives the
    folded reference constant directly, as the rollout streams it."""
    with torch.no_grad():
        if const_d is None:
            const_d = fold_const_d(pp, xref_q, pterm_c)
        Xb = torch.matmul(x0, pp.W_fx)
        Ub = torch.matmul(x0, pp.W_gx)
        D, Y, G, Z, V = carry
        B = x0.shape[0]
        step = lambda D, Y, G, Z, V: _iteration(
            D, Y, G, Z, V, pp, Xb, Ub, const_d, alpha)
        stats = torch.zeros((B, 6), dtype=x0.dtype, device=x0.device)

        if check_termination <= 0:
            for _ in range(max_iter - 1):
                D, Y, G, Z, V, _U, _X = step(D, Y, G, Z, V)
            Dn, Yn, Gn, Znew, Vnew, U, X = step(D, Y, G, Z, V)
            # Residuals of the final iteration against the pre-save slacks.
            stats[:, 0] = max_iter
            for k, r in enumerate(
                    _residuals(X, U, Z, V, Znew, Vnew, pp.rho)):
                stats[:, 2 + k] = r
            return FusedResult(
                U=U, X=X, carry=FusedCarry(Dn, Yn, Gn, Znew, Vnew),
                stats=stats)

        # Adaptive: a converged instance stops. What it returns is D, Z, V
        # from before its freezing check iteration (backward pass and slack
        # save skipped), Y, G after it, U, X of it.
        warmup = min(warmup_iters, max_iter - 1)
        done = torch.zeros((B,), dtype=torch.bool, device=x0.device)
        U = torch.zeros_like(D)
        X = torch.zeros_like(G)
        col = lambda m: m[:, None]
        for it in range(1, max_iter + 1):
            Dn, Yn, Gn, Znew, Vnew, Un, Xn = step(D, Y, G, Z, V)
            live = ~done
            newly = torch.zeros_like(done)
            if it > warmup and it % check_termination == 0:
                ps, ds, pu, du = _residuals(Xn, Un, Z, V, Znew, Vnew, pp.rho)
                for k, r in enumerate((ps, ds, pu, du)):
                    stats[:, 2 + k] = torch.where(live, r, stats[:, 2 + k])
                newly = live & (ps < abs_pri_tol) & (pu < abs_pri_tol) \
                    & (ds < abs_dua_tol) & (du < abs_dua_tol)
                stats[:, 0] = torch.where(
                    newly, torch.full_like(stats[:, 0], it), stats[:, 0])
            cont = live & ~newly
            U = torch.where(col(live), Un, U)
            X = torch.where(col(live), Xn, X)
            Y = torch.where(col(live), Yn, Y)
            G = torch.where(col(live), Gn, G)
            D = torch.where(col(cont), Dn, D)
            Z = torch.where(col(cont), Znew, Z)
            V = torch.where(col(cont), Vnew, V)
            done = done | newly
            if bool(done.all()):
                break
        stats[:, 1] = done.to(stats.dtype)
        stats[:, 0] = torch.where(
            done, stats[:, 0], torch.full_like(stats[:, 0], max_iter))
        return FusedResult(
            U=U, X=X, carry=FusedCarry(D, Y, G, Z, V), stats=stats)


# ------------------------------------------------------------------ kernel --

def kernel_smem_bytes(nx: int, nu: int, horizon: int, tile: int) -> int:
    """Dynamic shared memory one block needs: mirrors ``make_layout`` in
    ``csrc/admm_iteration.cuh`` (the C entry refuses a launch when the two
    disagree)."""
    r4 = lambda n: (n + 3) & ~3
    Dx, Du = horizon * nx, (horizon - 1) * nu
    Dz = Dx + Du
    DuP, DzP = r4(Du), r4(Dz)
    words = (
        DuP * DzP + DzP * DuP + 2 * DzP + DuP
        + r4(nx * nx) + r4(nx * nu)
        + r4(tile * DuP) + 3 * r4(tile * DzP) + r4(2 * tile * DzP)
        + r4(2 * tile * nx) + r4(tile * nu) + r4(tile * 6)
        + r4(tile * 4) + 3 * r4(tile)
    )
    return 4 * words


def choose_tile(dims: tuple, batch: int, n_sm: int = 132,
                limit: int = SMEM_LIMIT_BYTES) -> int:
    """Instances per block: the largest multiple of the register tile that
    fits shared memory, not more than spreads the batch over all SMs. Raises
    if even one register tile does not fit beside the operators."""
    nx, nu, N = dims
    if kernel_smem_bytes(nx, nu, N, REGISTER_TILE) > limit:
        raise ValueError(
            f"the condensed operators for nx={nx}, nu={nu}, horizon={N} need "
            f"{kernel_smem_bytes(nx, nu, N, REGISTER_TILE)} bytes of shared "
            f"memory per block (limit {limit}): the fused tier holds them "
            "on the SM; long horizons belong to the stream tier")
    fit = REGISTER_TILE
    while (fit + REGISTER_TILE <= MAX_TILE and
           kernel_smem_bytes(nx, nu, N, fit + REGISTER_TILE) <= limit):
        fit += REGISTER_TILE
    per_sm = -(-batch // n_sm)
    want = -(-per_sm // REGISTER_TILE) * REGISTER_TILE
    return max(REGISTER_TILE, min(fit, want))


_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def _library() -> ctypes.CDLL:
    """Load (building at first use) the kernels and declare their C
    signatures; every pointer and the stream are ``c_void_p``."""
    from ._build import load_library

    lib = load_library("fused_admm")
    if not getattr(lib, "_atm_declared", False):
        lib.atm_fused_smem_bytes.argtypes = [_I] * 4
        lib.atm_fused_smem_bytes.restype = _I
        lib.atm_fused_solve.argtypes = (
            [_P] * 20 + [_I] * 7 + [_F] * 4 + [_I] * 3 + [_P])
        lib.atm_fused_solve.restype = _I
        lib.atm_fused_rollout.argtypes = (
            [_P] * 23 + [_I] * 9 + [_F] * 4 + [_I] * 3 + [_P])
        lib.atm_fused_rollout.restype = _I
        lib._atm_declared = True
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(
            f"{name} is {t.dtype}: the CUDA kernels are float32 "
            "(use the plain tiers for float64)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    return t.contiguous()


def _kernel_operands(pp: PaddedProblem, device) -> tuple:
    nx, nu, N = pp.dims
    Dx, Du = pp.Dx, pp.Du
    Dz = Dx + Du
    return (
        _check("pp.W_f", pp.W_f, (Du, Dz), device),
        _check("pp.W_b", pp.W_b, (Dz, Du), device),
        _check("pp.W_x", pp.W_x, (nx, Dz), device),
        _check("pp.lo", pp.lo, (Dz,), device),
        _check("pp.hi", pp.hi, (Dz,), device),
    )


def _geometry(pp: PaddedProblem, B: int, device, batch_tile, threads):
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT_BYTES)
    nx, nu, N = pp.dims
    if batch_tile is None:
        tile = choose_tile(pp.dims, B, props.multi_processor_count, limit)
    else:
        tile = max(REGISTER_TILE,
                   -(-int(batch_tile) // REGISTER_TILE) * REGISTER_TILE)
        tile = min(tile, choose_tile(pp.dims, 10 ** 9, 1, limit))
    if threads is None:
        threads = min(MAX_THREADS, THREADS_PER_INSTANCE * tile)
    threads = max(int(threads), -(-tile // 32) * 32)
    return tile, threads, kernel_smem_bytes(nx, nu, N, tile)


def _raise_on(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(
            f"{what}: launch geometry refused (shared-memory layout of the "
            "wrapper and the kernel disagree, or tile/threads out of range)")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _unsupported(algo, polish, cone_ops, cone_params) -> None:
    if algo == "bf16x3":
        raise NotImplementedError(
            "algo='bf16x3' is the TPU's split-operand MXU mode; its Hopper "
            "counterpart (a split-operand tensor-core mode) comes with the "
            "'Hopper arithmetic modes for K1-K3' item of ROADMAP.md")
    if algo != "f32":
        raise ValueError(f"unknown algo {algo!r}; use 'f32'")
    if cone_ops is not None or any(p is not None for p in cone_params):
        raise NotImplementedError(
            "second-order cones in the fused tier come with ROADMAP.md "
            "slice 6 (kernel K4)")


def fused_solve(
    x0: torch.Tensor,
    carry: FusedCarry,
    pp: PaddedProblem,
    *,
    max_iter: int = 100,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    batch_tile: int | None = None,
    warmup_iters: int = 0,
    xref_q: torch.Tensor | None = None,
    pterm_c: torch.Tensor | None = None,
    algo: str = "f32",
    polish: int = 8,
    cone_ops=None,
    cone_mu_u=None,
    cone_shift_u=None,
    cone_mu_x=None,
    cone_shift_x=None,
    alpha: float = 1.0,
    threads: int | None = None,
) -> FusedResult:
    """Run the fused whole-solve over a batch.

    ``x0`` is ``(B, nx)``; carries are :class:`FusedCarry`. Any batch size is
    taken (the kernel masks the ragged edge of the last tile).
    ``check_termination == 0`` selects the fixed-iteration kernel, otherwise
    the adaptive kernel with checks every ``check_termination`` iterations.
    ``xref_q``/``pterm_c`` override the baked reference vectors (tracking
    mode -- build them with :func:`ref_vectors`). ``warmup_iters`` (adaptive
    mode only) runs that many iterations without convergence checks first.
    ``batch_tile`` (instances per block) and ``threads`` override the
    kernel's launch geometry.

    Tensors on the CPU go through :func:`fused_solve_plain`; tensors on a
    CUDA device launch the kernel (float32 only) or raise. ``algo='bf16x3'``,
    ``polish`` and the cone arguments raise ``NotImplementedError`` for now.
    """
    _unsupported(algo, polish, cone_ops,
                 (cone_mu_u, cone_shift_u, cone_mu_x, cone_shift_x))
    if max_iter < 1:
        raise ValueError("the fused tier runs at least one iteration; "
                         "use the scan tier for max_iter=0")
    if not x0.is_cuda:
        return fused_solve_plain(
            x0, carry, pp, max_iter=max_iter,
            check_termination=check_termination,
            abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
            warmup_iters=warmup_iters, xref_q=xref_q, pterm_c=pterm_c,
            alpha=alpha,
        )

    nx, nu, N = pp.dims
    Dx, Du = pp.Dx, pp.Du
    B = x0.shape[0]
    dev = x0.device
    x0 = _check("x0", x0, (B, nx), dev)
    D0 = _check("carry.D", carry.D, (B, Du), dev)
    Y0 = _check("carry.Y", carry.Y, (B, Du), dev)
    G0 = _check("carry.G", carry.G, (B, Dx), dev)
    Z0 = _check("carry.Z", carry.Z, (B, Du), dev)
    V0 = _check("carry.V", carry.V, (B, Dx), dev)
    W_f, W_b, W_x, lo, hi = _kernel_operands(pp, dev)
    with torch.no_grad():
        const_d = _check("const_d", fold_const_d(pp, xref_q, pterm_c),
                         (1, Du), dev)
    tile, threads, smem = _geometry(pp, B, dev, batch_tile, threads)

    new = lambda w: torch.empty((B, w), dtype=torch.float32, device=dev)
    U, X, D, Y, G, Z, V = (new(Du), new(Dx), new(Du), new(Du), new(Dx),
                           new(Du), new(Dx))
    stats = new(6)
    adaptive = check_termination > 0
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.atm_fused_solve(
            x0.data_ptr(), D0.data_ptr(), Y0.data_ptr(), G0.data_ptr(),
            Z0.data_ptr(), V0.data_ptr(),
            W_f.data_ptr(), W_b.data_ptr(), W_x.data_ptr(),
            const_d.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            U.data_ptr(), X.data_ptr(), D.data_ptr(), Y.data_ptr(),
            G.data_ptr(), Z.data_ptr(), V.data_ptr(), stats.data_ptr(),
            B, nx, nu, N, int(max_iter),
            int(check_termination) if adaptive else 0,
            min(int(warmup_iters), int(max_iter) - 1) if adaptive else 0,
            float(pp.rho_f), float(alpha),
            float(abs_pri_tol), float(abs_dua_tol),
            tile, threads, smem, stream,
        )
    _raise_on(err, "fused_solve")
    LAUNCH_COUNTS[
        "fused_solve_adaptive" if adaptive else "fused_solve_fixed"] += 1
    return FusedResult(
        U=U, X=X, carry=FusedCarry(D=D, Y=Y, G=G, Z=Z, V=V), stats=stats)


def unpad_controls(result: FusedResult, pp: PaddedProblem) -> torch.Tensor:
    """First-knot controls ``(B, nu)`` from the flat U."""
    _nx, nu, _N = pp.dims
    return result.U[:, :nu]


def unpad_states(result: FusedResult, pp: PaddedProblem) -> torch.Tensor:
    """Full state trajectories ``(B, N, nx)`` from the flat X."""
    nx, _nu, N = pp.dims
    return result.X[:, : N * nx].reshape(result.X.shape[0], N, nx)
