"""Long-horizon fused solve for one shared plant: the streaming tier.

Counterpart of the JAX package's ``ops/stream_admm.py``. The condensed
kernels (:mod:`.fused_admm`) hold ``O((N nx)^2)`` operators per solve and
stop at horizons of a few dozen knots. This tier covers horizons in the
hundreds to thousands: the two horizon sweeps of every ADMM iteration
(reference: src/tinympc/admm.cpp:27-37 forward rollout, :15-22 backward
gradient recursion) run knot by knot over iterates kept in device memory,
and every elementwise stage (slack projection :45-61, dual ascent :67-71,
linear-cost refresh :77-85) is fused into the sweep that produces its
inputs: ``q``/``r`` are rebuilt on the fly, ``x``/``u``/``p`` are sweep
carries written out only where they are the result.

**Layout.** The port's own, batch-leading and unpadded: the carry
(:class:`StreamCarry`) holds ``d, y, z (B, N-1, nu)`` and ``g, v (B, N,
nx)``; the plant, its cache, ``qc = -(Q o Xref)`` per knot and ``pterm =
-Pinf^T Xref_{N-1}`` are shared. Bounds are one row (time-uniform) or one
row per knot (a schedule). The JAX package's lane tiles, sublane padding,
DMA double buffering and full-width stats rows are TPU layout and are not
carried over; ``knot_block`` (the knots per DMA block there) is accepted and
changes nothing: the CUDA kernel stages no blocks, so results do not depend
on it.

**Modes.** ``check_termination == 0``: ``max_iter`` iterations (kernel K9);
``> 0``: per-instance early exit with the reference's snapshot semantics
(kernel K10, admm.cpp:135-144): an instance converging at check iteration
``kc`` keeps D from before the backward pass, Z and V from before the
slack save, Y and G advanced, U and X of that iteration. ``stats (B, 8)``:
``[iterations, solved, pri_state, dua_state, pri_input, dua_input, 0, 0]``.

:func:`stream_solve` launches ``csrc/stream_admm.cu`` for tensors on a CUDA
device and takes :func:`stream_solve_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, NamedTuple

import torch

from ..types import Cache, Problem, _Struct
from . import hetero_admm as ha

torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 products

# Launches per kernel, counted where (and only where) the wrapper launches it
# (the hstream wrappers in .hstream_admm count under their own names).
LAUNCH_COUNTS = {"stream_solve_fixed": 0, "stream_solve_adaptive": 0,
                 "hstream_solve_fixed": 0, "hstream_solve_adaptive": 0}


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def _rows(b: torch.Tensor, knots: int, k: int) -> tuple[torch.Tensor, bool]:
    """A bound as ``(rows, per_knot)``: one row ``(1, k)`` where every knot
    carries the same values, else the ``(knots, k)`` schedule."""
    b = b.expand(b.shape[:-2] + (knots, k)) if b.dim() >= 2 else \
        b.expand(knots, k)
    if bool((b == b[..., :1, :]).all()):
        return b[..., :1, :].contiguous(), False
    return b.contiguous(), True


@dataclasses.dataclass(frozen=True)
class StreamProblem(_Struct):
    """Shared-plant operands of the streaming tier. Bounds are ``(1, k)``
    rows (time-uniform) or ``(knots, k)`` schedules, all four alike
    (reference workspace bounds are full-horizon matrices, settable per knot
    -- types.hpp); ``rho`` is a 0-d tensor."""

    A: torch.Tensor        # (nx, nx)
    B: torch.Tensor        # (nx, nu)
    Kinf: torch.Tensor     # (nu, nx)
    Quu_inv: torch.Tensor  # (nu, nu)
    AmBKt: torch.Tensor    # (nx, nx)
    u_min: torch.Tensor    # (1 | N-1, nu)
    u_max: torch.Tensor
    x_min: torch.Tensor    # (1 | N, nx)
    x_max: torch.Tensor
    qc: torch.Tensor       # (N, nx)
    pterm: torch.Tensor    # (nx,)
    rho: torch.Tensor      # ()
    dims: tuple = ()       # (nx, nu, N)

    @property
    def has_knot_bounds(self) -> bool:
        return self.x_min.shape[-2] > 1 or self.u_min.shape[-2] > 1


def pad_stream_problem(problem: Problem, cache: Cache,
                       dtype: Any = torch.float32) -> StreamProblem:
    """Streaming-tier operands from a single-instance ``Problem``/``Cache``
    (float64 until the final cast). Bounds that vary over the knots become
    per-knot schedules; otherwise one row each."""
    nx, nu, N = problem.nx, problem.nu, problem.horizon
    f64 = lambda a: torch.as_tensor(a).to(torch.float64)
    out = lambda a: a.to(dtype).contiguous()
    with torch.no_grad():
        qc = -(f64(problem.Xref) * f64(problem.Q))
        pterm = -(f64(problem.Xref)[-1] @ f64(cache.Pinf))
        rows = {name: _rows(f64(getattr(problem, name)), knots, k)
                for name, knots, k in (("u_min", N - 1, nu),
                                       ("u_max", N - 1, nu),
                                       ("x_min", N, nx), ("x_max", N, nx))}
        knot = any(per for _r, per in rows.values())
        bounds = {}
        for name, (r, _per) in rows.items():
            knots = N - 1 if name.startswith("u") else N
            bounds[name] = out(r.expand(knots, r.shape[-1]) if knot else r)
        return StreamProblem(
            A=out(f64(problem.A)), B=out(f64(problem.B)),
            Kinf=out(f64(cache.Kinf)), Quu_inv=out(f64(cache.Quu_inv)),
            AmBKt=out(f64(cache.AmBKt)), qc=out(qc), pterm=out(pterm),
            rho=out(f64(cache.rho).reshape(())), dims=(nx, nu, N), **bounds)


def stream_ref_vectors(sp: StreamProblem, Q: torch.Tensor, Pinf: torch.Tensor,
                       Xref: torch.Tensor) -> StreamProblem:
    """The reference-dependent operands for a new horizon window (tracking
    mode; reference: quadrotor_tracking.cpp:101 slides the window each
    tick): ``Q (nx,)`` raw cost diagonal, ``Pinf (nx, nx)``, ``Xref (N,
    nx)``. Returns ``sp`` with ``qc``/``pterm`` replaced."""
    dt = sp.qc.dtype
    with torch.no_grad():
        qc = -(Xref * Q).to(dt)
        pterm = -(Xref[-1] @ Pinf).to(dt)
    return sp.replace(qc=qc.contiguous(), pterm=pterm.contiguous())


class StreamCarry(NamedTuple):
    """Warm-start iterates (the reference keeps these in its workspace
    between tiny_solve calls; examples/quadrotor_hovering.cpp:99-104 resets
    only the duals): ``d, y, z (B, N-1, nu)``, ``g, v (B, N, nx)``."""

    d: torch.Tensor
    y: torch.Tensor
    g: torch.Tensor
    z: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(batch: int, sp, dtype=None) -> "StreamCarry":
        """Cold start for ``batch`` instances of ``sp`` (a
        :class:`StreamProblem` or an :class:`.hstream_admm.HStreamProblem`),
        on its device and in its dtype unless given."""
        nx, nu, N = sp.dims
        dt = sp.A.dtype if dtype is None else dtype
        dev = sp.A.device
        fu = lambda: torch.zeros((batch, N - 1, nu), dtype=dt, device=dev)
        fx = lambda: torch.zeros((batch, N, nx), dtype=dt, device=dev)
        return StreamCarry(d=fu(), y=fu(), g=fx(), z=fu(), v=fx())

    def reset_duals(self) -> "StreamCarry":
        """Zero y/g between MPC ticks (reference: tiny_wrapper.cpp:131-140)."""
        return self._replace(y=torch.zeros_like(self.y),
                             g=torch.zeros_like(self.g))


class StreamResult(NamedTuple):
    """``U (B, N-1, nu)`` / ``X (B, N, nx)`` are the final pre-projection
    iterates (the reference applies pre-projection u); ``stats (B, 8)``:
    [iterations, solved, pri_state, dua_state, pri_input, dua_input, 0, 0]
    (the solved flag stays 0 in fixed mode)."""

    U: torch.Tensor
    X: torch.Tensor
    carry: StreamCarry
    stats: torch.Tensor


def _check_common(max_iter: int, knot_block: int) -> None:
    if max_iter < 1:
        raise ValueError("the stream solves need max_iter >= 1")
    if knot_block < 1:
        raise ValueError("knot_block must be >= 1")


def _plain(x0, carry, ops, **kw) -> StreamResult:
    res = ha.hetero_solve_plain(x0, ha.HeteroCarry(*carry), ops, **kw)
    return StreamResult(U=res.U, X=res.X, carry=StreamCarry(*res.carry),
                        stats=res.stats)


def stream_solve_plain(
    x0: torch.Tensor, carry: StreamCarry, sp: StreamProblem, *,
    max_iter: int = 100, knot_block: int = 32, check_termination: int = 0,
    abs_pri_tol: float = 1e-3, abs_dua_tol: float = 1e-3,
    en_state_bound: bool = True, en_input_bound: bool = True, cones=None,
) -> StreamResult:
    """Plain PyTorch version of :func:`stream_solve` (which see): the
    kernels' arithmetic on whole-batch tensors, on any device and in float32
    or float64 (the hetero tier's plain iteration with the plant shared)."""
    _check_common(max_iter, knot_block)
    return _plain(x0, carry, sp, max_iter=max_iter,
                  check_termination=check_termination,
                  abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
                  en_input_bound=en_input_bound,
                  en_state_bound=en_state_bound, cones=cones)


# ------------------------------------------------------------------ kernel --

_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("stream_admm")
    if not getattr(lib, "_atm_declared", False):
        lib.atm_stream_solve.argtypes = (
            [_I] + [_P] * 27 + [_I] * 10 + [_F] * 2 + [_P])
        lib.atm_stream_solve.restype = _I
        lib._atm_declared = True
    return lib


def _launch(name: str, shared: bool, x0, carry, ops, *, max_iter: int,
            check_termination: int, abs_pri_tol: float, abs_dua_tol: float,
            en_input_bound: bool, en_state_bound: bool, cones=None,
            cone_params=None, cone_masks=None) -> StreamResult:
    """Launch ``csrc/stream_admm.cu`` on CUDA tensors (float32, ``nx, nu <=
    32``, at most 8 cones): ``shared`` for one plant (:class:`StreamProblem`),
    else per-instance plants (:class:`.hstream_admm.HStreamProblem`).
    Counts the launch under ``name`` + ``_fixed``/``_adaptive``."""
    nx, nu, N = ops.dims
    m = N - 1
    Bn = x0.shape[0]
    dev = x0.device
    if nx > ha.MAX_DIM or nu > ha.MAX_DIM:
        raise ValueError(
            f"the stream kernels take nx, nu <= {ha.MAX_DIM}, got nx={nx}, "
            f"nu={nu}: use the scan tier")
    adaptive = check_termination > 0
    cone_idx, cone_par, _alive = ha._cone_table(cones, nx, nu)
    nc = 0 if cone_idx is None else (
        len(cones.input_cones) + len(cones.state_cones))
    c = lambda what, t, shape: ha._check(what, t, shape, dev)
    P = () if shared else (Bn,)
    ku = ops.u_min.shape[-2]
    kx = ops.x_min.shape[-2]
    bound_rows = (1, 1) if ku == 1 and kx == 1 else (m, N)
    if (ku, kx) != bound_rows:
        raise ValueError(f"bounds of {ku} and {kx} rows: give one row or one "
                         "row per knot for all four")
    ins = [
        c("x0", x0, (Bn, nx)), c("A", ops.A, P + (nx, nx)),
        c("B", ops.B, P + (nx, nu)), c("Kinf", ops.Kinf, P + (nu, nx)),
        c("Quu_inv", ops.Quu_inv, P + (nu, nu)),
        c("AmBKt", ops.AmBKt, P + (nx, nx)),
        c("u_min", ops.u_min, P + (bound_rows[0], nu)),
        c("u_max", ops.u_max, P + (bound_rows[0], nu)),
        c("x_min", ops.x_min, P + (bound_rows[1], nx)),
        c("x_max", ops.x_max, P + (bound_rows[1], nx)),
        c("qc", ops.qc, P + (N, nx)), c("pterm", ops.pterm, P + (nx,)),
        c("rho", ops.rho.reshape(-1), P or (1,)),
    ]
    # The kernel updates the carry in place: it gets copies.
    cy = [c(f"carry.{k}", a, (Bn,) + s).clone() for k, a, s in zip(
        carry._fields, carry, ((m, nu), (m, nu), (N, nx), (m, nu), (N, nx)))]
    if cone_params is not None:
        cone_params = c("cone_params", cone_params, (Bn, nc, 2))
    if cone_masks is not None:
        mr = 2 * nu * len(cones.input_cones) + 2 * nx * len(cones.state_cones)
        cone_masks = c("cone_masks", cone_masks, (Bn, mr))
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    U, X, stats = new(Bn, m, nu), new(Bn, N, nx), new(Bn, 8)
    zs = new(Bn, m, nu) if adaptive else None
    vs = new(Bn, N, nx) if adaptive else None
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.atm_stream_solve(
            int(shared), *(t.data_ptr() for t in ins),
            U.data_ptr(), X.data_ptr(), *(t.data_ptr() for t in cy),
            ptr(zs), ptr(vs), stats.data_ptr(),
            cone_idx, cone_par, ptr(cone_params), ptr(cone_masks),
            int(not shared), int(bound_rows[0] > 1),
            Bn, nx, nu, N, int(max_iter),
            int(check_termination) if adaptive else 0,
            int(bool(en_input_bound)), int(bool(en_state_bound)),
            float(abs_pri_tol), float(abs_dua_tol),
            torch.cuda.current_stream().cuda_stream)
    ha._raise_on(err, name)
    LAUNCH_COUNTS[name + ("_adaptive" if adaptive else "_fixed")] += 1
    return StreamResult(U=U, X=X, carry=StreamCarry(*cy), stats=stats)


def stream_solve(
    x0: torch.Tensor,
    carry: StreamCarry,
    sp: StreamProblem,
    *,
    max_iter: int = 100,
    knot_block: int = 32,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    en_state_bound: bool = True,
    en_input_bound: bool = True,
    cones=None,
) -> StreamResult:
    """Long-horizon batched solve, one shared plant.

    ``x0 (B, nx)``; ``carry`` the warm-start iterates (:class:`StreamCarry`).
    ``check_termination == 0`` runs the fixed-iteration kernel (K9), ``> 0``
    the adaptive kernel (K10) with per-instance convergence freezing every
    that many iterations (per instance the scan tier's freeze, reference
    early exit admm.cpp:135-144; stats column 0 the iterations, column 1
    the solved flag). Tolerances are runtime arguments; ``cones`` (a
    :class:`..solver.cones.ConeSet`) adds SOC projections after the box
    clip. ``knot_block`` is accepted for the JAX signature and changes
    nothing (module docstring). Combine with
    :func:`..solver.cascade.stream_cascade_solve` for compaction between
    launches.

    Tensors on the CPU go through :func:`stream_solve_plain`; tensors on a
    CUDA device launch the kernel (float32) or raise.
    """
    _check_common(max_iter, knot_block)
    kw = dict(max_iter=max_iter, check_termination=check_termination,
              abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
              en_input_bound=en_input_bound, en_state_bound=en_state_bound,
              cones=cones)
    if not x0.is_cuda:
        return _plain(x0, carry, sp, **kw)
    return _launch("stream_solve", True, x0, carry, sp, **kw)
