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
row per knot (a schedule). The JAX package's lane tiles, sublane padding
and full-width stats rows are TPU layout and are not carried over. Its DMA
double buffering has a counterpart: the kernels keep the next knots of
every instance in flight through a ring in shared memory, and
``knot_block`` (the knots per DMA block there) sets the ring's depth, up to
``KB_MAX`` knots and as far as shared memory takes it (:func:`shared_plan`);
results do not depend on it. The kernels read the carry knot-major with the
instance innermost; the wrapper transposes it in and the results out.

**Modes.** ``check_termination == 0``: ``max_iter`` iterations (kernel K9);
``> 0``: per-instance early exit with the reference's snapshot semantics
(kernel K10, admm.cpp:135-144): an instance converging at check iteration
``kc`` keeps D from before the backward pass, Z and V from before the
slack save, Y and G advanced, U and X of that iteration. ``stats (B, 8)``:
``[iterations, solved, pri_state, dua_state, pri_input, dua_input, 0, 0]``.

:func:`stream_solve` launches ``csrc/stream_shared.cu`` for tensors on a
CUDA device and takes :func:`stream_solve_plain` only for tensors on the CPU.
The kernels run one thread per instance, a warp's 32 slots fed by a work
counter; any ``nx, nu`` and any number of cones are taken as far as shared
memory holds the plant and the staging (:func:`shared_plan`), the shape of
``SHARED_SHAPES`` with compiled loops, every other one with loops at run
time.
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


# csrc/stream_shared.cu: the shape (nx, nu) compiled with fixed loops, the
# long-horizon example's plant (every other runs the run-time body), the most
# knots a slot keeps in flight, slots per block, and the budget of a Hopper
# block's shared memory.
SHARED_SHAPES = ((8, 3),)
KB_MAX = 8
SLOTS = 32
SMEM_LIMIT_BYTES = 232_448


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def shared_smem_bytes(nx: int, nu: int, kb: int, nc: int = 0) -> int:
    """Dynamic shared memory of one block of the shared-plant kernels:
    mirrors ``make_layout`` in ``csrc/stream_shared.cu`` (the C entry
    refuses a launch when the two disagree). The plant's rows padded to
    float4 (A, AmBKt: nx x r4(nx); B, Kinf': nx x r4(nu); Kinf, B': nu x
    r4(nx); Quu_inv), pterm, uniform bounds, the cone table, the run-time
    body's vectors (32 slots x (3 nx + 4 nu)) and each slot's ring of ``kb``
    knots (d, y, z, g, v: 3 nu + 2 nx floats a knot)."""
    r4 = lambda n: (n + 3) & ~3
    px, pu, tw = r4(nx), r4(nu), max(nx, nu)
    words = (2 * nx * px + 2 * nx * pu + 2 * nu * px + nu * pu
             + 3 * px + 2 * pu                        # pterm, bounds
             + r4(nc * (2 + tw)))
    if (nx, nu) not in SHARED_SHAPES:
        words += SLOTS * (3 * nx + 4 * nu)
    return 4 * (words + kb * (3 * nu + 2 * nx) * SLOTS)


def shared_plan(nx: int, nu: int, N: int, knot_block: int = 32, nc: int = 0,
                limit: int = SMEM_LIMIT_BYTES) -> dict:
    """The launch of the shared-plant kernels for these sizes: ``kernel``
    (``"compiled nx/nu"`` for ``SHARED_SHAPES``, else ``"run-time"``),
    ``kb`` (knots a slot keeps in flight: ``knot_block`` up to ``KB_MAX`` and
    the horizon, less where shared memory needs it) and ``smem_bytes``.
    Raises where even one knot does not fit, naming the bytes."""
    kb = max(1, min(int(knot_block), KB_MAX, N))
    while kb > 1 and shared_smem_bytes(nx, nu, kb, nc) > limit:
        kb -= 1
    need = shared_smem_bytes(nx, nu, kb, nc)
    if need > limit:
        raise ValueError(
            f"the stream kernels' plant and staging for nx={nx}, nu={nu}, "
            f"{nc} cones need {need} bytes of shared memory per block "
            f"(limit {limit}): use the scan tier")
    kernel = (f"compiled {nx}/{nu}" if (nx, nu) in SHARED_SHAPES
              else "run-time")
    return {"kernel": kernel, "kb": kb, "smem_bytes": need}


# csrc/stream_admm.cu (the hstream kernels K11/K12): the shapes compiled with
# their plant rows in registers (the robust sweep's quadrotor family, the
# timed one, and the long-horizon example's plant; every other runs the
# run-time body), the most knots a group keeps in flight, the most rows a
# lane owns, and the threads of a block at most.
HSTREAM_SHAPES = ((12, 4), (8, 3))
HSTREAM_KB_MAX = 8
HSTREAM_ROWS_MAX = 8
HSTREAM_THREADS = 128


def _r4(n: int) -> int:
    return (n + 3) & ~3


def hstream_smem_bytes(nx: int, nu: int, kb: int, nc: int = 0,
                       knot_bounds: bool = False, instances: int = 1) -> int:
    """Dynamic shared memory of ``instances`` groups of the hstream kernels:
    mirrors ``make_layout`` in ``csrc/stream_admm.cu`` (the C entry refuses
    a launch when the two disagree). Per instance, rows padded to float4:
    the run-time body's plant rows ([Acl; Kinf], [AmBKt; B']: 2 (nx + nu)
    r4(nx)), the thin rows (B, Kinf': nx x r4(nu) each; Quu_inv), the
    double-buffered x, p, w, the cone slacks, pterm, uniform bounds, the
    cone rows and the ring of ``kb`` knots (d, y, z: r4(nu); g, v, qc:
    r4(nx); the bounds where they come per knot)."""
    px, pu, tw = _r4(nx), _r4(nu), max(nx, nu)
    plant = 0 if (nx, nu) in HSTREAM_SHAPES else 2 * (nx + nu) * px
    words = (plant + 2 * nx * pu + nu * pu            # thin rows
             + 2 * px + 2 * px + 2 * pu + px + pu     # x, p, w, slacks
             + px + 2 * px + 2 * pu                   # pterm, bounds
             + _r4(nc * (2 + tw)))
    rw = 3 * pu + 3 * px + (2 * px + 2 * pu if knot_bounds else 0)
    return 4 * instances * (words + kb * rw)


def hstream_plan(nx: int, nu: int, N: int, knot_block: int = 32,
                 nc: int = 0, knot_bounds: bool = False,
                 limit: int = SMEM_LIMIT_BYTES) -> dict:
    """The launch of the hstream kernels (K11/K12) for these sizes:
    ``kernel`` (``"compiled nx/nu"`` for ``HSTREAM_SHAPES``, else
    ``"run-time"``), ``G`` (lanes per instance: 16 for a compiled shape,
    else the power of two >= nx + nu from 4 to 32; a lane owns rows j, j +
    G, ... of the nx state rows, then the nu input rows), ``rows_per_lane``
    (``ceil((nx + nu) / G)``), ``threads`` and ``instances_per_block``,
    ``kb`` (knots a group keeps in flight: ``knot_block`` within 2 ..
    ``HSTREAM_KB_MAX`` and the horizon), ``smem_bytes`` per block and
    ``bytes_per_instance``. Where a block of 128 threads does not fit,
    fewer instances share a block, then the ring gets shallower. Raises
    where one instance with a ring of two knots does not fit, naming the
    bytes."""
    G = 4
    while G < nx + nu and G < 32:
        G *= 2
    if (nx, nu) in HSTREAM_SHAPES:
        G = 16
    rows_per_lane = -(-(nx + nu) // G)
    kb = max(2, min(int(knot_block), HSTREAM_KB_MAX, N))
    threads = HSTREAM_THREADS
    need = lambda: hstream_smem_bytes(nx, nu, kb, nc, knot_bounds,
                                      threads // G)
    while need() > limit and threads > max(32, G):
        threads //= 2
    while need() > limit and kb > 2:
        kb -= 1
    if need() > limit or rows_per_lane > HSTREAM_ROWS_MAX:
        raise ValueError(
            f"the hstream kernels' plant and staging for nx={nx}, nu={nu}, "
            f"{nc} cones need {need()} bytes of shared memory per block "
            f"(limit {limit}): use tier=\"scan\", which runs any size")
    return {"kernel": (f"compiled {nx}/{nu}" if (nx, nu) in HSTREAM_SHAPES
                       else "run-time"),
            "G": G, "rows_per_lane": rows_per_lane, "threads": threads,
            "instances_per_block": threads // G, "kb": kb,
            "smem_bytes": need(), "bytes_per_instance": need() // (
                threads // G)}


def hstream_resident(nx: int, nu: int, N: int, knot_block: int = 32,
                     nc: int = 0, knot_bounds: bool = False,
                     adaptive: bool = True, device: Any = "cuda") -> int:
    """Blocks of the hstream kernel :func:`hstream_plan` picks that one SM
    holds at once (the CUDA occupancy query); a launch of ``B`` instances
    takes ``ceil(B / instances_per_block / (this x SMs))`` waves."""
    dev = torch.device(device)
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT_BYTES)
    plan = hstream_plan(nx, nu, N, knot_block, nc, knot_bounds, limit)
    with torch.cuda.device(dev):
        n = _library("stream_admm").atm_hstream_resident(
            nx, nu, plan["kb"], nc, int(bool(knot_bounds)),
            int(bool(adaptive)), plan["threads"])
    if n < 1:
        raise RuntimeError(f"hstream_resident: the occupancy query failed "
                           f"({n})")
    return n


def shared_slots(nx: int, nu: int, N: int, knot_block: int = 32,
                 nc: int = 0, adaptive: bool = True,
                 device: Any = "cuda") -> int:
    """Slots the card holds at once for a launch of these sizes (resident
    blocks x ``SLOTS``, from the CUDA occupancy of the kernel
    :func:`shared_plan` picks). A batch past it keeps slots refilling from
    the work counter."""
    dev = torch.device(device)
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT_BYTES)
    kb = shared_plan(nx, nu, N, knot_block, nc, limit)["kb"]
    with torch.cuda.device(dev):
        slots = _library("stream_shared").atm_shared_slots(
            nx, nu, kb, nc, int(bool(adaptive)))
    if slots < 0:
        raise RuntimeError(f"shared_slots: the occupancy query failed "
                           f"({slots}: -1 refused, else a negated CUDA "
                           "error)")
    return slots


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


def _library(name: str) -> ctypes.CDLL:
    """``csrc/stream_shared.cu`` (``name="stream_shared"``, K9/K10) or
    ``csrc/stream_admm.cu`` (``"stream_admm"``, K11/K12), built at first
    use, with its C signatures declared."""
    from ._build import load_library

    lib = load_library(name)
    if not getattr(lib, "_atm_declared", False):
        if name == "stream_shared":
            lib.atm_shared_stream_solve.argtypes = (
                [_P] * 24 + [_I] * 2 + [_P] + [_I] * 9 + [_F] * 2
                + [_I] * 2 + [_P])
            lib.atm_shared_stream_solve.restype = _I
            lib.atm_shared_smem_bytes.argtypes = [_I] * 4
            lib.atm_shared_smem_bytes.restype = _I
            lib.atm_shared_slots.argtypes = [_I] * 5
            lib.atm_shared_slots.restype = _I
        else:
            lib.atm_stream_solve.argtypes = (
                [_P] * 24 + [_I] * 2 + [_P] * 2 + [_I] * 9 + [_F] * 2
                + [_I] * 3 + [_P])
            lib.atm_stream_solve.restype = _I
            lib.atm_hstream_resident.argtypes = [_I] * 7
            lib.atm_hstream_resident.restype = _I
        lib._atm_declared = True
    return lib


def _operands(shared: bool, x0, carry, ops, cones, cone_params, cone_masks):
    """The checked inputs of a launch (shared plant or one per instance), the
    copies of the carry the kernel updates in place (knot-major for the
    shared plant: :func:`_knot_major`; rows padded to float4 for a plant
    per instance: :func:`_padded`), the cone table and whether the bounds
    come a row per knot."""
    nx, nu, N = ops.dims
    m = N - 1
    Bn = x0.shape[0]
    dev = x0.device
    ctab, nc_u, nc_x = ha._cone_table(cones, nx, nu, dev)
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
    copy = _knot_major if shared else (lambda t: _padded(t, True))
    cy = [copy(c(f"carry.{k}", a, (Bn,) + s)) for k, a, s in zip(
        carry._fields, carry, ((m, nu), (m, nu), (N, nx), (m, nu), (N, nx)))]
    nc = nc_u + nc_x
    if cone_params is not None:
        cone_params = c("cone_params", cone_params, (Bn, nc, 2))
    if cone_masks is not None:
        mr = 2 * nu * nc_u + 2 * nx * nc_x
        cone_masks = c("cone_masks", cone_masks, (Bn, mr))
    return ins, cy, (ctab, nc_u, nc_x), cone_params, cone_masks, \
        bound_rows[0] > 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _padded(t: torch.Tensor, copy: bool) -> torch.Tensor:
    """``(B, knots, k)`` with each row padded with zeros to ``r4(k)`` floats
    and 16-byte aligned, the layout the hstream kernels copy 16-byte pieces
    of: a new tensor where ``copy`` or where the rows need padding, else
    ``t`` itself (contiguous, aligned)."""
    k = t.shape[-1]
    if _r4(k) != k:
        out = t.new_zeros(t.shape[:-1] + (_r4(k),))
        out[..., :k] = t
        return out
    if copy or t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _unpadded(t: torch.Tensor, k: int) -> torch.Tensor:
    return t if t.shape[-1] == k else t[..., :k].contiguous()


def _knot_major(t: torch.Tensor) -> torch.Tensor:
    """``(B, knots, k)`` -> ``(knots, k, B)``, a contiguous copy."""
    return t.permute(1, 2, 0).clone(memory_format=torch.contiguous_format)


def _batch_major(t: torch.Tensor) -> torch.Tensor:
    """``(knots, k, B)`` -> ``(B, knots, k)``, contiguous."""
    return t.permute(2, 0, 1).contiguous()


def _launch_shared(x0, carry, sp, *, max_iter: int, knot_block: int,
                   check_termination: int, abs_pri_tol: float,
                   abs_dua_tol: float, en_input_bound: bool,
                   en_state_bound: bool, cones=None) -> StreamResult:
    """Launch ``csrc/stream_shared.cu`` (K9 fixed, K10 adaptive) on CUDA
    tensors (float32; sizes as far as :func:`shared_plan` takes them). The
    kernel works on knot-major copies of the carry (its layout: module
    docstring), which come back batch-leading. Counts the launch under
    ``stream_solve_fixed``/``_adaptive``."""
    from .fused_admm import work_counter

    nx, nu, N = sp.dims
    Bn = x0.shape[0]
    dev = x0.device
    adaptive = check_termination > 0
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT_BYTES)
    nc = 0 if cones is None else (len(cones.input_cones)
                                  + len(cones.state_cones))
    plan = shared_plan(nx, nu, N, knot_block, nc, limit)
    ins, cy, (ctab, nc_u, nc_x), _cp, _cm, knot = _operands(
        True, x0, carry, sp, cones, None, None)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    m = N - 1
    U, X, stats = new(m, nu, Bn), new(N, nx, Bn), new(Bn, 8)
    zs = new(m, nu, Bn) if adaptive else None
    vs = new(N, nx, Bn) if adaptive else None
    counter = work_counter(dev)
    lib = _library("stream_shared")
    with torch.cuda.device(dev):
        err = lib.atm_shared_stream_solve(
            *(t.data_ptr() for t in ins),
            U.data_ptr(), X.data_ptr(), *(t.data_ptr() for t in cy),
            _ptr(zs), _ptr(vs), stats.data_ptr(), _ptr(ctab), nc_u, nc_x,
            counter.data_ptr(), int(knot), Bn, nx, nu, N, int(max_iter),
            int(check_termination) if adaptive else 0,
            int(bool(en_input_bound)), int(bool(en_state_bound)),
            float(abs_pri_tol), float(abs_dua_tol), plan["kb"],
            plan["smem_bytes"], torch.cuda.current_stream().cuda_stream)
    ha._raise_on(err, "stream_solve")
    LAUNCH_COUNTS["stream_solve" + ("_adaptive" if adaptive
                                    else "_fixed")] += 1
    return StreamResult(U=_batch_major(U), X=_batch_major(X),
                        carry=StreamCarry(*(_batch_major(t) for t in cy)),
                        stats=stats)


def _launch_hstream(x0, carry, hsp, *, max_iter: int, knot_block: int,
                    check_termination: int, abs_pri_tol: float,
                    abs_dua_tol: float, en_input_bound: bool,
                    en_state_bound: bool, cones=None, cone_params=None,
                    cone_masks=None) -> StreamResult:
    """Launch ``csrc/stream_admm.cu`` (K11 fixed, K12 adaptive: a plant per
    instance, :class:`.hstream_admm.HStreamProblem`) on CUDA tensors
    (float32; sizes as far as :func:`hstream_plan` takes them). The kernel
    reads the carry, qc and per-knot bounds with each knot's row padded to
    float4 (:func:`_padded`: copies where nx or nu is not a multiple of 4);
    the carry comes back unpadded. Counts the launch under
    ``hstream_solve_fixed``/``_adaptive``."""
    nx, nu, N = hsp.dims
    m = N - 1
    Bn = x0.shape[0]
    dev = x0.device
    adaptive = check_termination > 0
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT_BYTES)
    nc = 0 if cones is None else (len(cones.input_cones)
                                  + len(cones.state_cones))
    plan = hstream_plan(nx, nu, N, knot_block, nc, hsp.has_knot_bounds,
                        limit)
    ins, cy, (ctab, nc_u, nc_x), cone_params, cone_masks, knot = _operands(
        False, x0, carry, hsp, cones, cone_params, cone_masks)
    ins[10] = _padded(ins[10], False)                       # qc
    if knot:
        ins[6:10] = [_padded(t, False) for t in ins[6:10]]  # bound rows
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    U, X, stats = new(Bn, m, nu), new(Bn, N, nx), new(Bn, 8)
    zs = vs = None
    if adaptive:   # read in 16-byte pieces: the padding must be zero
        zs = torch.zeros((Bn, m, _r4(nu)), dtype=torch.float32, device=dev)
        vs = torch.zeros((Bn, N, _r4(nx)), dtype=torch.float32, device=dev)
    lib = _library("stream_admm")
    with torch.cuda.device(dev):
        err = lib.atm_stream_solve(
            *(t.data_ptr() for t in ins),
            U.data_ptr(), X.data_ptr(), *(t.data_ptr() for t in cy),
            _ptr(zs), _ptr(vs), stats.data_ptr(),
            _ptr(ctab), nc_u, nc_x, _ptr(cone_params), _ptr(cone_masks),
            int(knot), Bn, nx, nu, N, int(max_iter),
            int(check_termination) if adaptive else 0,
            int(bool(en_input_bound)), int(bool(en_state_bound)),
            float(abs_pri_tol), float(abs_dua_tol), plan["kb"],
            plan["threads"], plan["smem_bytes"],
            torch.cuda.current_stream().cuda_stream)
    ha._raise_on(err, "hstream_solve")
    LAUNCH_COUNTS["hstream_solve" + ("_adaptive" if adaptive
                                     else "_fixed")] += 1
    carry_out = StreamCarry(*(_unpadded(t, k) for t, k in zip(
        cy, (nu, nu, nx, nu, nx))))
    return StreamResult(U=U, X=X, carry=carry_out, stats=stats)


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
    clip. ``knot_block`` sets the kernels' staged knot block (module
    docstring; results do not depend on it). Combine with
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
    return _launch_shared(x0, carry, sp, knot_block=knot_block, **kw)
