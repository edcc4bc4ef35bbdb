"""Early-termination compaction cascade over the fused adaptive kernel.

Counterpart of ``cascade_solve`` in the JAX package's ``solver/cascade.py``.
The adaptive fused kernel freezes converged instances in place: a block of
instances leaves its loop only when all of them are done, so one straggler
keeps its whole block at ``max_iter`` cost (ops/csrc/admm_iteration.cuh; the
reference has the same all-or-nothing structure per solve, just with a batch
of one -- src/tinympc/admm.cpp:117-152).

:func:`cascade_solve` reclaims that compute at the launch level: run the
kernel ``segment_iters`` iterations at a time, pull converged instances out
of the batch between segments, and launch again on the survivors only,
compacted to the front of a smaller batch. Because the kernel's whole loop
state is the :class:`..ops.fused_admm.FusedCarry` (the per-iteration map
consumes only D/Y/G, with Z/V entering residuals alone) and checks fire at
in-call iteration multiples of ``check_termination``, a segment boundary at
a multiple of the check interval is invisible to the iterate sequence: the
cascade is *iteration-exact* against one long adaptive call -- same
iteration counts, same convergence flags, same check schedule
(tests/test_torch_cascade.py). Iterate values are the same arithmetic on the
same numbers, up to the grouping of sums: a smaller batch may run at another
tile, which splits the backward product's depth over other lanes (on the
CPU: the matrix products group their sums by batch size), a few float32 ulp
on the iterates. That can only alter scheduling if a residual sits within
an ulp of the tolerance at a check.

Cost model: one long call costs ``sum over blocks of (block's slowest
instance)`` iterations; the cascade costs ``sum_s survivors_s * segment_s``
plus, per segment, one launch, one ``index_copy_`` of the segment's rows
into the preallocated ``(B, .)`` outputs, one read of the solved column by
the host, and one ``index_select`` of the survivors. On workloads where most
instances converge early (warm-started MPC re-solves, mixed-difficulty
sweeps) the reclaimed tail dominates; for tightly clustered convergence use
one plain :func:`..ops.fused_admm.fused_solve` call.

:func:`hetero_cascade_solve` does the same over the heterogeneous-plant
adaptive kernel (K8), gathering the survivors' plants, carries and
per-instance cone operands between segments. There an instance's arithmetic
does not depend on where it sits in the batch, so that cascade is bit-exact
against one long adaptive call. :func:`stream_cascade_solve` and
:func:`hstream_cascade_solve` do the same over the long-horizon kernels
(K10, K12), and also offer the JAX package's segment-granular fixed mode.
"""

from __future__ import annotations

import torch

from ..ops.fused_admm import (
    FusedCarry,
    FusedResult,
    PaddedProblem,
    fused_solve,
)
from ..ops.hetero_admm import HeteroCarry, gather_hetero, hetero_solve
from ..ops.stream_admm import StreamCarry

__all__ = ["cascade_solve", "hetero_cascade_solve", "stream_cascade_solve",
           "hstream_cascade_solve"]


def _segment_schedule(check_termination: int, segment_iters, segment_growth):
    """Validated ``segment_iters`` (default ~25, a multiple of the check
    interval so the in-call check schedule composes to one call's)."""
    if check_termination <= 0:
        raise ValueError(
            "the cascade requires adaptive mode (check_termination > 0); "
            "fixed-iteration solves cannot converge early"
        )
    if segment_iters is None:
        segment_iters = check_termination * max(
            1, round(25 / check_termination)
        )
    if segment_iters % check_termination != 0:
        raise ValueError(
            f"segment_iters ({segment_iters}) must be a multiple of "
            f"check_termination ({check_termination}) so the check schedule "
            "matches a single adaptive call"
        )
    if segment_growth < 1.0:
        raise ValueError("segment_growth must be >= 1.0")
    return segment_iters


def _grow(cur_seg: int, segment_growth: float, check_termination: int) -> int:
    """Geometric segment growth, kept on the check-interval grid (any
    multiple-of-check segmentation preserves the global schedule)."""
    return max(check_termination,
               int(cur_seg * segment_growth)
               // check_termination * check_termination)


def _segments(max_iter, segment_iters, segment_growth, check_termination,
              launch, compact, trace):
    """The segment loop of both cascades. ``launch(k, done_iters)`` runs
    ``k`` iterations on the current survivors and returns a result with
    ``U``, ``X``, ``stats`` and ``carry``; ``compact(carry, keep)`` narrows
    the launch operands to the survivors ``keep`` (rows of the last launch)
    with the last launch's carry. Returns ``(U, X, stats, *carry)`` in the
    original batch order.

    The first launch is the whole batch; afterwards ``idx`` maps the rows
    of the compacted batch to their original indices. Iteration counts
    compose as offset + in-segment value (unsolved instances report the
    segment's full length, so offsets telescope as later segments overwrite
    their rows)."""
    with torch.no_grad():
        idx, out, done_iters, cur_seg = None, None, 0, segment_iters
        while True:
            k = min(cur_seg, max_iter - done_iters)
            res = launch(k, done_iters)
            if trace is not None:
                trace.append((k, res.U.shape[0]))
            stats = res.stats.clone()
            stats[:, 0] += done_iters
            rows = (res.U, res.X, stats) + tuple(res.carry)
            if out is None:
                out = tuple(r.clone() for r in rows)
            else:
                for buf, r in zip(out, rows):
                    buf.index_copy_(0, idx, r)
            done_iters += k
            if done_iters >= max_iter:
                return out
            keep = torch.nonzero(res.stats[:, 1].cpu() < 0.5)[:, 0]
            if keep.numel() == 0:
                return out
            cur_seg = _grow(cur_seg, segment_growth, check_termination)
            keep = keep.to(res.U.device)
            idx = keep if idx is None else idx.index_select(0, keep)
            compact(res.carry, keep)


def cascade_solve(
    x0: torch.Tensor,
    carry: FusedCarry,
    pp: PaddedProblem,
    *,
    max_iter: int = 100,
    check_termination: int = 1,
    segment_iters: int | None = None,
    segment_growth: float = 4.0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    batch_tile: int | None = None,
    warmup_iters: int = 0,
    xref_q: torch.Tensor | None = None,
    pterm_c: torch.Tensor | None = None,
    cone_ops=None,
    cone_mu_u=None,
    cone_shift_u=None,
    cone_mu_x=None,
    cone_shift_x=None,
    algo: str = "f32",
    alpha: float = 1.0,
    trace: list | None = None,
) -> FusedResult:
    """Adaptive fused solve with between-segment batch compaction.

    Drop-in equivalent of ``fused_solve(..., check_termination>0)`` -- same
    arguments, same :class:`FusedResult` (full original batch order) -- but
    converged instances stop occupying a block at the next segment boundary.

    ``segment_iters`` (default: ~25, rounded to a multiple of
    ``check_termination``) must be a multiple of ``check_termination`` so
    the in-call check schedule composes to the single-call schedule.
    Segments grow geometrically by ``segment_growth`` (rounded to check
    multiples): the survivors of each compaction are the hard instances,
    which converge rarely -- longer late segments trade (useless) compaction
    opportunities for fewer launches and host reads.
    ``warmup_iters`` applies to the first segment only. This is a host loop
    with one device-to-host read per segment.

    The JAX function's ``min_bucket`` is not carried over: there the
    survivors are padded to a power-of-two bucket (by repeating the last
    survivor, results sent to a discard row) only to bound recompiles of a
    shape-specialised kernel. The CUDA kernel takes any batch size and masks
    its own ragged edge, so the survivors are launched as they are: no
    bucket ladder, no padding, no discard row.

    ``trace``, if a list, receives one ``(iterations, batch)`` pair per
    segment launched.
    """
    segment_iters = _segment_schedule(check_termination, segment_iters,
                                      segment_growth)
    if warmup_iters >= segment_iters:
        raise ValueError("warmup_iters must be < segment_iters")

    common = dict(
        check_termination=check_termination, abs_pri_tol=abs_pri_tol,
        abs_dua_tol=abs_dua_tol, batch_tile=batch_tile, xref_q=xref_q,
        pterm_c=pterm_c, cone_ops=cone_ops, algo=algo, alpha=alpha,
    )
    cols = {"cone_mu_u": cone_mu_u, "cone_shift_u": cone_shift_u,
            "cone_mu_x": cone_mu_x, "cone_shift_x": cone_shift_x}
    cols = {k: None if v is None else torch.as_tensor(v).to(x0.device)
            for k, v in cols.items()}
    x0_b, carry_b = x0, carry

    def launch(k, done_iters):
        return fused_solve(
            x0_b, carry_b, pp, max_iter=k,
            warmup_iters=warmup_iters if done_iters == 0 else 0,
            **common, **cols)

    def compact(res_carry, keep):
        nonlocal x0_b, carry_b, cols
        x0_b = x0_b.index_select(0, keep)
        carry_b = FusedCarry(*(a.index_select(0, keep) for a in res_carry))
        cols = {k: None if v is None else v.index_select(1, keep)
                for k, v in cols.items()}

    out = _segments(max_iter, segment_iters, segment_growth,
                    check_termination, launch, compact, trace)
    return FusedResult(U=out[0], X=out[1], carry=FusedCarry(*out[3:]),
                       stats=out[2])


def hetero_cascade_solve(
    x0: torch.Tensor,
    carry: HeteroCarry,
    hp,
    *,
    max_iter: int = 100,
    check_termination: int = 1,
    segment_iters: int | None = None,
    segment_growth: float = 4.0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    cones=None,
    cone_params=None,
    cone_masks=None,
    en_input_bound: bool = True,
    en_state_bound: bool = True,
    trace: list | None = None,
):
    """Compaction cascade over the heterogeneous-plant adaptive kernel.

    The same launch-level early-termination reclaim as :func:`cascade_solve`
    (which see for the cost model) for batches where every instance carries
    its own plant: between segments the surviving instances -- plants,
    carries, x0 and the per-instance cone operands -- are gathered
    (:func:`..ops.hetero_admm.gather_hetero`) and launched as they are (no
    power-of-two bucket ladder: the kernel takes any batch size). Per
    instance the arithmetic does not depend on its place in the batch, so
    the cascade is bit-exact against one long adaptive
    :func:`..ops.hetero_admm.hetero_solve` call: schedules and iterates.

    Returns ``(U, X, stats, carry)`` in the original batch order; ``carry``
    is warm-start ready for the whole batch. ``trace``, if a list, receives
    one ``(iterations, batch)`` pair per launch.
    """
    segment_iters = _segment_schedule(check_termination, segment_iters,
                                      segment_growth)
    common = dict(
        check_termination=check_termination, abs_pri_tol=abs_pri_tol,
        abs_dua_tol=abs_dua_tol, en_input_bound=en_input_bound,
        en_state_bound=en_state_bound, cones=cones)
    hp_b, carry_b, x0_b, cp_b, cm_b = hp, carry, x0, cone_params, cone_masks

    def launch(k, _done_iters):
        return hetero_solve(x0_b, carry_b, hp_b, max_iter=k,
                            cone_params=cp_b, cone_masks=cm_b, **common)

    def compact(res_carry, keep):
        nonlocal hp_b, carry_b, x0_b, cp_b, cm_b
        hp_b, carry_b, x0_b, cp_b, cm_b = gather_hetero(
            hp_b, res_carry, x0_b, keep, cp_b, cm_b)

    out = _segments(max_iter, segment_iters, segment_growth,
                    check_termination, launch, compact, trace)
    return out[0], out[1], out[2], HeteroCarry(*out[3:])


def _stream_segments(x0, carry, state, max_iter, segment_iters,
                     segment_growth, check_termination, abs_pri_tol,
                     abs_dua_tol, solve, gather, trace):
    """The segment loop of the two long-horizon cascades. ``solve(x0, carry,
    k, state)`` runs ``k`` iterations on the survivors (``state``: the other
    per-instance operands, narrowed alongside); ``gather(state, carry, x0,
    keep)`` returns the narrowed ``(state, carry, x0)``.

    In fixed mode a segment's solved flag is the scan tier's convergence
    predicate on its final-iteration residuals (reference admm.cpp:99-105
    at a check cadence of ``segment_iters``) and an instance reports the
    iterations up to its exit segment's end."""
    if max_iter < 1 or segment_iters < 1:
        raise ValueError("max_iter and segment_iters must be >= 1")
    if segment_growth < 1.0:
        raise ValueError("segment_growth must be >= 1.0")
    ce = int(check_termination)
    if ce > 0 and segment_iters % ce:
        raise ValueError(
            "segment_iters must be a multiple of check_termination so the "
            "segment-local check cadence matches the single-call schedule")
    cur = {"x0": x0, "carry": carry, "state": state}

    def launch(k, _done_iters):
        res = solve(cur["x0"], cur["carry"], k, cur["state"])
        if ce:
            return res
        st = res.stats.clone()
        st[:, 1] = ((st[:, 2] < abs_pri_tol) & (st[:, 4] < abs_pri_tol)
                    & (st[:, 3] < abs_dua_tol)
                    & (st[:, 5] < abs_dua_tol)).to(st.dtype)
        st[:, 0] = k
        return res._replace(stats=st)

    def compact(res_carry, keep):
        cur["state"], cur["carry"], cur["x0"] = gather(
            cur["state"], res_carry, cur["x0"], keep)

    out = _segments(max_iter, segment_iters, segment_growth, max(ce, 1),
                    launch, compact, trace)
    return out[0], out[1], out[2], StreamCarry(*out[3:])


def stream_cascade_solve(
    x0: torch.Tensor,
    carry,
    sp,
    *,
    max_iter: int = 100,
    segment_iters: int = 25,
    segment_growth: float = 4.0,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    knot_block: int = 32,
    cones=None,
    en_input_bound: bool = True,
    en_state_bound: bool = True,
    trace: list | None = None,
):
    """Early-termination compaction for the streaming long-horizon tier.

    Two modes:

    * ``check_termination == 0`` (segment-granular): fixed-iteration
      segments, the scan tier's convergence predicate applied to each
      segment's final-iteration residuals (reference: admm.cpp:99-105 at a
      check cadence of ``segment_iters``), converged instances kept out of
      later segments. A converged instance's controls equal the
      fixed-iteration solve at its recorded (segment-multiple) count; its
      carry is the slack-saved post-backward state (one stage past the
      reference's early-exit freeze, an equally valid warm start).
    * ``check_termination > 0`` (in-kernel freeze + compaction): each
      segment runs the adaptive kernel (K10), so instances freeze at their
      exact check (reference early exit admm.cpp:135-144) inside the
      segment, and the survivors are gathered between segments. The result
      equals one long adaptive call: iteration counts, solved flags, frozen
      iterates and residual stats, bit for bit on the card (an instance's
      arithmetic does not depend on its place in the batch).
      ``segment_iters`` must be a multiple of ``check_termination``.

    Survivors are launched as they are (the JAX function pads them to
    power-of-two lane-tile buckets, a bound on recompiles of its
    shape-specialised kernel that a CUDA launch does not need: no
    ``min_bucket``). Returns ``(U, X, stats, carry)`` in the original batch
    order; ``trace``, if a list, receives one ``(iterations, batch)`` pair
    per launch.
    """
    from ..ops.stream_admm import stream_solve

    kw = dict(knot_block=knot_block, check_termination=check_termination,
              abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
              en_input_bound=en_input_bound, en_state_bound=en_state_bound,
              cones=cones)

    def solve(x, c, k, _state):
        return stream_solve(x, c, sp, max_iter=k, **kw)

    def gather(state, c, x, keep):
        return state, StreamCarry(*(a.index_select(0, keep) for a in c)), \
            x.index_select(0, keep)

    return _stream_segments(x0, carry, None, max_iter, segment_iters,
                            segment_growth, check_termination, abs_pri_tol,
                            abs_dua_tol, solve, gather, trace)


def hstream_cascade_solve(
    x0: torch.Tensor,
    carry,
    hsp,
    *,
    max_iter: int = 100,
    segment_iters: int = 25,
    segment_growth: float = 4.0,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    knot_block: int = 16,
    cones=None,
    cone_params=None,
    cone_masks=None,
    en_input_bound: bool = True,
    en_state_bound: bool = True,
    trace: list | None = None,
):
    """Segment-level early termination for the heterogeneous streaming tier
    (per-instance plants at long horizons): :func:`stream_cascade_solve`'s
    two modes (which see), with the survivors' plants, carries, x0 and
    per-instance cone operands (``cone_params``/``cone_masks``, as in
    :func:`..ops.hstream_admm.hstream_solve`) gathered at each compaction
    (:func:`..ops.hstream_admm.gather_hstream`), as in
    :func:`hetero_cascade_solve`. (The JAX function takes no per-instance
    cone operands, so a fleet's per-instance cone geometry does not reach
    its segments: ROADMAP.md section 3.)

    Returns ``(U, X, stats, carry)`` in the original batch order.
    """
    from ..ops.hstream_admm import gather_hstream, hstream_solve

    kw = dict(knot_block=knot_block, check_termination=check_termination,
              abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
              en_input_bound=en_input_bound, en_state_bound=en_state_bound,
              cones=cones)

    def solve(x, c, k, state):
        hp, cp, cm = state
        return hstream_solve(x, c, hp, max_iter=k, cone_params=cp,
                             cone_masks=cm, **kw)

    def gather(state, c, x, keep):
        hp, c2, x2, cp, cm = gather_hstream(state[0], c, x, keep, *state[1:])
        return (hp, cp, cm), c2, x2

    return _stream_segments(x0, carry, (hsp, cone_params, cone_masks),
                            max_iter, segment_iters, segment_growth,
                            check_termination, abs_pri_tol, abs_dua_tol,
                            solve, gather, trace)
