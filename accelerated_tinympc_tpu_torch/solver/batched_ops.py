"""Per-instance-operator condensed tier: heterogeneous plants / penalties.

Counterpart of the JAX package's ``solver/batched_ops.py``. The reference
binds one plant per process (global workspace, reference:
src/tinympc/tiny_wrapper.hpp:6) and one rho per *build* (baked by codegen,
reference: src/tinympc/codegen.cpp:254-258). This tier inverts both limits:
every instance in the batch carries its own condensed operator set (distinct
A/B/Q/R and/or distinct rho), built **on the device** by the batched
:func:`..precompute.riccati_cache_jax` (or the Riccati CUDA kernels,
:mod:`..ops.riccati_kernel`) + :func:`..precompute.condensed_operators_jax`,
and the ADMM iteration becomes a handful of batched contractions
(``einsum('bi,bij->bj')``) instead of the shared-operator products of
:mod:`.condensed` / the fused kernel.

The iteration math is the *folded* form the fused kernel uses (see
ops/fused_admm.py module docstring): with ``W_q = -rho*[Eq^T; Ep^T]``,
``W_r = -rho*Er^T`` and ``const_d = xref_q@Eq^T + pterm_c@Ep^T``, each
iteration is 4 batched matvecs + elementwise chains -- stage for stage the
reference schedule (src/tinympc/admm.cpp:117-150) with identical warm-start
and early-exit semantics.

On top of it, :func:`solve_adaptive_rho_batched` runs the OSQP-style
stall-guarded rho adaptation (see :mod:`.adaptive_rho`) *per instance* on
the device: chunked iterations, per-instance residual-imbalance tests,
per-instance dual rescaling, and a batched on-device Riccati + operator
refresh each round. A batch where some instances carry a rho mis-scaled by
orders of magnitude converges within a small multiple of the well-scaled
instances' iterations.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..precompute import condensed_operators_jax, riccati_cache_jax
from ..types import Cache, Problem, Settings

torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 products


class InstanceOps(NamedTuple):
    """Batch-leading condensed operators + problem vectors, one set per
    instance. Shapes: B batch, Dx = N*nx, Du = (N-1)*nu."""

    Fx0T: torch.Tensor    # (B, nx, Dx)
    Gx0T: torch.Tensor    # (B, nx, Du)
    W_fd: torch.Tensor    # (B, Du, Dx)
    W_gd: torch.Tensor    # (B, Du, Du)
    W_q: torch.Tensor     # (B, Dx, Du)  -rho folded
    W_r: torch.Tensor     # (B, Du, Du)  -rho folded
    const_d: torch.Tensor  # (B, Du)
    u_min: torch.Tensor   # (B, Du)
    u_max: torch.Tensor
    x_min: torch.Tensor   # (B, Dx)
    x_max: torch.Tensor
    rho: torch.Tensor     # (B,)


def _bmv(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Batched row-vector x matrix: (B, i) x (B, i, j) -> (B, j)."""
    return torch.einsum("bi,bij->bj", v, M)


def build_instance_ops(problem: Problem, cache: Cache) -> InstanceOps:
    """Build per-instance operators from a batch-leading problem and cache
    (every field carries a leading batch axis)."""
    N = problem.Xref.shape[-2]
    Bn = problem.A.shape[0]
    with torch.no_grad():
        ops = condensed_operators_jax(cache, problem.A, problem.B, N)
        T = lambda a: a.transpose(-1, -2)
        EqT, EpT = T(ops.Eq), T(ops.Ep)          # (B, m*nx, Du), (B, nx, Du)
        Wqp = torch.cat([EqT, EpT], dim=1)       # (B, Dx, Du)
        rho = cache.rho.to(problem.A.dtype).reshape(Bn)
        xref_q = -(problem.Xref * problem.Q[:, None, :]).reshape(Bn, -1)
        pterm_c = -_bmv(problem.Xref[:, -1], cache.Pinf)         # (B, nx)
        const_d = _bmv(xref_q[:, : EqT.shape[1]], EqT) + _bmv(pterm_c, EpT)
        r3 = rho[:, None, None]
        flat = lambda a: a.reshape(Bn, -1)
        return InstanceOps(
            Fx0T=T(ops.Fx0), Gx0T=T(ops.Gx0), W_fd=T(ops.Fd), W_gd=T(ops.Gd),
            W_q=-r3 * Wqp, W_r=-r3 * T(ops.Er), const_d=const_d,
            u_min=flat(problem.u_min), u_max=flat(problem.u_max),
            x_min=flat(problem.x_min), x_max=flat(problem.x_max), rho=rho,
        )


def _use_kernel(riccati: str, A: torch.Tensor) -> bool:
    """Whether the Riccati routines of :mod:`..ops.riccati_kernel` run:
    always for ``"kernel"``/``"newton"`` (on CPU tensors they take their
    plain versions themselves), and for ``"auto"`` whenever the tensors are
    on a CUDA device. Sizes above the kernels' limits then raise there;
    nothing switches to the batched tensor code on the card unasked."""
    return riccati in ("kernel", "newton") or (
        riccati == "auto" and A.is_cuda)


def build_instance_ops_from_plants(
    A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
    rho: torch.Tensor, problem: Problem, riccati: str = "auto",
) -> tuple[InstanceOps, Cache]:
    """On-device cache + operator build for a batch of distinct plants.

    ``A (B,nx,nx)``, ``B (B,nx,nu)``, ``Q/R (B,nx)/(B,nu)`` raw cost
    diagonals, ``rho (B,)``; ``problem`` supplies batch-leading bounds/Xref.
    Returns the operators plus the batched Riccati caches (reference math:
    src/tinympc/codegen.cpp:268-292, run per instance on the device;
    ``riccati`` selects the Riccati routine as in
    :func:`solve_adaptive_rho_batched`).
    """
    if _use_kernel(riccati, A):
        from ..ops.riccati_kernel import riccati_cache_kernel

        caches = riccati_cache_kernel(A, B, Q, R, rho)
    else:
        caches = riccati_cache_jax(A, B, Q, R, rho)
    prob_b = problem.replace(A=A, B=B, Q=Q, R=R)
    return build_instance_ops(prob_b, caches), caches


class OpsState(NamedTuple):
    """Iterate set of the per-instance tier (flat, batch-leading)."""

    D: torch.Tensor   # (B, Du)
    Y: torch.Tensor
    G: torch.Tensor   # (B, Dx)
    Z: torch.Tensor
    V: torch.Tensor
    U: torch.Tensor   # (B, Du) final pre-projection controls
    X: torch.Tensor   # (B, Dx)
    pri_s: torch.Tensor  # (B,) residuals at the last check
    dua_s: torch.Tensor
    pri_u: torch.Tensor
    dua_u: torch.Tensor
    solved: torch.Tensor  # (B,) bool
    iter: torch.Tensor    # (B,) int32

    @staticmethod
    def zeros(batch: int, Dx: int, Du: int, dtype=torch.float32,
              device: Any = "cuda") -> "OpsState":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        fu, fx, sc = z(batch, Du), z(batch, Dx), z(batch)
        return OpsState(
            D=fu, Y=fu, G=fx, Z=fu, V=fx, U=fu, X=fx,
            pri_s=sc, dua_s=sc, pri_u=sc, dua_u=sc,
            solved=torch.zeros((batch,), dtype=torch.bool, device=device),
            iter=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    def reset_duals(self) -> "OpsState":
        return self._replace(Y=torch.zeros_like(self.Y),
                             G=torch.zeros_like(self.G))


def _tmap(fn, *trees):
    """``fn`` over the tensor fields of NamedTuples or :class:`Cache`s."""
    first = trees[0]
    if isinstance(first, Cache):
        return Cache(**{k: fn(*(getattr(t, k) for t in trees))
                        for k in first.tensors()})
    return type(first)(*(fn(*xs) for xs in zip(*trees)))


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a per-instance scalar ``(B,)`` to broadcast against
    ``like (B, ...)``."""
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def _sel(mask: torch.Tensor, a, b):
    """Per-instance select over batch-leading trees."""
    return _tmap(lambda x, y: torch.where(_bcast(mask, x), x, y), a, b)


def _project_cones(Wk, cone_list, args):
    """Apply each cone to per-knot vectors ``Wk (B, K, dim)``; ``args``
    (optional) is the matching tuple of per-instance override tuples from
    :func:`.cones.make_cone_args` -- any non-None field switches that cone
    to the masked (per-instance-geometry) projection."""
    from .cones import project_cone, project_cone_masked

    for ci, cone in enumerate(cone_list):
        ov = None if args is None else args[ci]
        if ov is None or all(e is None for e in ov):
            Wk = project_cone(Wk, cone)
        else:
            mu_c, sh_c, bm, am = ov
            Wk = project_cone_masked(
                Wk, cone, ball_mask=bm, axis_mask=am, mu=mu_c, shift=sh_c
            )
    return Wk


def _iteration(D, Y, G, Xb, Ub, ops: InstanceOps, cones=None,
               dims=None, cone_args=None):
    """One folded condensed iteration, per-instance operators (same schedule
    as ops/fused_admm._iteration; reference: src/tinympc/admm.cpp:117-150).
    ``cones`` (ConeSet) appends exact SOC projections after the box clips --
    the flat slacks view per knot via ``dims = (nx, nu)``; ``cone_args``
    (:func:`.cones.make_cone_args`) overrides cone parameters/geometry per
    instance."""
    X = Xb + _bmv(D, ops.W_fd)
    U = Ub + _bmv(D, ops.W_gd)
    S = U + Y
    Znew = torch.minimum(torch.maximum(S, ops.u_min), ops.u_max)
    if cones is not None and cones.input_cones:
        Zk = Znew.reshape(Znew.shape[0], -1, dims[1])
        Zk = _project_cones(
            Zk, cones.input_cones,
            None if cone_args is None else cone_args[0],
        )
        Znew = Zk.reshape(Znew.shape[0], -1)
    Yn = S - Znew
    T = X + G
    Vnew = torch.minimum(torch.maximum(T, ops.x_min), ops.x_max)
    if cones is not None and cones.state_cones:
        Vk = Vnew.reshape(Vnew.shape[0], -1, dims[0])
        Vk = _project_cones(
            Vk, cones.state_cones,
            None if cone_args is None else cone_args[1],
        )
        Vnew = Vk.reshape(Vnew.shape[0], -1)
    Gn = T - Vnew
    Dn = _bmv(Vnew - Gn, ops.W_q) + _bmv(Znew - Yn, ops.W_r) + ops.const_d
    return Dn, Yn, Gn, Znew, Vnew, U, X


def solve_instance_ops(
    x0: torch.Tensor,
    state: OpsState,
    ops: InstanceOps,
    settings: Settings,
    *,
    cones=None,
    dims=None,
    cone_args=None,
) -> OpsState:
    """Batched solve with one operator set per instance.

    Freeze-on-converge semantics identical to :func:`.batched.solve_batched`
    (an instance's trajectory matches its standalone solve; early exit skips
    the slack save + backward pass -- reference:
    src/tinympc/admm.cpp:135-144). ``check_termination == 0`` runs the
    deterministic fixed-iteration mode. ``cones``/``dims=(nx, nu)`` as in
    :func:`_iteration` (required together); ``cone_args``
    (:func:`.cones.make_cone_args`) adds per-instance cone
    parameter/geometry overrides. The iteration loop is a host loop; in
    adaptive mode it reads one ``any()`` from the device per iteration.
    """
    if cones is not None and dims is None:
        raise ValueError("cones on the instance-ops tier require dims")
    with torch.no_grad():
        Xb = _bmv(x0, ops.Fx0T)
        Ub = _bmv(x0, ops.Gx0T)
        max_iter = settings.max_iter
        ce = settings.check_termination
        st = state._replace(
            solved=torch.zeros_like(state.solved),
            iter=torch.zeros_like(state.iter),
        )
        step = lambda s: _iteration(
            s.D, s.Y, s.G, Xb, Ub, ops, cones, dims, cone_args)

        if ce <= 0:
            for _ in range(max_iter):
                Dn, Yn, Gn, Znew, Vnew, U, X = step(st)
                st = st._replace(D=Dn, Y=Yn, G=Gn, Z=Znew, V=Vnew, U=U, X=X,
                                 iter=st.iter + 1)
            # Residual stats from the final iterate set (solved flag
            # untracked, as in the fixed fused kernel).
            return st._replace(
                pri_s=(st.X - st.V).abs().amax(dim=-1),
                pri_u=(st.U - st.Z).abs().amax(dim=-1))

        amax = lambda a: a.abs().amax(dim=-1)
        while bool(((st.iter < max_iter) & ~st.solved).any()):
            Dn, Yn, Gn, Znew, Vnew, U, X = step(st)
            it = st.iter + 1
            checking = (it % ce) == 0
            pri_s = amax(X - Vnew)
            dua_s = ops.rho * amax(st.V - Vnew)
            pri_u = amax(U - Znew)
            dua_u = ops.rho * amax(st.Z - Znew)
            conv = checking & (
                (pri_s < settings.abs_pri_tol) & (pri_u < settings.abs_pri_tol)
                & (dua_s < settings.abs_dua_tol)
                & (dua_u < settings.abs_dua_tol)
            )
            keep = lambda new, old: torch.where(checking, new, old)
            # Converged instances keep pre-backward D and pre-save Z/V; duals
            # and U/X advanced this iteration (reference early-exit dataflow).
            mu = conv[:, None]
            adv = st._replace(
                D=torch.where(mu, st.D, Dn), Y=Yn, G=Gn,
                Z=torch.where(mu, st.Z, Znew), V=torch.where(mu, st.V, Vnew),
                U=U, X=X,
                pri_s=keep(pri_s, st.pri_s), dua_s=keep(dua_s, st.dua_s),
                pri_u=keep(pri_u, st.pri_u), dua_u=keep(dua_u, st.dua_u),
                solved=st.solved | conv, iter=it,
            )
            # Frozen instances don't advance at all.
            st = _sel(st.solved, st, adv)
        return st


def adaptive_rounds(rho, max_rounds, chunk_step, rescale_duals, refresh, *,
                    adapt_factor, stall_factor, rho_min, rho_max):
    """The per-instance round loop shared by the three batched engines
    (:func:`solve_adaptive_rho_batched`,
    :func:`.adaptive_hetero.solve_adaptive_rho_hetero`,
    :func:`.adaptive_scan.solve_adaptive_rho_scan`), which differ only in
    how they run a chunk and refresh their caches.

    Each round: ``chunk_step(solved) -> (solved, pri, dua)`` runs one chunk
    of iterations, keeps the instances solved in an earlier round frozen
    verbatim and returns the new solved flags and per-instance residuals.
    An unsolved instance whose max residual failed to fall by
    ``stall_factor`` since the last round *and* whose imbalance
    ``sqrt(pri/dua)`` exceeds ``adapt_factor`` either way rescales its rho by
    that ratio (clipped to ``[rho_min, rho_max]``);
    ``rescale_duals(rho_old / rho_new)`` (ones where unchanged) keeps the
    underlying multipliers and ``refresh(new_rho, changed)`` brings the
    caches to the new rho. A host loop: one read of the solved flags per
    round. Returns ``(rho, solved, rounds)``."""
    solved = torch.zeros(rho.shape, dtype=torch.bool, device=rho.device)
    prev_max = torch.full_like(rho, float("inf"))
    rounds = 0
    while rounds < max_rounds and bool((~solved).any()):
        solved, pri, dua = chunk_step(solved)
        max_res = torch.maximum(pri, dua)
        stalled = max_res * stall_factor > prev_max
        ratio = torch.sqrt(pri.clamp_min(1e-12) / dua.clamp_min(1e-12))
        imbalanced = (ratio > adapt_factor) | (ratio < 1.0 / adapt_factor)
        new_rho = torch.where(stalled & imbalanced & ~solved,
                              (rho * ratio).clamp(rho_min, rho_max), rho)
        changed = new_rho != rho
        prev_max = torch.where(
            changed, torch.full_like(max_res, float("inf")), max_res)
        rescale_duals(torch.where(changed, rho / new_rho, torch.ones_like(rho)))
        refresh(new_rho, changed)
        rho = new_rho
        rounds += 1
    return rho, solved, rounds


def refresh_changed(caches: Cache, new_caches: Cache, changed) -> Cache:
    """``new_caches`` where ``changed`` (B,), ``caches`` elsewhere: an
    instance whose rho did not change keeps its cache bits."""
    return Cache(**{
        k: torch.where(changed.reshape((-1,) + (1,) * (v.dim() - 1)),
                       getattr(new_caches, k), v)
        for k, v in caches.tensors().items()})


class AdaptiveRhoBatchedResult(NamedTuple):
    state: OpsState
    rho: torch.Tensor         # (B,) final per-instance rho
    cache: Cache              # batch-leading caches at the final rho
    rounds: int               # chunks executed
    total_iter: torch.Tensor  # (B,) iterations run per instance


def solve_adaptive_rho_batched(
    x0: torch.Tensor,
    problem: Problem,
    A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
    rho0: torch.Tensor,
    settings: Settings,
    *,
    chunk: int = 25,
    max_rounds: int = 40,
    adapt_factor: float = 5.0,
    stall_factor: float = 1.5,
    rho_min: float = 1e-2,
    rho_max: float = 1e3,
    refresh: str = "exact",
    trust: float = 2.0,
    fd_eps: float = 0.05,
    cones=None,
    cone_args=None,
    riccati: str = "auto",
) -> AdaptiveRhoBatchedResult:
    """Per-instance OSQP-style rho adaptation on the device.

    Semantics per instance mirror :func:`.adaptive_rho.solve_adaptive_rho`
    (which see): ``chunk``-iteration segments; between segments an instance
    whose progress stalled *and* whose residual imbalance exceeds
    ``adapt_factor`` rescales its rho by ``sqrt(pri/dua)`` (clipped),
    rescales its duals by ``rho_old/rho_new``, and refreshes its Riccati
    cache + condensed operators on the device (batched). Well-scaled
    instances never trigger the guard and follow the fixed-rho trajectory
    exactly. The loop over rounds is a host loop: one ``any()`` read per
    round decides whether to go on, and one whether to refresh.

    ``refresh`` selects the cache-refresh strategy after a rho update:

    * ``"exact"`` -- rebuild caches + operators on rounds where some
      instance's rho changed (skipped otherwise). The Riccati fixed point
      warm-starts from the carried ``Pinf``/``Kinf`` (the contraction
      re-converges in a few steps instead of ~100 cold ones), and
      per-instance selects keep every rho-unchanged instance's operators
      bit-stable.
    * ``"first_order"`` -- first-order adaptive caching (PAPERS.md, "Robust
      and Efficient Embedded Convex Optimization through First-Order
      Adaptive Caching"): hold the operators and a per-instance d/drho
      sensitivity and refresh by an axpy
      ``ops(rho) ~= ops(c) + d_ops * (rho - c)`` instead of a Riccati fixed
      point + horizon build. When an instance's rho leaves its
      multiplicative trust region ``[c/trust, c*trust]``, one warm-started
      exact build re-anchors the out-of-trust instances and refreshes their
      sensitivity by the secant through the old and new anchors; in-trust
      instances keep their anchor untouched. NB: with this module's stall
      guard, updates only fire at imbalance > ``adapt_factor`` -- every step
      is a factor >= sqrt(adapt_factor), which exceeds the default trust
      region, so ``first_order`` recenters on every update; it pays off
      under *gradual* rho policies. For the default policy prefer
      ``exact``.
    * ``"cold"`` -- unconditional cold rebuild every round (kept as the
      benchmark reference point).

    ``A/B/Q/R (B, ...)`` are per-instance plants (share a plant by
    expanding); ``rho0 (B,)`` initial penalties; ``problem`` supplies
    batch-leading bounds/Xref. Termination inside chunks uses the
    ``settings`` tolerances with ``check_termination`` cadence. ``cones``
    (ConeSet) adds SOC projections to every chunk's slack stage;
    ``cone_args`` (:func:`.cones.make_cone_args`) overrides cone
    parameters/geometry per instance.

    ``riccati`` selects the Riccati routine inside refreshes: ``"kernel"``
    (the batched CUDA fixed point, :mod:`..ops.riccati_kernel`,
    warm-startable), ``"newton"`` (fixed-point initial build +
    Newton-Kleinman warm refreshes,
    :func:`..ops.riccati_kernel.riccati_cache_newton`; converges to the true
    DARE fixed point rather than the reference-truncated iterate),
    ``"vmap"`` (:func:`..precompute.riccati_cache_jax`, batched tensor
    code, on request only), or ``"auto"`` (the kernel for tensors on a CUDA
    device, batched tensor code for tensors on the CPU). The kernels take
    ``nx <= 16`` and ``nu <= 8`` and raise above that, under ``"auto"``
    too: pass ``riccati="vmap"`` for larger plants. On CPU tensors
    ``"kernel"``/``"newton"`` run the kernels' plain versions.
    """
    if getattr(settings, "alpha", 1.0) != 1.0:
        raise ValueError(
            "Settings.alpha is not implemented on the einsum adaptive tier "
            "(reference alpha=1 schedule)"
        )
    if refresh not in ("exact", "first_order", "cold"):
        raise ValueError(
            f"refresh must be 'exact', 'first_order' or 'cold', "
            f"got {refresh!r}"
        )
    if riccati not in ("auto", "kernel", "vmap", "newton"):
        raise ValueError(f"unknown riccati mode {riccati!r}")
    batch = x0.shape[0]
    nx, nu = A.shape[-1], B.shape[-1]
    N = problem.Xref.shape[-2]
    Dx, Du = N * nx, (N - 1) * nu
    chunk_settings = settings.replace(max_iter=chunk)
    first_order = refresh == "first_order"
    use_kernel = _use_kernel(riccati, A)
    Ab, Bb = A.expand(batch, nx, nx), B.expand(batch, nx, nu)
    Qb, Rb = Q.expand(batch, nx), R.expand(batch, nu)
    prob_b = problem.replace(A=Ab, B=Bb, Q=Qb, R=Rb)

    def build(rho, warm=None):
        if use_kernel:
            from ..ops.riccati_kernel import (
                riccati_cache_kernel, riccati_cache_newton,
            )

            if riccati == "newton" and warm is not None:
                caches = riccati_cache_newton(Ab, Bb, Qb, Rb, rho, warm.Kinf)
            else:
                caches = riccati_cache_kernel(
                    Ab, Bb, Qb, Rb, rho,
                    P0=warm.Pinf if warm is not None else None,
                    K0=warm.Kinf if warm is not None else None,
                )
        elif warm is None:
            caches = riccati_cache_jax(Ab, Bb, Qb, Rb, rho)
        else:
            caches = riccati_cache_jax(Ab, Bb, Qb, Rb, rho,
                                       P0=warm.Pinf, K0=warm.Kinf)
        return build_instance_ops(prob_b, caches), caches

    def build_sens(rho):
        """Operators at ``rho`` + d/drho by per-instance central differences
        (three builds; entry only -- recenters use the secant). Every field
        is differenced uniformly: rho-independent fields (bounds) cancel to
        zero (infinite bounds give NaN there and are kept as they are) and
        the ``rho`` field's derivative is exactly 1."""
        lo, _ = build(rho * (1.0 - fd_eps))
        hi, _ = build(rho * (1.0 + fd_eps))
        ops0, caches = build(rho)
        inv = 1.0 / (2.0 * fd_eps * rho)
        dops = _tmap(lambda h, l: torch.nan_to_num(
            (h - l) * _bcast(inv, h), nan=0.0), hi, lo)
        return ops0, dops, caches

    def axpy(ops0, dops, delta):
        return _tmap(lambda o, d: o + d * _bcast(delta, o), ops0, dops)

    def chunk_step(solved_in):
        nonlocal st
        nxt = solve_instance_ops(
            x0, st, ops, chunk_settings, cones=cones, dims=(nx, nu),
            cone_args=cone_args,
        )
        nxt = nxt._replace(
            iter=st.iter + nxt.iter,           # accumulate across rounds
            solved=nxt.solved | solved_in,
        )
        # Instances already solved in an earlier round stay frozen verbatim
        # (solve_instance_ops resets status at entry).
        st = _sel(solved_in, st, nxt)
        return (st.solved, torch.maximum(st.pri_s, st.pri_u),
                torch.maximum(st.dua_s, st.dua_u))

    def rescale_duals(scale):
        nonlocal st
        st = st._replace(Y=st.Y * scale[:, None], G=st.G * scale[:, None])

    def refresh_ops(new_rho, changed):
        nonlocal ops, ops0, dops, caches, center
        if first_order:
            outside = (new_rho > center * trust) | (new_rho * trust < center)
            if bool(outside.any()):
                ops_new, caches_new = build(new_rho, warm=caches)
                denom = new_rho - center
                inv = torch.where(denom.abs() > 1e-12, 1.0 / denom,
                                  torch.zeros_like(denom))
                dsec = _tmap(lambda n, o: torch.nan_to_num(
                    (n - o) * _bcast(inv, n), nan=0.0), ops_new, ops0)
                center = torch.where(outside, new_rho, center)
                ops0 = _sel(outside, ops_new, ops0)
                dops = _sel(outside, dsec, dops)
                caches = _sel(outside, caches_new, caches)
            ops = axpy(ops0, dops, new_rho - center)
        elif refresh == "cold":
            # Unconditional cold rebuild every round (the benchmark
            # reference point).
            ops, _ = build(new_rho)
        elif bool(changed.any()):
            ops_new, caches_new = build(new_rho, warm=caches)
            ops = _sel(changed, ops_new, ops)
            caches = _sel(changed, caches_new, caches)

    with torch.no_grad():
        st = OpsState.zeros(batch, Dx, Du, x0.dtype, x0.device)
        rho = rho0.to(x0.dtype).reshape(-1).expand(batch).contiguous()
        ops0 = dops = caches = center = None
        if first_order:
            ops, dops, caches = build_sens(rho)
            center, ops0 = rho, ops
        elif refresh == "cold":
            ops, _ = build(rho)
        else:
            ops, caches = build(rho)
        rho, _solved, rounds = adaptive_rounds(
            rho, max_rounds, chunk_step, rescale_duals, refresh_ops,
            adapt_factor=adapt_factor, stall_factor=stall_factor,
            rho_min=rho_min, rho_max=rho_max)
        _ops, caches = build(rho)
    return AdaptiveRhoBatchedResult(
        state=st, rho=rho, cache=caches, rounds=rounds, total_iter=st.iter
    )


def solve_adaptive_rho_chunked(
    x0: torch.Tensor,
    problem: Problem,
    A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
    rho0: torch.Tensor,
    settings: Settings,
    *,
    batch_chunk: int = 4096,
    cone_args=None,
    **kwargs: Any,
) -> AdaptiveRhoBatchedResult:
    """Host-chunked dispatch of :func:`solve_adaptive_rho_batched` for
    batches whose operators do not fit the device at once.

    The einsum tier materialises O(Du*Dx) condensed operators per instance
    (~13 kB at nx=12/nu=4/N=10, x3 transient sets inside a refresh round).
    This wrapper splits the batch into calls of at most ``batch_chunk``
    instances and concatenates the per-instance results (the tail chunk is
    simply shorter: nothing is compiled per shape here, so it is not
    padded).

    Semantics: instances adapt independently, instances solved in an earlier
    round are frozen verbatim, and an unconverged instance keeps its own
    chunk's round loop alive exactly as long as it would the full batch's --
    so chunking changes no instance's result beyond the reassociation of
    batched products. Only the scalar ``rounds`` diagnostic is chunk-local;
    it is returned as the max over chunks. ``cone_args`` / batch-leading
    ``problem`` fields / per-instance plants are sliced per chunk.
    """
    batch = x0.shape[0]
    if batch <= batch_chunk:
        return solve_adaptive_rho_batched(
            x0, problem, A, B, Q, R, rho0, settings,
            cone_args=cone_args, **kwargs,
        )

    def take(v, sl):
        if isinstance(v, torch.Tensor):
            return v[sl] if v.dim() >= 1 and v.shape[0] == batch else v
        if isinstance(v, Problem):
            return Problem(**{k: take(t, sl) for k, t in v.tensors().items()})
        if isinstance(v, (tuple, list)):
            return type(v)(take(e, sl) for e in v)
        return v

    parts = []
    for lo in range(0, batch, batch_chunk):
        sl = slice(lo, min(lo + batch_chunk, batch))
        parts.append(solve_adaptive_rho_batched(
            x0[sl], take(problem, sl), take(A, sl), take(B, sl), take(Q, sl),
            take(R, sl), rho0[sl], settings, cone_args=take(cone_args, sl),
            **kwargs,
        ))
    cat = lambda xs: torch.cat(xs, dim=0)
    return AdaptiveRhoBatchedResult(
        state=_tmap(lambda *xs: cat(xs), *[p.state for p in parts]),
        rho=cat([p.rho for p in parts]),
        cache=_tmap(lambda *xs: cat(xs), *[p.cache for p in parts]),
        rounds=max(p.rounds for p in parts),
        total_iter=cat([p.total_iter for p in parts]),
    )
