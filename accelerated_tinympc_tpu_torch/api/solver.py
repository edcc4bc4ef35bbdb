"""High-level solver API: the counterpart of the reference's setup + FFI
surface and of the JAX package's ``api/solver.py``.

The reference exposes ``tiny_codegen(nx, nu, N, A, B, Q, R, bounds, rho,
...)`` for offline setup (reference: src/tinympc/codegen.hpp:10-15) and a
flat setter/getter C API over a global solver (``set_x0``/``set_xref``/...
/``call_tiny_solve``/``get_x``/``get_u`` -- reference:
src/tinympc/tiny_wrapper.hpp:14-23). :class:`TinyMPC` covers both roles:
construction runs the Riccati precompute, setters update the held problem,
and ``solve`` dispatches to the execution tier (``scan`` | ``condensed`` |
``fused`` | ``block``).

Every constructor takes ``device=`` (default ``"cuda"``); nothing looks for
a GPU and carries on without one.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops.fused_admm import (
    ALGOS,
    FusedCarry,
    PaddedProblem,
    fused_solve,
    pad_problem,
    ref_vectors,
    unpad_states,
)
from ..precompute import CondensedOperators, condensed_operators, riccati_cache
from ..solver import admm
from ..solver.batched import batch_stats, init_state_batched, solve_batched
from ..types import (
    DEFAULT_DEVICE, Cache, Problem, Settings, State, init_state,
)

TIERS = ("scan", "condensed", "fused", "block")


@dataclasses.dataclass
class TinyMPC:
    """One MPC problem bound to a solver tier and (optional) batch.

    Build with :meth:`setup` (runs the DARE precompute like the reference's
    codegen math, src/tinympc/codegen.cpp:254-292) or :meth:`from_parts`
    with a shipped cache (reference problem_data headers).
    """

    problem: Problem
    cache: Cache
    settings: Settings
    batch: int | None = None          # None = single instance
    tier: str = "scan"
    device: Any = DEFAULT_DEVICE
    # Fused-tier arithmetic: "f32", or "bf16x3" (split-bf16 products on the
    # tensor cores, ops/fused_admm.fused_solve); stored on every tier, read
    # by the fused calls and the cascade (their default polish).
    algo: str = "f32"
    # Second-order-cone constraints (solver/cones.py) on every tier; the
    # fused tier projects inside the kernel (ops/fused_admm.pad_cones).
    cones: Any = None
    # Per-instance cone mu/shift overrides -- fused tier, batched: (nc, B)
    # tensors over the input/state cones (constraint-parameter sweeps; see
    # ops/fused_admm.fused_solve cone_mu_u).
    cone_mu: Any = None
    cone_shift: Any = None
    cone_mu_x: Any = None
    cone_shift_x: Any = None
    # Fused tier, adaptive mode: > 0 enables the early-termination compaction
    # cascade (solver/cascade.py) with this segment length (must be a
    # multiple of check_termination). 0 = one monolithic adaptive call.
    compaction_segment: int = 0
    # Block-condensed tier (tier="block"): knots per dense block, the
    # shared-plant long-horizon tier (solver/block_condensed.py).
    block: int = 32
    # tier-internal precompute
    _ops: CondensedOperators | None = None
    _pp: PaddedProblem | None = None
    _cone_ops: Any = None
    _block_sweeps: Any = None
    # mutable solve state
    state: State | None = None
    _fused_carry: FusedCarry | None = None
    _fused_result: Any = None
    _adaptive_rho_result: Any = None

    # ------------------------------------------------------------- setup ----
    @classmethod
    def setup(
        cls,
        A: np.ndarray,
        B: np.ndarray,
        Q: np.ndarray,
        R: np.ndarray,
        rho: float,
        horizon: int,
        *,
        x_min: np.ndarray | float | None = None,
        x_max: np.ndarray | float | None = None,
        u_min: np.ndarray | float | None = None,
        u_max: np.ndarray | float | None = None,
        settings: Settings | None = None,
        batch: int | None = None,
        tier: str = "scan",
        dtype: Any = torch.float32,
        device: Any = DEFAULT_DEVICE,
        **options,
    ) -> "TinyMPC":
        """Construct + precompute. Bounds default to +-inf (disabled in
        Settings when not provided, mirroring the reference's nullptr-enable
        logic, codegen.cpp:227-243); scalars broadcast over the horizon.
        ``options`` (``cones``, ``cone_mu``, ..., ``compaction_segment``,
        ``algo``, ``block``) go to :meth:`from_parts`."""
        A = np.asarray(A, np.float64)
        Bm = np.asarray(B, np.float64)
        nx, nu = Bm.shape
        N, m = horizon, horizon - 1

        def expand(val, default, shape):
            if val is None:
                return np.full(shape, default)
            val = np.asarray(val, np.float64)
            if val.ndim <= 1:
                return np.broadcast_to(val, shape).copy()
            return val

        t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
            device=device, dtype=dtype)
        en_input = u_min is not None and u_max is not None
        en_state = x_min is not None and x_max is not None
        problem = Problem(
            A=t(A), B=t(Bm), Q=t(Q), R=t(R),
            u_min=t(expand(u_min, -np.inf, (m, nu))),
            u_max=t(expand(u_max, np.inf, (m, nu))),
            x_min=t(expand(x_min, -np.inf, (N, nx))),
            x_max=t(expand(x_max, np.inf, (N, nx))),
            Xref=t(np.zeros((N, nx))),
            Uref=t(np.zeros((m, nu))),
        )
        cache = riccati_cache(A, Bm, Q, R, rho, dtype=dtype, device=device)
        settings = (settings or Settings()).replace(
            en_input_bound=en_input, en_state_bound=en_state)
        return cls.from_parts(
            problem, cache, settings=settings, batch=batch, tier=tier,
            device=device, **options,
        )

    @classmethod
    def from_parts(
        cls,
        problem: Problem,
        cache: Cache,
        *,
        settings: Settings | None = None,
        batch: int | None = None,
        tier: str = "scan",
        device: Any = DEFAULT_DEVICE,
        algo: str = "f32",
        cones: Any = None,
        cone_mu=None,
        cone_shift=None,
        cone_mu_x=None,
        cone_shift_x=None,
        compaction_segment: int = 0,
        block: int = 32,
    ) -> "TinyMPC":
        """Bind a problem and its cache to a tier. ``problem``/``cache`` are
        moved to ``device``. ``cones`` (:class:`..solver.cones.ConeSet`) adds second-order
        cones on every tier; ``cone_mu``/``cone_shift``/``cone_mu_x``/
        ``cone_shift_x`` (``(n_cones, batch)``) override their parameters
        per instance on the batched fused tier; ``compaction_segment > 0``
        runs adaptive fused solves through the compaction cascade.
        ``block`` is the knots per dense block of ``tier="block"``.
        ``algo`` (``"f32"`` or ``"bf16x3"``) is the fused tier's arithmetic
        (:func:`..ops.fused_admm.fused_solve`); every tier takes it, and
        only the fused calls read it. As in the JAX package there is no
        ``polish`` here: the fused calls run the default."""
        if tier not in TIERS:
            raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
        has_cp = any(a is not None for a in
                     (cone_mu, cone_shift, cone_mu_x, cone_shift_x))
        if has_cp:
            if cones is None:
                raise ValueError("per-instance cone parameters override a "
                                 "base ConeSet -- pass cones= as well")
            if tier != "fused" or batch is None:
                raise ValueError("per-instance cone parameters need the "
                                 "batched fused tier (tier='fused', batch=B)")
        if algo not in ALGOS:
            raise ValueError(
                f"unknown algo {algo!r}; use one of {ALGOS}")
        self = cls(
            problem=problem.to(device=device),
            cache=cache.to(device=device),
            settings=settings or Settings(),
            batch=batch,
            tier=tier,
            device=device,
            algo=algo,
            cones=cones,
            compaction_segment=compaction_segment,
            block=block,
        )
        rows = lambda a: None if a is None else torch.as_tensor(a).to(
            device=device, dtype=self._dtype)
        self.cone_mu, self.cone_shift = rows(cone_mu), rows(cone_shift)
        self.cone_mu_x, self.cone_shift_x = rows(cone_mu_x), rows(cone_shift_x)
        self._reset_state()
        return self

    @property
    def _dtype(self):
        return self.problem.A.dtype

    def _reset_state(self) -> None:
        nx, nu, N = self.problem.nx, self.problem.nu, self.problem.horizon
        if self.batch is None:
            self.state = init_state(nx, nu, N, self._dtype, self.device)
        else:
            self.state = init_state_batched(
                self.batch, nx, nu, N, self._dtype, self.device)
        if self.tier == "fused":
            self._build_fused()
            self._fused_carry = FusedCarry.zeros(
                self.batch or 1, self._pp, self._dtype, self.device)

    def _ensure_ops(self) -> CondensedOperators:
        if self._ops is None:
            self._ops = condensed_operators(
                self.cache, self.problem.A, self.problem.B,
                self.problem.horizon, dtype=self._dtype, device=self.device,
            )
        return self._ops

    def _bounded_problem(self) -> Problem:
        """Problem with disabled bound sets neutralized (the fused kernel
        clips unconditionally; scan/condensed honor the Settings flags --
        reference: src/tinympc/types.hpp:44-45 en_*_bound)."""
        prob = self.problem
        inf = float("inf")
        if not self.settings.en_input_bound:
            prob = prob.replace(
                u_min=torch.full_like(prob.u_min, -inf),
                u_max=torch.full_like(prob.u_max, inf),
            )
        if not self.settings.en_state_bound:
            prob = prob.replace(
                x_min=torch.full_like(prob.x_min, -inf),
                x_max=torch.full_like(prob.x_max, inf),
            )
        return prob

    def _build_fused(self) -> None:
        self._pp = pad_problem(
            self._bounded_problem(), self.cache, self._ensure_ops(),
            dtype=self._dtype, device=self.device,
        )
        self._cone_ops = None
        if self.cones is not None and (
            self.cones.input_cones or self.cones.state_cones
        ):
            from ..ops.fused_admm import pad_cones

            self._cone_ops = pad_cones(self._pp, self.cones)

    def _project(self):
        """The slack projection of the scan tier: box clip, then cones."""
        if self.cones is None:
            return None
        from ..solver.cones import cone_slack_update

        return cone_slack_update(self.cones)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=self._dtype)

    # ----------------------------------------------------------- setters ----
    # Counterparts of the reference FFI setters
    # (reference: src/tinympc/tiny_wrapper.cpp:5-129).

    def set_x0(self, x0) -> None:
        """Measurement injection (reference: tiny_wrapper.cpp:5-19). For a
        batched solver x0 is (batch, nx)."""
        x = self.state.x.clone()
        x[..., 0, :] = self._tensor(x0)
        self.state = self.state.replace(x=x)

    def set_xref(self, Xref) -> None:
        """Reference window update (reference: tiny_wrapper.cpp:21-41);
        refreshes the fused tier's baked reference vectors."""
        Xref = self._tensor(Xref)
        self.problem = self.problem.replace(Xref=Xref)
        if self.tier == "fused":
            xref_q, pterm_c = ref_vectors(
                self._pp, self.problem.Q, self.cache.Pinf, Xref)
            self._pp = self._pp.replace(xref_q=xref_q, pterm_c=pterm_c)

    def set_bounds(self, u_min=None, u_max=None, x_min=None, x_max=None) -> None:
        """Box-bound updates (reference: tiny_wrapper.cpp:43-129). Providing
        a complete bound pair enables the corresponding constraint set
        (mirroring the reference's non-null enable logic,
        codegen.cpp:227-243) so every tier starts clipping."""
        rep = {}
        for name, val in (("u_min", u_min), ("u_max", u_max),
                          ("x_min", x_min), ("x_max", x_max)):
            if val is not None:
                cur = getattr(self.problem, name)
                rep[name] = self._tensor(val).broadcast_to(cur.shape).clone()
        self.problem = self.problem.replace(**rep)
        if u_min is not None and u_max is not None:
            self.settings = self.settings.replace(en_input_bound=True)
        if x_min is not None and x_max is not None:
            self.settings = self.settings.replace(en_state_bound=True)
        if self.tier == "fused" and rep:
            self._build_fused()

    def reset_duals(self) -> None:
        """Zero y/g between MPC ticks (reference: tiny_wrapper.cpp:131-140)."""
        self.state = self.state.replace(
            y=torch.zeros_like(self.state.y), g=torch.zeros_like(self.state.g)
        )
        if self._fused_carry is not None:
            self._fused_carry = self._fused_carry.reset_duals()

    # ------------------------------------------------------------- solve ----
    def _state_stats(self) -> dict[str, Any]:
        if self.batch is None:
            return {
                "iterations": int(self.state.iter),
                "solved": bool(self.state.status == 1),
            }
        return {
            k: v.cpu().numpy() for k, v in
            batch_stats(self.state, self.settings).items()
        }

    def solve(self) -> dict[str, Any]:
        """Run the solver on the current state (reference:
        tiny_wrapper.cpp:142-150 ``call_tiny_solve``). Returns a stats dict;
        results via :meth:`get_u`/:meth:`get_x`."""
        if self.tier == "fused":
            return self._solve_fused()
        if self.tier == "condensed":
            return self._solve_condensed()
        if self.tier == "block":
            return self._solve_block()
        fn = admm.solve if self.batch is None else solve_batched
        self.state = fn(self.state, self.problem, self.cache, self.settings,
                        project=self._project())
        return self._state_stats()

    def rollout(
        self,
        n_ticks: int,
        *,
        Xref_total=None,
        in_kernel: bool = False,
    ):
        """Run ``n_ticks`` of the reference's receding-horizon loop from the
        current ``x0`` (reference: examples/quadrotor_hovering.cpp:90-114 --
        dual reset, warm-started solve, pre-projection u0 applied, plant
        step; tracking with ``Xref_total`` slides the window per tick,
        quadrotor_tracking.cpp:101). Uses this object's settings
        (``max_iter``/``check_termination``/tolerances) per tick.

        Returns ``(x_final, us)`` with the leading batch axis dropped for
        single-instance solvers; the solver's warm-start state advances to
        the end of the rollout (continuations compose). On the fused tier
        ``in_kernel=True`` runs the whole mission inside one kernel launch
        (:func:`..ops.fused_rollout.fused_rollout`), cones included.
        """
        from .mpc import fused_mpc_rollout, mpc_rollout

        single = self.batch is None
        x0 = self.state.x[..., 0, :]
        if Xref_total is not None:
            Xref_total = self._tensor(Xref_total)
        if self.tier == "fused":
            if single:
                x0 = x0[None]
            xf, us, carry = fused_mpc_rollout(
                self._pp, x0.contiguous(), n_ticks, problem=self.problem,
                max_iter=self.settings.max_iter,
                check_termination=self.settings.check_termination,
                abs_pri_tol=float(self.settings.abs_pri_tol),
                abs_dua_tol=float(self.settings.abs_dua_tol),
                carry=self._fused_carry,
                Xref_total=Xref_total,
                Pinf=self.cache.Pinf if Xref_total is not None else None,
                cone_ops=self._cone_ops, algo=self.algo, in_kernel=in_kernel,
                alpha=self.settings.alpha,
            )
            self._fused_carry = carry
            self.set_x0(xf[0] if single else xf)
            if single:
                return xf[0], us[:, 0]
            return xf, us
        if in_kernel:
            raise ValueError("in_kernel rollout requires tier='fused'")
        if self.cones is not None:
            raise ValueError(
                "rollout with cones is supported on tier='fused' "
                "(in-kernel cone projection); scan-tier coned rollouts: "
                "drive the tick loop with solve()/reset_duals()")
        solver = None
        if self.tier == "block":
            # Long-horizon missions: block-condensed sweeps per tick
            # (scan-tier semantics; solver/block_condensed.py).
            fwd, bwd = self._ensure_block_sweeps()
            fn = admm.solve if single else solve_batched
            solver = lambda s, p: fn(s, p, self.cache, self.settings,
                                     forward=fwd, backward=bwd)
        st, xf, trace = mpc_rollout(
            self.problem, self.cache, self.settings, x0, n_ticks,
            Xref_total=Xref_total, state=self.state, batched=not single,
            solver=solver,
        )
        self.state = st
        self.set_x0(xf)
        return xf, trace.u

    def _ensure_block_sweeps(self):
        """The block tier's sweep overrides, built once from the cache (the
        dense block operators bake Kinf, AmBKt and Quu_inv)."""
        if self._block_sweeps is None:
            from ..solver.block_condensed import block_sweeps

            self._block_sweeps = block_sweeps(
                self.cache, self.problem.A, self.problem.B,
                self.problem.horizon, self.block)
        return self._block_sweeps

    def _solve_block(self) -> dict[str, Any]:
        """Block-condensed long-horizon sweeps (solver/block_condensed.py):
        scan-tier semantics, per-block dense products -- the shared-plant
        long-horizon tier."""
        fwd, bwd = self._ensure_block_sweeps()
        fn = admm.solve if self.batch is None else solve_batched
        self.state = fn(self.state, self.problem, self.cache, self.settings,
                        project=self._project(), forward=fwd, backward=bwd)
        return self._state_stats()

    def _solve_condensed(self) -> dict[str, Any]:
        from ..solver.condensed import (
            flat_from_state, flatten_problem, solve_condensed,
            state_from_flat,
        )

        ops = self._ensure_ops()
        nx, nu, N = self.problem.nx, self.problem.nu, self.problem.horizon
        state = self.state
        single = self.batch is None
        if single:
            state = State(**{k: a[None] for k, a in state.tensors().items()})
        out = solve_condensed(
            flat_from_state(state, nx, nu),
            flatten_problem(self.problem, self.cache), ops, self.settings, nx,
            cones=self.cones, nu=nu if self.cones else None,
        )
        state = state_from_flat(out, nx, nu, N)
        if single:
            state = State(**{k: a[0] for k, a in state.tensors().items()})
        self.state = state
        return self._state_stats()

    def _solve_fused(self) -> dict[str, Any]:
        x0 = self.state.x[..., 0, :]
        if self.batch is None:
            x0 = x0[None]
        kw = dict(
            max_iter=self.settings.max_iter,
            check_termination=self.settings.check_termination,
            abs_pri_tol=float(self.settings.abs_pri_tol),
            abs_dua_tol=float(self.settings.abs_dua_tol),
            algo=self.algo, alpha=self.settings.alpha,
            cone_ops=self._cone_ops,
            cone_mu_u=self.cone_mu, cone_shift_u=self.cone_shift,
            cone_mu_x=self.cone_mu_x, cone_shift_x=self.cone_shift_x,
        )
        if self.compaction_segment and self.settings.check_termination > 0:
            from ..solver.cascade import cascade_solve

            res = cascade_solve(
                x0.contiguous(), self._fused_carry, self._pp,
                segment_iters=self.compaction_segment, **kw)
        else:
            res = fused_solve(
                x0.contiguous(), self._fused_carry, self._pp, **kw)
        self._fused_carry = res.carry
        self._fused_result = res
        stats = res.stats.cpu().numpy()
        # Residual columns are valid in both modes; the solved flag is
        # tracked only in adaptive mode (check_termination > 0).
        return {
            "iterations_mean": float(stats[:, 0].mean()),
            "converged_fraction": float(stats[:, 1].mean()),
            "iterations": stats[:, 0].astype(np.int64),
            "solved": stats[:, 1] > 0.5,
            "primal_residual_state_max": float(stats[:, 2].max()),
            "dual_residual_state_max": float(stats[:, 3].max()),
            "primal_residual_input_max": float(stats[:, 4].max()),
            "dual_residual_input_max": float(stats[:, 5].max()),
        }

    def solve_adaptive_rho(self, *, rho0=None, **kw) -> dict[str, Any]:
        """Solve with OSQP-style stall-guarded rho adaptation (beyond the
        reference, which bakes rho at build time -- codegen.cpp:254-258).

        Single instance: runs :func:`..solver.adaptive_rho.solve_adaptive_rho`
        and adopts the adapted cache for subsequent solves. Batched: runs the
        per-instance form on the device
        (:func:`..solver.batched_ops.solve_adaptive_rho_batched`) with this
        solver's plant expanded over the batch; per-instance rho/iters are
        returned in the stats dict, the iterates and caches by
        :attr:`adaptive_rho_result`. ``rho0 (batch,)`` (batched only) starts
        each instance at its own penalty in place of the cache's. Keyword
        args pass through (chunk, adapt_factor, rho_min/max, riccati, ...).
        """
        from ..solver.adaptive_rho import solve_adaptive_rho
        from ..solver.batched_ops import solve_adaptive_rho_batched

        if self.batch is None:
            if rho0 is not None:
                raise ValueError("rho0 is per instance: it needs batch=B")
            res = solve_adaptive_rho(
                self.state, self._bounded_problem(), self.cache,
                self.settings, **kw,
            )
            self.state = res.state
            self.cache = res.cache
            self._ops = None  # the condensed operators bake the cache
            self._block_sweeps = None  # so do the block operators
            if self.tier == "fused":
                self._build_fused()
            return {
                "rho": res.rho,
                "iterations": res.iterations,
                "solved": res.converged,
                "rho_history": res.rho_history,
            }

        B = self.batch
        prob = self._bounded_problem()
        bcast = lambda a: a.expand((B,) + tuple(a.shape))
        prob_b = Problem(**{k: bcast(v) for k, v in prob.tensors().items()})
        if rho0 is None:
            rho0 = torch.full((B,), float(self.cache.rho), dtype=self._dtype,
                              device=self.device)
        else:
            rho0 = self._tensor(rho0).reshape(B)
        res = solve_adaptive_rho_batched(
            self.state.x[:, 0, :], prob_b,
            prob_b.A, prob_b.B, prob_b.Q, prob_b.R,
            rho0, self.settings, **kw,
        )
        self._adaptive_rho_result = res
        solved = res.state.solved
        return {
            "rho": res.rho.cpu().numpy(),
            "iterations": res.total_iter.cpu().numpy(),
            "solved": solved.cpu().numpy(),
            "rounds": int(res.rounds),
            "converged_fraction": float(solved.to(torch.float32).mean()),
        }

    # ------------------------------------------------------------ getters ----
    @property
    def adaptive_rho_result(self):
        """What the last batched :meth:`solve_adaptive_rho` returned
        (:class:`..solver.batched_ops.AdaptiveRhoBatchedResult`: iterates,
        per-instance rho, caches at the final rho), or None."""
        return self._adaptive_rho_result

    def get_slacks(self) -> tuple[np.ndarray, np.ndarray]:
        """The newest projected slacks ``(z, v)``: input slack ``(N-1, nu)``
        and state slack ``(N, nx)``, batch-leading for a batched solver.
        They satisfy the box bounds and every cone exactly. On the fused
        tier they follow :meth:`rollout` as well as :meth:`solve`."""
        if self.tier == "fused":
            nx, nu, N = self._pp.dims
            z = self._fused_carry.Z.cpu().numpy().reshape(-1, N - 1, nu)
            v = self._fused_carry.V.cpu().numpy().reshape(-1, N, nx)
            return (z[0], v[0]) if self.batch is None else (z, v)
        return self.state.znew.cpu().numpy(), self.state.vnew.cpu().numpy()

    def get_u(self) -> np.ndarray:
        """Control trajectory (reference: tiny_wrapper.cpp:165-176). Shape
        (N-1, nu) or (batch, N-1, nu)."""
        if self.tier == "fused" and self._fused_result is not None:
            _nx, nu, N = self._pp.dims
            u = self._fused_result.U.cpu().numpy().reshape(-1, N - 1, nu)
            return u[0] if self.batch is None else u
        return self.state.u.cpu().numpy()

    def get_x(self) -> np.ndarray:
        """State trajectory (reference: tiny_wrapper.cpp:152-163)."""
        if self.tier == "fused" and self._fused_result is not None:
            x = unpad_states(self._fused_result, self._pp).cpu().numpy()
            return x[0] if self.batch is None else x
        return self.state.x.cpu().numpy()
