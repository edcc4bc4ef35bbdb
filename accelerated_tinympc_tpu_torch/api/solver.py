"""High-level solver API: the counterpart of the reference's setup + FFI
surface and of the JAX package's ``api/solver.py``.

The reference exposes ``tiny_codegen(nx, nu, N, A, B, Q, R, bounds, rho,
...)`` for offline setup (reference: src/tinympc/codegen.hpp:10-15) and a
flat setter/getter C API over a global solver (``set_x0``/``set_xref``/...
/``call_tiny_solve``/``get_x``/``get_u`` -- reference:
src/tinympc/tiny_wrapper.hpp:14-23). :class:`TinyMPC` covers both roles:
construction runs the Riccati precompute, setters update the held problem,
and ``solve`` dispatches to the execution tier (``scan`` | ``condensed`` |
``fused``).

Every constructor takes ``device=`` (default ``"cuda"``); nothing looks for
a GPU and carries on without one.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops.fused_admm import (
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


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"{where} of ROADMAP.md")


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
    algo: str = "f32"                 # fused-tier arithmetic; only "f32" yet
    # tier-internal precompute
    _ops: CondensedOperators | None = None
    _pp: PaddedProblem | None = None
    # mutable solve state
    state: State | None = None
    _fused_carry: FusedCarry | None = None
    _fused_result: Any = None

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
        **later,
    ) -> "TinyMPC":
        """Construct + precompute. Bounds default to +-inf (disabled in
        Settings when not provided, mirroring the reference's nullptr-enable
        logic, codegen.cpp:227-243); scalars broadcast over the horizon."""
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
            device=device, **later,
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
        polish: int | None = None,
        cones: Any = None,
        cone_mu=None,
        cone_shift=None,
        cone_mu_x=None,
        cone_shift_x=None,
        compaction_segment: int = 0,
        block: int = 32,
    ) -> "TinyMPC":
        """Bind a problem and its cache to a tier. ``problem``/``cache`` are
        moved to ``device``. What the port does not do yet raises
        ``NotImplementedError`` here, naming the ROADMAP slice that brings
        it."""
        if tier not in TIERS:
            raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
        if tier == "block":
            raise _later("tier='block' (block-condensed long horizons)",
                         "slice 10")
        if cones is not None or any(
                a is not None for a in
                (cone_mu, cone_shift, cone_mu_x, cone_shift_x)):
            raise _later("second-order cones (cones=, cone_*)", "slice 6")
        if compaction_segment:
            raise _later("the early-termination compaction cascade "
                         "(compaction_segment > 0)", "slice 7")
        if algo == "bf16x3" or polish is not None:
            raise _later(
                "algo='bf16x3'/polish (a TPU MXU arithmetic mode; its Hopper "
                "counterpart is a split-operand tensor-core mode)",
                "'Hopper arithmetic modes for K1-K3'")
        if algo != "f32":
            raise ValueError(f"unknown algo {algo!r}; use 'f32'")
        self = cls(
            problem=problem.to(device=device),
            cache=cache.to(device=device),
            settings=settings or Settings(),
            batch=batch,
            tier=tier,
            device=device,
            algo=algo,
        )
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
        fn = admm.solve if self.batch is None else solve_batched
        self.state = fn(self.state, self.problem, self.cache, self.settings)
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
        (:func:`..ops.fused_rollout.fused_rollout`).
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
                algo=self.algo, in_kernel=in_kernel,
                alpha=self.settings.alpha,
            )
            self._fused_carry = carry
            self.set_x0(xf[0] if single else xf)
            if single:
                return xf[0], us[:, 0]
            return xf, us
        if in_kernel:
            raise ValueError("in_kernel rollout requires tier='fused'")
        st, xf, trace = mpc_rollout(
            self.problem, self.cache, self.settings, x0, n_ticks,
            Xref_total=Xref_total, state=self.state, batched=not single,
        )
        self.state = st
        self.set_x0(xf)
        return xf, trace.u

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
        res = fused_solve(
            x0.contiguous(), self._fused_carry, self._pp,
            max_iter=self.settings.max_iter,
            check_termination=self.settings.check_termination,
            abs_pri_tol=float(self.settings.abs_pri_tol),
            abs_dua_tol=float(self.settings.abs_dua_tol),
            algo=self.algo, alpha=self.settings.alpha,
        )
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

    def solve_adaptive_rho(self, **kw) -> dict[str, Any]:
        """Solve with OSQP-style rho adaptation -- not ported yet."""
        raise _later("solve_adaptive_rho", "slice 7")

    # ------------------------------------------------------------ getters ----
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
