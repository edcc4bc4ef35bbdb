"""Fleet API: one MPC problem per instance.

Counterpart of the JAX package's ``api/fleet.py``. The reference binds one
problem per process (global workspace, reference:
src/tinympc/tiny_wrapper.hpp:6). :class:`TinyMPCFleet` solves thousands of
*distinct* plants (and penalties) at once behind the setter/getter surface
of :class:`.solver.TinyMPC`:

* tier ``"hetero"`` (default): the heterogeneous-plant kernels
  (:mod:`..ops.hetero_admm`, K7 fixed / K8 adaptive), cones with
  per-instance parameters and geometry, and the compaction cascade
  (:func:`..solver.cascade.hetero_cascade_solve`);
* tier ``"instance_ops"``: the per-instance-operator tier
  (:mod:`..solver.batched_ops`), the same semantics in batched tensor code;
* tier ``"scan"``: the scan-tier sweeps with per-instance plants
  (:func:`..solver.batched.solve_batched` with ``problem_axes=BATCHED``),
  any horizon and any nx;
* tier ``"hstream"``: the long-horizon kernels with per-instance plants
  (:mod:`..ops.hstream_admm`, K11 fixed / K12 adaptive), cones with
  per-instance parameters and geometry, and its compaction cascade
  (:func:`..solver.cascade.hstream_cascade_solve`);
* tier ``"block"``: per-instance block-condensed sweeps
  (:func:`..solver.block_condensed.solve_block_batched`; every instance's
  dense block operators are read each iteration, so it pays only where the
  plant is shared: ``TinyMPC(tier="block")``).

``mesh=`` raises until the multi-GPU slice (ROADMAP.md slice 11).

Caches are built on the device by the Riccati kernels
(:mod:`..ops.riccati_kernel`, K5 fixed point, K6 Newton-Kleinman) at any
plant size whose working set fits a block's shared memory (on CPU tensors
the kernels' plain versions). ``host_precompute=True`` runs
the reference's float64 host path per instance (reference:
examples/codegen_cartpole.cpp:9-11). Every tensor lives on ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops import riccati_kernel as rk
from ..types import DEFAULT_DEVICE, Cache, Problem, Settings

FLEET_TIERS = ("hetero", "instance_ops", "hstream", "block", "scan")


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"{where} of ROADMAP.md")


def _stack_caches(caches) -> Cache:
    return Cache(**{k: torch.stack([getattr(c, k) for c in caches])
                    for k in caches[0].tensors()})


def _select_caches(bad: torch.Tensor, on_bad: Cache, other: Cache) -> Cache:
    return Cache(**{
        k: torch.where(bad.reshape((-1,) + (1,) * (v.dim() - 1)),
                       getattr(on_bad, k), v)
        for k, v in other.tensors().items()})


def _nonfinite_rows(cache: Cache) -> torch.Tensor:
    """Instances with a non-finite entry in any cache field."""
    return ~torch.stack([
        torch.isfinite(v.reshape(v.shape[0], -1)).all(dim=1)
        for v in cache.tensors().values()]).all(dim=0)


@dataclasses.dataclass
class TinyMPCFleet:
    """A batch of independent MPC problems, one plant per instance."""

    problem: Problem            # batch-leading fields
    cache: Cache                # batch-leading caches
    settings: Settings
    tier: str = "hetero"
    device: Any = DEFAULT_DEVICE
    cones: Any = None
    # Per-instance cone parameters (B, nc, 2) and geometry masks (B, MR) of
    # the hetero tier (ops.hetero_admm.pad_hetero_cone_params / _masks).
    cone_params: Any = None
    cone_masks: Any = None
    # The same overrides for the instance-ops tier and the einsum adaptive
    # loop (solver.cones.make_cone_args), built from the same user inputs.
    cone_args: Any = None
    # Hetero and hstream tiers, adaptive mode: > 0 runs the compaction
    # cascade with this segment length (hetero: a multiple of
    # check_termination; hstream: rounded up to one).
    compaction_segment: int = 0
    # tier="block": knots per dense block (solver/block_condensed.py).
    block: int = 16
    # Instances whose Newton refresh in the last set_plants fell back to the
    # warm fixed point.
    fallback_count: int = 0
    # internals
    _hp: Any = None
    _ops: Any = None
    _carry: Any = None
    _x0: Any = None
    _last: Any = None

    # ------------------------------------------------------------- setup ----
    @classmethod
    def setup(
        cls,
        A, B, Q, R, rho, horizon: int,
        *,
        x_min=None, x_max=None, u_min=None, u_max=None,
        settings: Settings | None = None,
        tier: str = "hetero",
        cones: Any = None,
        cone_mu=None,
        cone_shift=None,
        cone_ball=None,
        cone_axis=None,
        compaction_segment: int = 0,
        host_precompute: bool = False,
        polish: bool = True,
        device: Any = DEFAULT_DEVICE,
        mesh: Any = None,
        block: int = 16,
    ) -> "TinyMPCFleet":
        """Construct from per-instance plants: ``A (B, nx, nx)``,
        ``B (B, nx, nu)``, ``Q (B, nx)`` / ``R (B, nu)`` raw cost diagonals
        (share a plant by stacking), ``rho`` scalar or ``(B,)``. Bounds are
        scalars or per-instance ``(B, k)`` arrays, enabled iff given (the
        reference's nullptr-enable logic, codegen.cpp:227-243).

        ``polish=True`` (default) refines the device-built float32 caches in
        float64 (:func:`..precompute.riccati_polish_f64`), so fleet controls
        match float64-cache-driven controls within the 1e-4 bar; False keeps
        the raw float32 caches (setup latency over precision).

        ``cones`` adds static SOC constraints; ``cone_mu``/``cone_shift``
        (``(n_input_cones, B)``) override their parameters per instance and
        ``cone_ball``/``cone_axis`` (lists of ``(B, nu)`` 0/1 membership /
        ``(B,)`` axis indices per input cone) their geometry, on the
        hetero, hstream and instance-ops tiers. ``block`` is the knots per
        dense block of ``tier="block"``."""
        if tier not in FLEET_TIERS:
            raise ValueError(f"tier must be one of {FLEET_TIERS}")
        if mesh is not None:
            raise _later("mesh= (batch sharding over several GPUs)",
                         "slice 11")
        t = lambda a: torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a).to(device=device, dtype=torch.float32)
        A, Bm, Q, R = t(A), t(B), t(Q), t(R)
        Bn, nx, nu = Bm.shape
        N, m = horizon, horizon - 1
        rho_b = t(rho).reshape(-1).expand(Bn).contiguous()

        def expand(v, default, knots, k):
            if v is None:
                return torch.full((Bn, knots, k), default, dtype=torch.float32,
                                  device=device)
            v = t(v)
            if v.dim() == 2:  # (B, k) per-instance, time-uniform
                v = v[:, None, :]
            return v.expand(Bn, knots, k).contiguous()

        en_input = u_min is not None and u_max is not None
        en_state = x_min is not None and x_max is not None
        problem = Problem(
            A=A, B=Bm, Q=Q, R=R,
            u_min=expand(u_min, -float("inf"), m, nu),
            u_max=expand(u_max, float("inf"), m, nu),
            x_min=expand(x_min, -float("inf"), N, nx),
            x_max=expand(x_max, float("inf"), N, nx),
            Xref=torch.zeros((Bn, N, nx), device=device),
            Uref=torch.zeros((Bn, m, nu), device=device),
        )
        if host_precompute:
            from ..precompute import riccati_cache

            cache = _stack_caches([
                riccati_cache(A[b], Bm[b], Q[b], R[b], float(rho_b[b]),
                              device=device)
                for b in range(Bn)])
        else:
            cache = rk.riccati_cache_kernel(A, Bm, Q, R, rho_b)
        if polish and not host_precompute:
            from ..precompute import riccati_polish_f64

            cache = riccati_polish_f64(cache, A, Bm, Q, R, rho_b)
        settings = (settings or Settings()).replace(
            en_input_bound=en_input, en_state_bound=en_state)
        has_ci = any(a is not None for a in
                     (cone_mu, cone_shift, cone_ball, cone_axis))
        if has_ci and cones is None:
            raise ValueError(
                "cone_mu/cone_shift/cone_ball/cone_axis override a base "
                "ConeSet -- pass cones= as well")
        cone_params = cone_masks = cone_args = None
        if has_ci:
            from ..solver.cones import make_cone_args

            cone_args = make_cone_args(
                cones, Bn, nx, nu, mu_u=cone_mu, shift_u=cone_shift,
                ball_u=cone_ball, axis_u=cone_axis, device=device)
        if has_ci and tier in ("hetero", "hstream"):
            from ..ops.hetero_admm import (
                pad_hetero_cone_masks, pad_hetero_cone_params,
            )

            if cone_mu is not None or cone_shift is not None:
                cone_params = pad_hetero_cone_params(
                    cones, Bn, mu_u=cone_mu, shift_u=cone_shift,
                    device=device)
            if cone_ball is not None or cone_axis is not None:
                cone_masks = pad_hetero_cone_masks(
                    cones, Bn, nx, nu, ball_u=cone_ball, axis_u=cone_axis,
                    device=device)
        self = cls(
            problem=problem, cache=cache, settings=settings, tier=tier,
            device=device, cones=cones, cone_params=cone_params,
            cone_masks=cone_masks, cone_args=cone_args,
            compaction_segment=compaction_segment, block=block,
        )
        self._build()
        return self

    def _build(self) -> None:
        nx, nu, N = self.dims
        if self.tier == "hetero":
            from ..ops.hetero_admm import HeteroCarry, pad_hetero_problem

            self._hp = pad_hetero_problem(self.problem, self.cache)
            self._carry = HeteroCarry.zeros(self._hp)
        elif self.tier == "hstream":
            from ..ops.hstream_admm import (
                hstream_carry_zeros, pad_hstream_problem,
            )

            self._hp = pad_hstream_problem(self.problem, self.cache)
            self._carry = hstream_carry_zeros(self.batch, self._hp)
        elif self.tier == "block":
            from ..solver.batched import init_state_batched
            from ..solver.block_condensed import block_ops_batched

            self._ops = block_ops_batched(
                self.cache, self.problem.A, self.problem.B, N, self.block)
            self._carry = init_state_batched(
                self.batch, nx, nu, N, device=self.device)
        elif self.tier == "scan":
            from ..solver.batched import init_state_batched

            self._carry = init_state_batched(
                self.batch, nx, nu, N, device=self.device)
        else:
            from ..solver.batched_ops import OpsState, build_instance_ops

            self._ops = build_instance_ops(self.problem, self.cache)
            self._carry = OpsState.zeros(self.batch, N * nx, (N - 1) * nu,
                                         device=self.device)

    # ----------------------------------------------------------- surface ----
    @property
    def batch(self) -> int:
        return self.problem.A.shape[0]

    @property
    def dims(self) -> tuple:
        return (self.problem.A.shape[-1], self.problem.B.shape[-1],
                self.problem.Xref.shape[-2])

    def _tensor(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(device=self.device, dtype=torch.float32)

    def set_x0(self, x0s) -> None:
        """Per-instance measurements ``(B, nx)``."""
        x0s = self._tensor(x0s)
        if tuple(x0s.shape) != (self.batch, self.dims[0]):
            raise ValueError(f"x0s shape {tuple(x0s.shape)} != "
                             f"({self.batch}, {self.dims[0]})")
        self._x0 = x0s.contiguous()

    def reset_duals(self) -> None:
        """Re-solve protocol: duals zeroed, slacks kept (reference:
        examples/quadrotor_hovering.cpp:99-104)."""
        if self.tier in ("scan", "block"):
            from ..types import reset_duals

            self._carry = reset_duals(self._carry)
        else:
            self._carry = self._carry.reset_duals()

    def set_bounds(self, u_min=None, u_max=None, x_min=None,
                   x_max=None) -> None:
        """Runtime bound updates (reference FFI set_umin/set_umax/...,
        tiny_wrapper.cpp:43-129): scalars, shared ``(knots, k)``, or
        per-instance ``(B, knots, k)`` arrays; ``(B, k)`` is per-instance
        and time-uniform (it wins where the shape is ambiguous). A complete
        pair enables that constraint set. Carries survive the rebuild."""
        nx, nu, N = self.dims

        def expand(v, knots, k):
            v = self._tensor(v)
            if v.dim() == 2:
                if v.shape[0] == self.batch and v.shape[1] == k:
                    v = v[:, None, :]
                else:
                    v = v[None]
            return v.expand(self.batch, knots, k).contiguous()

        upd = {}
        if u_min is not None and u_max is not None:
            upd["u_min"] = expand(u_min, N - 1, nu)
            upd["u_max"] = expand(u_max, N - 1, nu)
            self.settings = self.settings.replace(en_input_bound=True)
        if x_min is not None and x_max is not None:
            upd["x_min"] = expand(x_min, N, nx)
            upd["x_max"] = expand(x_max, N, nx)
            self.settings = self.settings.replace(en_state_bound=True)
        if not upd:
            return
        self.problem = self.problem.replace(**upd)
        carry = self._carry
        self._build()
        self._carry = carry

    def _fixed_point_cache(self, rho_b) -> Cache:
        """The warm fixed point from the current caches (K5)."""
        p = self.problem
        return rk.riccati_cache_kernel(p.A, p.B, p.Q, p.R, rho_b,
                                       P0=self.cache.Pinf, K0=self.cache.Kinf)

    def set_plants(self, A=None, B=None, Q=None, R=None, *,
                   refresh: str = "newton", polish: bool = False) -> None:
        """Online model update: replace per-instance dynamics and/or cost
        diagonals and refresh every Riccati cache on the device -- the
        system-identification / drifting-plant serving loop (no reference
        analogue: the reference bakes one plant at codegen time,
        codegen.cpp:245-292).

        ``refresh="newton"`` warm-starts Newton-Kleinman from the current
        gains (K6 for plants the Riccati kernels take, the batched
        :func:`..precompute.riccati_newton_jax` above). Newton needs the
        updated plant to be stabilised by the old gain; instances where the
        drift broke that (a non-finite value in any cache field) fall back
        to the warm fixed point, so any drift is safe and only the speed
        degrades. ``"kernel"`` always uses the warm fixed point.
        ``polish=True`` adds the float64 refinement. Carries are reset."""
        if refresh not in ("newton", "kernel"):
            raise ValueError(
                f"refresh must be 'newton' or 'kernel', got {refresh!r}")
        upd = {k: self._tensor(v) for k, v in
               (("A", A), ("B", B), ("Q", Q), ("R", R)) if v is not None}
        if not upd:
            return
        self.problem = self.problem.replace(**upd)
        p = self.problem
        rho_b = self.cache.rho.to(torch.float32).reshape(-1).expand(
            self.batch).contiguous()
        self.fallback_count = 0
        if refresh == "newton":
            cache = rk.riccati_cache_newton(p.A, p.B, p.Q, p.R, rho_b,
                                            self.cache.Kinf)
            bad = _nonfinite_rows(cache)
            self.fallback_count = int(bad.sum())
            if self.fallback_count:
                cache = _select_caches(bad, self._fixed_point_cache(rho_b),
                                       cache)
        else:
            cache = self._fixed_point_cache(rho_b)
        if polish:
            from ..precompute import riccati_polish_f64

            cache = riccati_polish_f64(cache, p.A, p.B, p.Q, p.R, rho_b)
        self.cache = cache
        self._build()

    def set_xref(self, Xref) -> None:
        """Per-instance reference trajectories ``(B, N, nx)`` (or a shared
        ``(N, nx)``) -- the reference FFI's ``set_xref``
        (tiny_wrapper.cpp:21-41) per instance; carries kept."""
        nx, _nu, N = self.dims
        Xref = self._tensor(Xref).expand(self.batch, N, nx).contiguous()
        self.problem = self.problem.replace(Xref=Xref)
        carry = self._carry
        self._build()
        self._carry = carry

    # ------------------------------------------------------------- solve ----
    def solve(self) -> dict[str, Any]:
        """One batched solve from the current x0 and warm-start carries.
        ``settings.check_termination == 0`` is the fixed-iteration mode,
        ``> 0`` per-instance early termination."""
        if self._x0 is None:
            raise RuntimeError("call set_x0 first")
        s = self.settings
        if getattr(s, "alpha", 1.0) != 1.0 and self.tier in (
                "hetero", "instance_ops", "hstream"):
            raise ValueError(
                "Settings.alpha (over-relaxation) is implemented on the "
                "scan/block/fused/condensed tiers; the hetero-family and "
                "instance-ops tiers run the reference (alpha=1) schedule -- "
                "use tier='scan' or drop alpha")
        nx, nu, N = self.dims
        if self.tier in ("scan", "block"):
            return self._solve_scan()
        if self.tier in ("hetero", "hstream"):
            ce = s.check_termination
            kw = dict(
                max_iter=s.max_iter, check_termination=ce,
                abs_pri_tol=float(s.abs_pri_tol),
                abs_dua_tol=float(s.abs_dua_tol),
                en_input_bound=s.en_input_bound,
                en_state_bound=s.en_state_bound, cones=self.cones,
                cone_params=self.cone_params, cone_masks=self.cone_masks)
            cascade = self.compaction_segment and ce > 0
            if self.tier == "hstream" and cascade:
                # adaptive segments (in-kernel freeze) + compaction, equal to
                # one long adaptive call; the segment rounded up to a check
                # multiple (the cadence-composition requirement)
                from ..solver.cascade import hstream_cascade_solve

                seg = -(-self.compaction_segment // ce) * ce
                U, X, stats, carry = hstream_cascade_solve(
                    self._x0, self._carry, self._hp, segment_iters=seg, **kw)
            elif self.tier == "hstream":
                from ..ops.hstream_admm import hstream_solve

                res = hstream_solve(self._x0, self._carry, self._hp, **kw)
                U, X, stats, carry = res.U, res.X, res.stats, res.carry
            elif cascade:
                from ..solver.cascade import hetero_cascade_solve

                U, X, stats, carry = hetero_cascade_solve(
                    self._x0, self._carry, self._hp,
                    segment_iters=self.compaction_segment, **kw)
            else:
                from ..ops.hetero_admm import hetero_solve

                res = hetero_solve(self._x0, self._carry, self._hp, **kw)
                U, X, stats, carry = res.U, res.X, res.stats, res.carry
            self._carry = carry
            self._last = (U, X)
            stats = stats.cpu().numpy()
            return {
                "iterations": stats[:, 0].astype(np.int64),
                "solved": stats[:, 1] > 0.5,
                "iterations_mean": float(stats[:, 0].mean()),
                "converged_fraction": float((stats[:, 1] > 0.5).mean()),
                "primal_residual_state_max": float(stats[:, 2].max()),
                "dual_residual_state_max": float(stats[:, 3].max()),
                "primal_residual_input_max": float(stats[:, 4].max()),
                "dual_residual_input_max": float(stats[:, 5].max()),
            }
        from ..solver.batched_ops import solve_instance_ops

        st = solve_instance_ops(self._x0, self._carry, self._ops, s,
                                cones=self.cones, dims=(nx, nu),
                                cone_args=self.cone_args)
        self._carry = st
        self._last = (st.U.reshape(self.batch, N - 1, nu),
                      st.X.reshape(self.batch, N, nx))
        iters = st.iter.cpu().numpy()
        solved = st.solved.cpu().numpy()
        return {
            "iterations": iters.astype(np.int64), "solved": solved,
            "iterations_mean": float(iters.mean()),
            "converged_fraction": float(solved.mean()),
        }

    def _solve_scan(self) -> dict[str, Any]:
        """The scan and block tiers: batched ``State`` sweeps with
        per-instance plants."""
        from ..solver.batched import BATCHED, solve_batched
        from ..solver.block_condensed import solve_block_batched
        from ..solver.cones import cone_slack_update

        if self.cone_params is not None or self.cone_masks is not None \
                or self.cone_args is not None:
            raise ValueError(
                "per-instance cone parameters/geometry are hetero, hstream "
                f"and instance-ops operands; tier={self.tier!r} takes a "
                "shared ConeSet")
        x = self._carry.x.clone()
        x[:, 0, :] = self._x0
        project = (cone_slack_update(self.cones)
                   if self.cones is not None else None)
        st = self._carry.replace(x=x)
        if self.tier == "block":
            st = solve_block_batched(st, self.problem, self.cache,
                                     self.settings, block=self.block,
                                     project=project, ops=self._ops)
        else:
            st = solve_batched(st, self.problem, self.cache, self.settings,
                               problem_axes=BATCHED, cache_axes=BATCHED,
                               project=project)
        self._carry = st
        self._last = (st.u, st.x)
        iters = st.iter.cpu().numpy()
        solved = (st.status == 1).cpu().numpy()
        return {
            "iterations": iters.astype(np.int64), "solved": solved,
            "iterations_mean": float(iters.mean()),
            "converged_fraction": float(solved.mean()),
        }

    def get_u(self) -> torch.Tensor:
        """Final (pre-projection) controls ``(B, N-1, nu)`` -- the reference
        applies pre-projection u."""
        if self._last is None:
            raise RuntimeError("no solve yet")
        return self._last[0]

    def get_x(self) -> torch.Tensor:
        """State trajectories ``(B, N, nx)``."""
        if self._last is None:
            raise RuntimeError("no solve yet")
        return self._last[1]

    def solve_adaptive_rho(self, engine: str = "auto", mesh=None,
                           **kw) -> dict[str, Any]:
        """Per-instance rho adaptation on the device; adopts the adapted
        caches for later solves.

        ``engine="einsum"``: chunks on the per-instance-operator tier
        (:func:`..solver.batched_ops.solve_adaptive_rho_batched`);
        ``"hetero"``: chunks on the adaptive hetero kernel, refreshes on the
        Riccati kernels (:func:`..solver.adaptive_hetero.
        solve_adaptive_rho_hetero`); ``"scan"``: scan-tier chunks, any
        horizon and nx (:func:`..solver.adaptive_scan.
        solve_adaptive_rho_scan`). ``"auto"`` picks ``"scan"`` for the scan
        and block tiers, ``"hetero"`` for the hetero tier when the tensors
        are on a CUDA device and no instance-ops cone overrides are set (the
        JAX package picks it on the TPU), ``"einsum"`` otherwise. The
        adapted caches rebuild the tier's operands; the scan and block tiers
        adopt the scan engine's state as their carry, the kernel tiers start
        cold. ``mesh=`` raises until the multi-GPU slice."""
        if mesh is not None:
            raise _later("mesh= (sharded adaptive rho over several GPUs)",
                         "slice 11")
        if engine not in ("auto", "einsum", "hetero", "scan"):
            raise ValueError(f"unknown engine {engine!r}")
        if self._x0 is None:
            raise RuntimeError("call set_x0 first")
        nx, nu, N = self.dims
        p = self.problem
        rho = self.cache.rho.to(torch.float32).reshape(-1).expand(
            self.batch).contiguous()
        if engine == "scan" or (engine == "auto"
                                and self.tier in ("scan", "block")):
            from ..solver.adaptive_scan import solve_adaptive_rho_scan

            res = solve_adaptive_rho_scan(self._x0, p, p.A, p.B, p.Q, p.R,
                                          rho, self.settings, **kw)
            self.cache = res.cache
            self._build()
            if self.tier in ("scan", "block"):
                self._carry = res.state
            self._last = (res.state.u, res.state.x)
            solved, rounds = res.solved, res.rounds
        elif engine == "hetero" or (
                engine == "auto" and self.tier == "hetero"
                and self.cone_args is None and self._x0.is_cuda):
            from ..solver.adaptive_hetero import solve_adaptive_rho_hetero

            res = solve_adaptive_rho_hetero(
                self._x0, p, p.A, p.B, p.Q, p.R, rho, self.settings,
                cones=self.cones, cone_params=self.cone_params,
                cone_masks=self.cone_masks, **kw)
            self.cache = res.cache
            self._build()
            self._last = (res.U, res.X)
            solved, rounds = res.solved, res.rounds
        else:
            from ..solver.batched_ops import solve_adaptive_rho_batched

            res = solve_adaptive_rho_batched(
                self._x0, p, p.A, p.B, p.Q, p.R, rho, self.settings,
                cones=self.cones, cone_args=self.cone_args, **kw)
            self.cache = res.cache
            self._build()
            st = res.state
            self._last = (st.U.reshape(self.batch, N - 1, nu),
                          st.X.reshape(self.batch, N, nx))
            solved, rounds = st.solved, res.rounds
        return {
            "rho": res.rho.cpu().numpy(),
            "iterations": res.total_iter.cpu().numpy().astype(np.int64),
            "solved": solved.cpu().numpy(),
            "rounds": int(rounds),
        }
