"""Plain-tensor ADMM solver core -- the port's ground truth.

The functional counterpart of the reference solver core (reference:
src/tinympc/admm.cpp) and of the JAX package's ``solver/admm.py``: one
function per stage, composed into ``admm_iteration``/``solve``. The horizon
sweeps and the iteration loop are Python loops. Every stage works on a
single instance or on any leading batch axes (the batch axis is written
out, problem data shared), which is how :mod:`.batched` reuses it.

Stage ordering and warm-start semantics replicated exactly
(reference: src/tinympc/admm.cpp:111-152):

1. ``forward_pass`` runs *first* each iteration, consuming ``d`` from the
   previous iteration (or the previous solve -- warm start; zeros cold).
2. slack -> dual -> linear-cost updates.
3. Termination checked every ``check_termination`` iterations; on
   convergence the iteration exits *without* saving ``v/z`` and *without*
   the backward pass.
4. Otherwise ``v = vnew``, ``z = znew``, then ``backward_pass_grad`` closes
   the iteration.

Deliberately replicated quirks (do not "fix"):
- ``update_linear_cost`` multiplies ``Xref`` by whatever diagonal ``Q`` sits
  in the workspace (raw in the examples, rho-augmented in codegen output)
  (reference: src/tinympc/admm.cpp:81).
- The ``Uref`` term in ``r`` is dropped (commented out in reference
  src/tinympc/admm.cpp:79), as is the always-zero ``coeff_d2p`` term in the
  backward pass (src/tinympc/admm.cpp:20).
- Dual residuals scale by rho; primal/dual residuals compare pre-projection
  iterates against new slacks and old-vs-new slacks respectively
  (src/tinympc/admm.cpp:95-98).

Precision: float32 products run in full float32. TF32 on Hopper keeps about
three decimal digits, which drifts a 100-iteration solve far past the 1e-4
parity bar, so this module switches it off for matrix products at import.
"""

from __future__ import annotations

import torch

from ..types import SOLVED, UNSOLVED, Cache, Problem, Settings, State

# Stated and set: no TF32 in any product of the plain tiers.
torch.backends.cuda.matmul.allow_tf32 = False


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` over any leading batch axes of ``v``."""
    return torch.matmul(v, M.transpose(-1, -2))


def forward_pass(state: State, problem: Problem, cache: Cache) -> State:
    """LQR rollout: u_i = -Kinf x_i - d_i; x_{i+1} = A x_i + B u_i
    (reference: src/tinympc/admm.cpp:27-37)."""
    x_i = state.x[..., 0, :]
    xs, us = [x_i], []
    for i in range(state.d.shape[-2]):
        u_i = -_mv(cache.Kinf, x_i) - state.d[..., i, :]
        x_i = _mv(problem.A, x_i) + _mv(problem.B, u_i)
        us.append(u_i)
        xs.append(x_i)
    return state.replace(u=torch.stack(us, dim=-2), x=torch.stack(xs, dim=-2))


def update_slack(state: State, problem: Problem, settings: Settings) -> State:
    """Project slack variables onto the box constraints
    (reference: src/tinympc/admm.cpp:45-61)."""
    znew = state.u + state.y
    vnew = state.x + state.g
    if settings.en_input_bound:
        znew = torch.minimum(problem.u_max, torch.maximum(problem.u_min, znew))
    if settings.en_state_bound:
        vnew = torch.minimum(problem.x_max, torch.maximum(problem.x_min, vnew))
    return state.replace(znew=znew, vnew=vnew)


def update_dual(state: State) -> State:
    """Scaled dual ascent (reference: src/tinympc/admm.cpp:67-71)."""
    return state.replace(
        y=state.y + state.u - state.znew,
        g=state.g + state.x - state.vnew,
    )


def update_linear_cost(state: State, problem: Problem, cache: Cache) -> State:
    """Refresh linear cost terms from references, slacks and duals
    (reference: src/tinympc/admm.cpp:77-85)."""
    r = -cache.rho * (state.znew - state.y)
    q = -(problem.Xref * problem.Q) - cache.rho * (state.vnew - state.g)
    p_terminal = -torch.matmul(problem.Xref[-1], cache.Pinf) - cache.rho * (
        state.vnew[..., -1, :] - state.g[..., -1, :]
    )
    p = state.p.clone()
    p[..., -1, :] = p_terminal
    return state.replace(r=r, q=q, p=p)


def compute_residuals(state: State, cache: Cache) -> tuple[torch.Tensor, ...]:
    """Max-abs primal/dual residuals per instance
    (reference: src/tinympc/admm.cpp:95-98)."""
    amax = lambda a: a.abs().amax(dim=(-2, -1))
    pri_state = amax(state.x - state.vnew)
    dua_state = amax(state.v - state.vnew) * cache.rho
    pri_input = amax(state.u - state.znew)
    dua_input = amax(state.z - state.znew) * cache.rho
    return pri_state, dua_state, pri_input, dua_input


def backward_pass_grad(state: State, problem: Problem, cache: Cache) -> State:
    """Riccati backward gradient recursion
    (reference: src/tinympc/admm.cpp:15-22; coeff_d2p term dropped as there)."""
    Bt = problem.B.transpose(-1, -2)
    Kt = cache.Kinf.transpose(-1, -2)
    p_next = state.p[..., -1, :]
    ds, ps = [], [p_next]
    for i in range(state.r.shape[-2] - 1, -1, -1):
        r_i = state.r[..., i, :]
        d_i = _mv(cache.Quu_inv, _mv(Bt, p_next) + r_i)
        p_next = state.q[..., i, :] + _mv(cache.AmBKt, p_next) - _mv(Kt, r_i)
        ds.append(d_i)
        ps.append(p_next)
    return state.replace(
        d=torch.stack(ds[::-1], dim=-2), p=torch.stack(ps[::-1], dim=-2)
    )


def _select(mask: torch.Tensor, on_true: State, on_false: State) -> State:
    """Field-wise ``where`` with a per-instance mask (shape = batch axes)."""
    out = {}
    for name, a in on_true.tensors().items():
        b = getattr(on_false, name)
        m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
        out[name] = torch.where(m, a, b)
    return State(**out)


def admm_iteration(
    state: State, problem: Problem, cache: Cache, settings: Settings,
    *,
    forward=None,
    backward=None,
    project=None,
) -> State:
    """One full ADMM iteration with the reference's exact stage ordering and
    early-exit data flow (reference: src/tinympc/admm.cpp:117-150).

    ``forward``/``backward`` override the horizon-sweep realizations (same
    signature as :func:`forward_pass`/:func:`backward_pass_grad`);
    ``project`` overrides the slack projection (same signature as
    :func:`update_slack`); the default is the reference's box clip.
    """
    forward = forward or forward_pass
    backward = backward or backward_pass_grad
    project = project or update_slack
    state = state.replace(iter=state.iter + 1)
    state = forward(state, problem, cache)
    if settings.alpha != 1.0:
        # OSQP-style over-relaxation (beyond the reference, opt-in): the
        # slack projection and dual update see the relaxed iterate
        # alpha*u + (1-alpha)*z_old; the true iterates (and hence the
        # residual definitions, linear-cost stage and backward pass) are
        # untouched.
        a = settings.alpha
        relaxed = state.replace(
            u=a * state.u + (1.0 - a) * state.z,
            x=a * state.x + (1.0 - a) * state.v,
        )
        relaxed = project(relaxed, problem, settings)
        relaxed = update_dual(relaxed)
        state = state.replace(
            znew=relaxed.znew, vnew=relaxed.vnew, y=relaxed.y, g=relaxed.g,
        )
    else:
        state = project(state, problem, settings)
        state = update_dual(state)
    state = update_linear_cost(state, problem, cache)

    converged = None
    if settings.check_termination > 0:
        do_check = (state.iter % settings.check_termination) == 0
        pri_s, dua_s, pri_u, dua_u = compute_residuals(state, cache)
        # Residual fields persist between checks (reference stores them in
        # the workspace only at check iterations -- admm.cpp:93-98).
        keep = lambda new, old: torch.where(do_check, new, old)
        state = state.replace(
            primal_residual_state=keep(pri_s, state.primal_residual_state),
            dual_residual_state=keep(dua_s, state.dual_residual_state),
            primal_residual_input=keep(pri_u, state.primal_residual_input),
            dual_residual_input=keep(dua_u, state.dual_residual_input),
        )
        converged = do_check & (
            (pri_s < settings.abs_pri_tol)
            & (pri_u < settings.abs_pri_tol)
            & (dua_s < settings.abs_dua_tol)
            & (dua_u < settings.abs_dua_tol)
        )

    # On convergence the reference returns *before* saving slacks and
    # running the backward pass (admm.cpp:135-144); replicate by masking.
    advanced = backward(
        state.replace(v=state.vnew, z=state.znew), problem, cache
    )
    if converged is None:
        return advanced
    state = _select(converged, state, advanced)
    status = torch.where(
        converged, torch.full_like(state.status, SOLVED), state.status
    )
    return state.replace(status=status)


def solve(
    state: State, problem: Problem, cache: Cache, settings: Settings,
    *, project=None, forward=None, backward=None,
) -> State:
    """Run the ADMM loop on one instance to convergence or ``max_iter``
    (reference: src/tinympc/admm.cpp:111-152).

    ``state.status == SOLVED`` corresponds to the reference's exitflag 0,
    anything else to exitflag 1. With ``check_termination == 0`` this is a
    fixed-iteration loop (deterministic mode for benchmarking and golden
    parity). The early-exit test reads the status on the host each
    iteration.
    """
    with torch.no_grad():
        state = state.replace(
            status=torch.full_like(state.status, UNSOLVED),
            iter=torch.zeros_like(state.iter),
        )
        step = lambda s: admm_iteration(
            s, problem, cache, settings,
            project=project, forward=forward, backward=backward,
        )
        if settings.check_termination <= 0:
            for _ in range(settings.max_iter):
                state = step(state)
            return state
        for _ in range(settings.max_iter):
            state = step(state)
            if bool((state.status == SOLVED).all()):
                break
        return state
