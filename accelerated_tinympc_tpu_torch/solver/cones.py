"""Second-order-cone constraints -- a capability beyond the reference.

Counterpart of the JAX package's ``solver/cones.py``. The reference projects
slacks onto box constraints only (reference: src/tinympc/admm.cpp:45-61);
thrust-limited quadrotors and powered-descent problems additionally need
second-order cones ``||w[ball]|| <= mu * (w[axis] + shift)`` (e.g. a
thrust-tilt cone on the input). This module adds axis-aligned cone projection
to the ADMM slack stage of the plain tiers through the ``project`` override
of :func:`..solver.admm.admm_iteration`; the fused CUDA kernels apply the
same projection inside the kernel (``ops/csrc/admm_iteration.cuh``,
``cone_stage``).

Projection of ``(v, s)`` onto ``K = {(v, s): ||v|| <= mu s}`` is the
standard closed form:

* ``||v|| <= mu s``            -> already in the cone, unchanged;
* ``mu ||v|| <= -s``           -> in the polar cone, project to 0;
* otherwise                    -> ``c = (mu ||v|| + s) / (mu^2 + 1)``,
  result ``(v * mu c / ||v||, c)`` on the cone boundary.

When both box bounds and cones are active the slack stage composes them
sequentially (box clip, then each cone in order). The composition is the
standard practical heuristic for intersections under ADMM -- it is *not* the
exact projection onto the intersection; ADMM still converges to a point
satisfying every set applied last in a fixed point, and the final slack is
verified against each cone in the tests. Use cones alone (bounds disabled)
for the exact-single-set case.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..types import DEFAULT_DEVICE, Problem, Settings, State
from .admm import update_slack


class Cone(NamedTuple):
    """One axis-aligned second-order cone
    ``||w[ball]|| <= mu * (w[axis] + shift)``.

    ``ball``/``axis`` index the per-knot decision vector (input ``u_i`` or
    state ``x_i``). ``shift`` translates the cone apex along the axis --
    e.g. a thrust-tilt cone on *hover-relative* inputs (the LTI deviation
    form absorbs constant gravity) is ``||u_xy|| <= mu * (u_z + g_hover)``.
    """

    ball: tuple[int, ...]
    axis: int
    mu: float
    shift: float = 0.0


class ConeSet(NamedTuple):
    """Cone constraints for a problem: cones on the input vector at every
    knot, and/or on the state vector at every knot."""

    input_cones: tuple[Cone, ...] = ()
    state_cones: tuple[Cone, ...] = ()


def _project(v, s, mu, shift):
    """The three-case projection on ball coordinates ``v (..., nb)`` and the
    shifted axis value ``s (...)``; returns the scaled ball and new axis."""
    a2 = (v * v).sum(dim=-1)
    a = torch.sqrt(a2)
    inside = a <= mu * s
    polar = mu * a <= -s
    c = (mu * a + s) / (mu * mu + 1.0)
    # Guard a == 0 (then `inside` or `polar` holds and the scale is unused).
    safe_a = torch.where(a2 == 0.0, torch.ones_like(a), a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    scale = torch.where(inside, one, mu * c / safe_a)
    scale = torch.where(polar, zero, scale)
    s_new = torch.where(inside, s, torch.where(polar, zero, c)) - shift
    return v * scale[..., None], s_new


def project_cone(w: torch.Tensor, cone: Cone) -> torch.Tensor:
    """Project per-knot vectors ``w (..., dim)`` onto ``cone``. Exact
    Euclidean projection over every leading axis."""
    # One column at a time: an index list would become a tensor constant,
    # which an exported loop body cannot hold (api/export.py).
    v = torch.stack([w[..., i] for i in cone.ball], dim=-1)
    v_new, s_new = _project(
        v, w[..., cone.axis] + cone.shift, cone.mu, cone.shift)
    out = w.clone()
    out[..., cone.axis] = s_new
    for j, i in enumerate(cone.ball):
        out[..., i] = v_new[..., j]
    return out


def project_cone_masked(
    w: torch.Tensor,
    cone: Cone,
    ball_mask: torch.Tensor | None = None,
    axis_mask: torch.Tensor | None = None,
    mu: torch.Tensor | None = None,
    shift: torch.Tensor | None = None,
) -> torch.Tensor:
    """Exact projection of ``w (B, K, dim)`` with *per-instance* cone
    geometry/parameters: ``ball_mask``/``axis_mask`` are ``(B, dim)`` 0/1
    rows (None -> the static ``cone.ball``/``cone.axis`` indices),
    ``mu``/``shift`` are ``(B,)`` (None -> the static scalars). The index
    gather/scatter of :func:`project_cone` is replaced by mask-weighted
    sums, since the geometry differs per instance; ``ball`` and ``axis``
    entries must be disjoint per instance."""
    dt, dev = w.dtype, w.device
    dim = w.shape[-1]
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    if ball_mask is None:
        bm = torch.zeros((1, dim), dtype=dt, device=dev)
        bm[0, list(cone.ball)] = 1.0
    else:
        bm = t(ball_mask)
    if axis_mask is None:
        am = torch.zeros((1, dim), dtype=dt, device=dev)
        am[0, cone.axis] = 1.0
    else:
        am = t(axis_mask)
    mu_ = float(cone.mu) if mu is None else t(mu).reshape(-1, 1)
    sh_ = float(cone.shift) if shift is None else t(shift).reshape(-1, 1)
    bmE, amE = bm[:, None, :], am[:, None, :]           # (B|1, 1, dim)
    a2 = ((w * bmE) ** 2).sum(dim=-1)                   # (B, K)
    a = torch.sqrt(a2)
    s = (w * amE).sum(dim=-1) + sh_                     # (B, K)
    inside = a <= mu_ * s
    polar = mu_ * a <= -s
    c = (mu_ * a + s) / (mu_ * mu_ + 1.0)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    safe_a = torch.where(a2 == 0.0, one, a)
    scale = torch.where(inside, one, mu_ * c / safe_a)
    scale = torch.where(polar, zero, scale)
    s_new = torch.where(inside, s, torch.where(polar, zero, c)) - sh_
    return (w * (1.0 - bmE - amE)
            + w * scale[..., None] * bmE
            + amE * s_new[..., None])


def make_cone_args(
    cones: ConeSet,
    batch: int,
    nx: int,
    nu: int,
    *,
    mu_u=None, shift_u=None, ball_u=None, axis_u=None,
    mu_x=None, shift_x=None, ball_x=None, axis_x=None,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
):
    """Per-instance cone overrides for the instance-ops tier:
    ``mu_u``/``shift_u`` are ``(n_input_cones, B)`` rows (or None for the
    static scalars), ``ball_u[c]`` a ``(B, nu)`` 0/1 membership array,
    ``axis_u[c]`` a ``(B,)`` int axis index (ditto ``*_x`` on ``nx``).
    Returns ``(input_args, state_args)``: one ``(mu, shift, ball_mask,
    axis_mask)`` tuple per cone with None for defaulted fields, for
    :func:`..solver.batched_ops.solve_instance_ops`'s ``cone_args``.

    Validated here: axis indices must lie in ``[0, dim)`` and each
    instance's *effective* ball and axis entries (overridden or static) must
    be disjoint -- the masked projection's arithmetic silently corrupts on
    overlap."""
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    def build(cone_list, dim, mu, shift, ball, axis, kind):
        out = []
        for c, cone in enumerate(cone_list):
            mu_c = None if mu is None else t(mu[c])
            sh_c = None if shift is None else t(shift[c])
            bm_np = np.zeros((batch, dim), np.float32)
            bm = None
            if ball is not None and ball[c] is not None:
                bm_np[:, :] = np.asarray(ball[c], np.float32)
                bm = t(bm_np)
            else:
                bm_np[:, list(cone.ball)] = 1.0
            am_np = np.zeros((batch, dim), np.float32)
            am = None
            if axis is not None and axis[c] is not None:
                ax = np.asarray(axis[c], np.int64)
                if ax.min() < 0 or ax.max() >= dim:
                    raise ValueError(
                        f"{kind} cone {c}: axis indices must be in "
                        f"[0, {dim}), got [{ax.min()}, {ax.max()}]"
                    )
                am_np[np.arange(batch), ax] = 1.0
                am = t(am_np)
            else:
                am_np[:, int(cone.axis)] = 1.0
            bad = np.nonzero((bm_np * am_np).sum(axis=1) > 0)[0]
            if bad.size:
                raise ValueError(
                    f"{kind} cone {c}: ball and axis lanes overlap for "
                    f"instance(s) {bad[:8].tolist()}"
                    f"{'...' if bad.size > 8 else ''} -- when overriding "
                    "only axis (or only ball), the other defaults to the "
                    "cone's static indices; pass both"
                )
            out.append((mu_c, sh_c, bm, am))
        return tuple(out)

    return (
        build(cones.input_cones, nu, mu_u, shift_u, ball_u, axis_u, "input"),
        build(cones.state_cones, nx, mu_x, shift_x, ball_x, axis_x, "state"),
    )


def cone_slack_update(cones: ConeSet):
    """Build an ``update_slack`` replacement applying box bounds (if enabled)
    then each cone in ``cones`` sequentially. Pass as
    ``admm_iteration(..., project=cone_slack_update(cones))`` or
    ``solve(..., project=...)`` / ``solve_batched(..., project=...)``."""

    def project(state: State, problem: Problem, settings: Settings) -> State:
        state = update_slack(state, problem, settings)
        znew, vnew = state.znew, state.vnew
        for cone in cones.input_cones:
            znew = project_cone(znew, cone)
        for cone in cones.state_cones:
            vnew = project_cone(vnew, cone)
        return state.replace(znew=znew, vnew=vnew)

    return project


def project_flat(W: torch.Tensor, cone_list, dim: int) -> torch.Tensor:
    """Apply ``cone_list`` in order to flat slacks ``W (B, K*dim)`` viewed
    per knot (the condensed and fused-plain tiers' layout)."""
    if not cone_list:
        return W
    Wk = W.reshape(W.shape[0], -1, dim)
    for cone in cone_list:
        Wk = project_cone(Wk, cone)
    return Wk.reshape(W.shape[0], -1)


def cone_violation(w: torch.Tensor, cone: Cone) -> torch.Tensor:
    """Max violation ``||w[ball]|| - mu * (w[axis] + shift)`` over all
    leading axes (<= 0 means satisfied) -- observability helper for
    tests/metrics."""
    v = w[..., list(cone.ball)]
    a = torch.sqrt((v * v).sum(dim=-1))
    return (a - cone.mu * (w[..., cone.axis] + cone.shift)).max()
