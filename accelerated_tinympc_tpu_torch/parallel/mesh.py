"""Batch data parallelism over ``torch.distributed``: one process per GPU.

Counterpart of the JAX package's ``parallel/mesh.py``. The reference has no
distribution at all (one MCU, one problem); the per-instance ADMM solve
(reference: src/tinympc/admm.cpp:111-152) is embarrassingly parallel across
instances, so the batch axis splits over the ranks with no traffic in the
solve itself. Each rank runs its contiguous block of the global batch
through the port's single-device call (the same kernels, the same numbers),
and collectives appear only for the global stats and for the compaction
cascade's rebalancing of survivors.

The idiom is PyTorch's: one process per GPU (``torchrun`` or any launcher),
:func:`initialize_distributed` brings up the process group, and
:func:`make_batch_mesh` describes this rank's place in it as a
:class:`BatchMesh` (world size, rank, the rank's device). Without a process
group the mesh is a world of one and no collective runs; a process group
of one (NCCL on one card) runs its collectives all the same.

* :func:`shard_batch` takes this rank's block of a batch-leading pytree
  (rows ``[r B/n, (r+1) B/n)``, the JAX ``P(BATCH_AXIS)`` layout);
  :func:`replicate` moves shared pytrees to the rank's device;
  :func:`gather_batch` is the inverse of :func:`shard_batch` (every rank
  receives the global rows), where the JAX package reads a sharded global
  array.
* Each ``sharded_*`` function returns a callable over this rank's shards
  that returns this rank's shard of the result and the stats dict reduced
  over the world (sums and maxima; JAX's ``pmean`` is a sum over the world
  divided by its size). :func:`sharded_cascade_solve` takes and returns
  global arrays, and every rank holds the global result.

Collectives run on the device tensor under NCCL. Under gloo they run on a
CPU copy made in :func:`_wire`: that copy is the route the caller chose
with the backend. Two ranks cannot share one GPU under NCCL; two ranks on
one card run over gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..types import SOLVED, Cache, Problem, Settings, State

BATCH_AXIS = "batch"
# How long a rank waits for its peers in a collective (and at the
# rendezvous) before it raises: a rank that failed must not hang the others.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """This rank's place in a 1-D batch mesh: ``size`` ranks, this one's
    ``rank`` and ``device``, and the process group's ``backend`` (None
    without a process group: a world of one where no collective runs)."""

    size: int
    rank: int
    device: torch.device
    backend: str | None = None


def _rank_device(rank: int, device: Any) -> torch.device:
    """The rank's device: ``device`` as given, where ``"cuda"`` without an
    index means ``cuda:$LOCAL_RANK`` (``torchrun`` sets it), else
    ``cuda:{rank mod cards}``. The default is the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        if local is not None:
            index = int(local)
        else:
            cards = torch.cuda.device_count()
            index = rank % cards if cards else 0
        dev = torch.device("cuda", index)
    return dev


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: Any = None,
    backend: str | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Bring up the process group of ``num_processes`` ranks, this one
    ``process_id``, meeting at ``coordinator_address`` (``"host:port"``;
    None reads ``MASTER_ADDR``/``MASTER_PORT`` as ``torchrun`` sets them).
    Does nothing for a single process.

    ``device`` is the rank's device (see :func:`make_batch_mesh`); the
    backend is ``"nccl"`` for CUDA ranks and ``"gloo"`` for CPU ranks unless
    ``backend`` names another. Raises if that backend is not in this build
    of torch. ``timeout`` bounds every collective's wait for the peers."""
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        raise ValueError("process_id is needed when num_processes > 1")
    dev = _rank_device(process_id, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    have = {"nccl": dist.is_nccl_available,
            "gloo": dist.is_gloo_available}.get(backend)
    if not dist.is_available() or (have is not None and not have()):
        raise RuntimeError(
            f"the torch.distributed backend {backend!r} is not available in "
            f"torch {torch.__version__}; pass backend= (gloo runs CPU ranks "
            "and ranks that share one card)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def make_batch_mesh(n_devices: int | None = None, *,
                    device: Any = None) -> BatchMesh:
    """The 1-D batch mesh of the current process group (a world of one
    without one). ``n_devices`` must equal the world size, or be None: one
    process drives one device. ``device`` is this rank's device (default
    the card: ``cuda:$LOCAL_RANK``); pass ``"cpu"`` for CPU ranks, or
    ``"cuda:0"`` for ranks that share one card."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        size, rank, backend = 1, 0, None
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"n_devices={n_devices} but the world has {size} rank(s): one "
            "process per device (initialize_distributed, or torchrun)")
    dev = _rank_device(rank, device)
    if dev.type == "cuda" and size > 1:
        torch.cuda.set_device(dev)
    return BatchMesh(size=size, rank=rank, device=dev, backend=backend)


# ------------------------------------------------------------------ pytrees --

def _tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """``fn`` on every tensor (and numpy array, as a tensor) of a pytree of
    dataclasses, NamedTuples, tuples, lists and dicts; other leaves are kept.
    A container none of whose leaves changed is returned as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, np.ndarray):
        return fn(torch.as_tensor(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        old = {f.name: getattr(tree, f.name)
               for f in dataclasses.fields(tree) if f.init}
    elif isinstance(tree, (tuple, list)):
        old = dict(enumerate(tree))
    elif isinstance(tree, dict):
        old = tree
    else:
        return tree
    new = {k: _tree_map(fn, v) for k, v in old.items()}
    if all(new[k] is v for k, v in old.items()):
        return tree
    if isinstance(tree, dict):
        return new
    if isinstance(tree, list):
        return list(new.values())
    if isinstance(tree, tuple):
        vals = new.values()
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return dataclasses.replace(tree, **new)


def shard_batch(tree: Any, mesh: BatchMesh) -> Any:
    """This rank's contiguous block of a batch-leading pytree, on its
    device: rows ``[r B/n, (r+1) B/n)`` of every leaf (the JAX
    ``P(BATCH_AXIS)`` layout). ``B`` must divide by the world size."""
    n, r = mesh.size, mesh.rank

    def take(x):
        if x.dim() == 0:
            raise ValueError("a 0-d leaf has no batch axis: replicate it")
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} must divide by mesh size {n}")
        b = B // n
        return x[r * b:(r + 1) * b].to(mesh.device)

    return _tree_map(take, tree)


def replicate(tree: Any, mesh: BatchMesh) -> Any:
    """Shared (problem/cache) pytrees on this rank's device."""
    return _tree_map(lambda x: x.to(mesh.device), tree)


def _wire(t: torch.Tensor, mesh: BatchMesh) -> torch.Tensor:
    """The tensor a collective runs on: the device tensor itself under NCCL,
    a CPU copy under gloo (the route the caller chose with the backend)."""
    t = t.contiguous()
    return t.cpu() if mesh.backend == "gloo" else t


def _all_gather(t: torch.Tensor, mesh: BatchMesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated on the leading axis,
    in rank order, on ``t``'s device."""
    if mesh.backend is None:
        return t
    w = _wire(t.to(torch.uint8) if t.dtype == torch.bool else t, mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w)
    return torch.cat(parts).to(device=t.device, dtype=t.dtype)


def gather_batch(tree: Any, mesh: BatchMesh) -> Any:
    """The inverse of :func:`shard_batch`: every leaf's global rows on every
    rank (where the JAX package reads a batch-sharded global array)."""
    return _tree_map(lambda x: _all_gather(x, mesh), tree)


_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX}


def _reduce(stats: dict[str, tuple[str, torch.Tensor]],
            mesh: BatchMesh) -> dict[str, torch.Tensor]:
    """Reduce ``{key: (op, 0-d tensor)}`` over the world (``op`` one of
    ``"sum"``, ``"max"``, ``"mean"``: JAX's ``psum``, ``pmax``, ``pmean``),
    one collective per op and dtype. Keys keep their order."""
    groups: dict[tuple, list[str]] = {}
    for k, (op, v) in stats.items():
        groups.setdefault((op, v.dtype), []).append(k)
    out = {}
    for (op, _dt), keys in groups.items():
        buf = torch.stack([stats[k][1].reshape(()) for k in keys])
        if mesh.backend is not None:
            w = _wire(buf, mesh)
            dist.all_reduce(w, op=_OPS[op])
            buf = w.to(buf.device)
            if op == "mean":
                buf = buf / mesh.size
        out.update(zip(keys, buf.unbind()))
    return {k: out[k] for k in stats}


def _count(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(n), dtype=torch.float32, device=like.device)


def _residual_maxes(st: torch.Tensor) -> dict:
    """Stats columns 2-5 (pri_state, dua_state, pri_input, dua_input) as
    JAX's ``pmax`` entries."""
    return {
        "primal_residual_state_max": ("max", st[:, 2].max()),
        "dual_residual_state_max": ("max", st[:, 3].max()),
        "primal_residual_input_max": ("max", st[:, 4].max()),
        "dual_residual_input_max": ("max", st[:, 5].max()),
    }


# ----------------------------------------------------------- entry points --

def sharded_solve(
    mesh: BatchMesh,
    settings: Settings,
    *,
    solver: Callable[..., State] | None = None,
) -> Callable[[State, Problem, Cache], tuple[State, dict[str, torch.Tensor]]]:
    """A sharded scan-tier solve: ``(state, problem, cache) -> (state,
    stats)`` with ``state`` this rank's shard (:func:`shard_batch`) and
    ``problem``/``cache`` shared (:func:`replicate`). ``solver(state,
    problem, cache)`` replaces the local solve (default
    :func:`..solver.batched.solve_batched` with ``settings``; e.g. the
    block-condensed sweeps). The stats are reduced over the world, so every
    rank sees the global values."""
    from ..solver.batched import solve_batched

    local_solve = solver or (
        lambda s, p, c: solve_batched(s, p, c, settings))

    def run(state: State, problem: Problem, cache: Cache):
        out = local_solve(state, problem, cache)
        converged = (out.status == SOLVED).to(torch.float32)
        stats = _reduce({
            "n_total": ("sum", _count(out.iter.shape[0], out.iter)),
            "n_converged": ("sum", converged.sum()),
            "iterations_sum": ("sum", out.iter.to(torch.float32).sum()),
            "iterations_max": ("max", out.iter.max()),
            "primal_residual_state_max": (
                "max", out.primal_residual_state.max()),
            "primal_residual_input_max": (
                "max", out.primal_residual_input.max()),
            "dual_residual_state_max": ("max", out.dual_residual_state.max()),
            "dual_residual_input_max": ("max", out.dual_residual_input.max()),
        }, mesh)
        return out, stats

    return run


def summarize_stats(stats: dict[str, torch.Tensor]) -> dict[str, float]:
    """Host-side scalars of the reduced stats."""
    n = float(stats["n_total"])
    return {
        "n_total": n,
        "converged_fraction": float(stats["n_converged"]) / max(n, 1.0),
        "iterations_mean": float(stats["iterations_sum"]) / max(n, 1.0),
        "iterations_max": float(stats["iterations_max"]),
        "primal_residual_state_max": float(stats["primal_residual_state_max"]),
        "primal_residual_input_max": float(stats["primal_residual_input_max"]),
        "dual_residual_state_max": float(stats["dual_residual_state_max"]),
        "dual_residual_input_max": float(stats["dual_residual_input_max"]),
    }


def sharded_fused_solve(
    mesh: BatchMesh,
    pp,
    *,
    max_iter: int = 100,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    batch_tile: int | None = None,
    cone_ops=None,
):
    """The fused kernels (K1 fixed, K2 adaptive; with ``cone_ops`` their
    coned instantiations, K4) per rank: ``(x0s, carry) -> (FusedResult,
    stats)`` over this rank's shards; the result is this rank's shard.
    ``cone_ops`` (:func:`..ops.fused_admm.pad_cones`) stands for the JAX
    package's coned ``pp``: the port keeps the cones beside the padded
    problem. The residual columns are valid in both modes; the solved flag,
    and so ``n_converged``, only in adaptive mode."""
    from ..ops.fused_admm import fused_solve

    pp = replicate(pp, mesh)
    cone_ops = replicate(cone_ops, mesh)

    def run(x0s, carry):
        res = fused_solve(
            x0s, carry, pp, max_iter=max_iter,
            check_termination=check_termination, abs_pri_tol=abs_pri_tol,
            abs_dua_tol=abs_dua_tol, batch_tile=batch_tile,
            cone_ops=cone_ops)
        st = res.stats
        stats = _reduce({
            "n_total": ("sum", _count(st.shape[0], st)),
            "n_converged": ("sum", st[:, 1].sum()),
            "iterations_sum": ("sum", st[:, 0].sum()),
            "iterations_max": ("max", st[:, 0].max()),
            **_residual_maxes(st),
        }, mesh)
        return res, stats

    return run


def sharded_fused_rollout(
    mesh: BatchMesh,
    pp,
    rops,
    n_ticks: int,
    *,
    max_iter: int = 100,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    batch_tile: int | None = None,
    const_seq: torch.Tensor | None = None,
):
    """The in-kernel receding-horizon mission (K3) per rank: ``(x0s, carry)
    -> (RolloutResult, stats)``; ticks are plant-local, so the mission needs
    no traffic. The result is this rank's shard: ``x_final`` and the final
    solve on their leading axis, ``us``/``iters`` on their second (batch)
    axis."""
    from ..ops.fused_rollout import fused_rollout

    pp, rops = replicate(pp, mesh), replicate(rops, mesh)
    const_seq = replicate(const_seq, mesh)

    def run(x0s, carry):
        res = fused_rollout(
            x0s, carry, pp, rops, n_ticks, max_iter=max_iter,
            check_termination=check_termination, abs_pri_tol=abs_pri_tol,
            abs_dua_tol=abs_dua_tol, batch_tile=batch_tile,
            const_seq=const_seq)
        stats = _reduce({
            "n_total": ("sum", _count(res.x_final.shape[0], res.iters)),
            "iterations_sum": ("sum", res.iters.sum(dtype=torch.int32)),
            "iterations_max": ("max", res.iters.max()),
            "last_tick_iterations_mean": (
                "mean", res.iters[-1].to(torch.float32).mean()),
        }, mesh)
        return res, stats

    return run


def sharded_hetero_solve(
    mesh: BatchMesh,
    *,
    max_iter: int = 100,
    en_input_bound: bool = True,
    en_state_bound: bool = True,
):
    """The heterogeneous-plant kernel (K7, fixed iterations) per rank: every
    instance carries its own plant, and the plants shard with the batch.
    ``(x0s, carry, hp) -> (HeteroResult, stats)`` over this rank's shards
    (:func:`shard_batch` of the global ``x0s``, carry and
    :class:`..ops.hetero_admm.HeteroProblem`)."""
    from ..ops.hetero_admm import hetero_solve

    def run(x0s, carry, hp):
        res = hetero_solve(x0s, carry, hp, max_iter=max_iter,
                           en_input_bound=en_input_bound,
                           en_state_bound=en_state_bound)
        st = res.stats
        stats = _reduce({
            "n_total": ("sum", _count(st.shape[0], st)),
            "iterations_max": ("max", st[:, 0].max()),
            **_residual_maxes(st),
        }, mesh)
        return res, stats

    return run


def sharded_adaptive_hetero(
    mesh: BatchMesh,
    settings: Settings,
    *,
    chunk: int = 25,
    max_rounds: int = 40,
    adapt_factor: float = 5.0,
    stall_factor: float = 1.5,
    rho_min: float = 1e-2,
    rho_max: float = 1e3,
    riccati: str = "auto",
    cones=None,
):
    """Per-instance adaptive rho on the hetero kernels per rank
    (:func:`..solver.adaptive_hetero.solve_adaptive_rho_hetero`: chunks on
    K8, refreshes on K5/K6). Rho is per-instance state, so each rank runs
    its own loop and exits when its own instances converge: rounds after an
    instance converged leave it as it is, so the decisions per instance are
    those of the unsharded loop. The collectives are the summary stats.

    Returns ``(x0s, problem_b, A, B, Q, R, rho0) -> (result, stats)`` over
    this rank's shards; ``result`` holds the
    :class:`..solver.adaptive_hetero.AdaptiveHeteroResult` fields of the
    shard (``rounds`` becomes the world's maximum, in ``stats``). ``cones``
    is a shared :class:`..solver.cones.ConeSet`."""
    from ..solver.adaptive_hetero import solve_adaptive_rho_hetero

    def run(x0s, prob_b, A, B_, Q, R, rho0):
        res = solve_adaptive_rho_hetero(
            x0s, prob_b, A, B_, Q, R, rho0, settings, chunk=chunk,
            max_rounds=max_rounds, adapt_factor=adapt_factor,
            stall_factor=stall_factor, rho_min=rho_min, rho_max=rho_max,
            riccati=riccati, cones=cones)
        stats = _reduce({
            "n_total": ("sum", _count(x0s.shape[0], res.total_iter)),
            "n_solved": ("sum", res.solved.to(torch.float32).sum()),
            "rounds_max": ("max", torch.tensor(
                int(res.rounds), dtype=torch.int32,
                device=res.total_iter.device)),
            "iterations_max": ("max", res.total_iter.max()),
        }, mesh)
        out = {"U": res.U, "X": res.X, "rho": res.rho, "cache": res.cache,
               "solved": res.solved, "total_iter": res.total_iter,
               "carry": res.carry}
        return out, stats

    return run


def _stream_stats(res) -> dict:
    st = res.stats
    return {"n_total": ("sum", _count(st.shape[0], st)),
            **_residual_maxes(st)}


def sharded_hstream_solve(
    mesh: BatchMesh,
    *,
    max_iter: int = 100,
    knot_block: int = 16,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    en_input_bound: bool = True,
    en_state_bound: bool = True,
    cones=None,
):
    """The long-horizon kernels with per-instance plants (K11 fixed, K12
    adaptive for ``check_termination > 0``) per rank: ``(x0s, carry, hsp)
    -> (StreamResult, stats)`` over this rank's shards of the batch, the
    carry and the :class:`..ops.hstream_admm.HStreamProblem`. Adaptive
    instances exit on their own rank, with no synchronisation."""
    from ..ops.hstream_admm import hstream_solve

    def run(x0s, carry, hsp):
        res = hstream_solve(
            x0s, carry, hsp, max_iter=max_iter, knot_block=knot_block,
            check_termination=check_termination, abs_pri_tol=abs_pri_tol,
            abs_dua_tol=abs_dua_tol, en_input_bound=en_input_bound,
            en_state_bound=en_state_bound, cones=cones)
        return res, _reduce(_stream_stats(res), mesh)

    return run


def sharded_stream_solve(
    mesh: BatchMesh,
    *,
    max_iter: int = 100,
    knot_block: int = 32,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    en_input_bound: bool = True,
    en_state_bound: bool = True,
    cones=None,
):
    """The long-horizon kernels with one shared plant (K9 fixed, K10
    adaptive) per rank: ``(x0s, carry, sp) -> (StreamResult, stats)`` with
    ``x0s`` and the carry this rank's shards and ``sp`` shared."""
    from ..ops.stream_admm import stream_solve

    def run(x0s, carry, sp):
        res = stream_solve(
            x0s, carry, replicate(sp, mesh), max_iter=max_iter,
            knot_block=knot_block, check_termination=check_termination,
            abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
            en_input_bound=en_input_bound, en_state_bound=en_state_bound,
            cones=cones)
        return res, _reduce(_stream_stats(res), mesh)

    return run


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def sharded_cascade_solve(
    mesh: BatchMesh,
    pp,
    *,
    max_iter: int = 100,
    check_termination: int = 1,
    segment_iters: int | None = None,
    segment_growth: float = 4.0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    batch_tile: int | None = None,
    min_bucket: int | None = None,
    segment_log: list | None = None,
):
    """The early-termination compaction cascade over the world (the
    reference's early exit, src/tinympc/admm.cpp:135-144, at the level of
    the mesh; the segment contract is :func:`..solver.cascade.
    cascade_solve`'s). Survivors are rebalanced globally between segments,
    as in the JAX package: after each segment every rank receives every
    rank's rows (one ``all_gather``), writes them into the global output
    buffers and learns the global solved set, so every rank computes the
    same survivors; the next bucket is ``n x next_pow2(ceil(survivors /
    n))`` rows (at least ``min_bucket`` a rank, at most its first share),
    padded by repeating the last survivor, and each rank launches on its
    block of it. The survivors' rows travel; the kernel segments run with no
    traffic.

    Returns ``run(x0, carry) -> FusedResult`` over GLOBAL batch-leading
    arrays (``B`` divisible by the world size, the same on every rank); every
    rank returns the global result. ``batch_tile`` is the kernel's slots per
    block, the same for every segment (None: each launch chooses).
    ``segment_log`` (a list) receives ``(iterations done, per-rank bucket)``
    after each compaction."""
    from ..ops.fused_admm import FusedCarry, FusedResult, fused_solve
    from ..solver.cascade import _grow, _segment_schedule

    nd = mesh.size
    segment_iters = _segment_schedule(check_termination, segment_iters,
                                      segment_growth)
    pp = replicate(pp, mesh)

    def run(x0, carry):
        B = x0.shape[0]
        if B % nd:
            raise ValueError(f"batch {B} must divide by mesh size {nd}")
        bl = B // nd
        mb = min_bucket if min_bucket is not None else min(128, bl)
        x0_g = replicate(x0, mesh)                  # the bucket's x0, global
        x0_b, carry_b = shard_batch(x0_g, mesh), shard_batch(carry, mesh)
        active_idx = np.arange(B, dtype=np.int64)
        out = None
        done_iters, cur_seg = 0, segment_iters
        with torch.no_grad():
            while True:
                n_active = active_idx.size
                k = min(cur_seg, max_iter - done_iters)
                res = fused_solve(
                    x0_b, carry_b, pp, max_iter=k,
                    check_termination=check_termination,
                    abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
                    batch_tile=batch_tile)
                stats = res.stats.clone()
                stats[:, 0] += done_iters
                fields = (res.U, res.X, stats) + tuple(res.carry)
                widths = [f.shape[1] for f in fields]
                rows = _all_gather(torch.cat(fields, dim=1), mesh)
                if out is None:
                    out = torch.zeros((B + 1, rows.shape[1]),
                                      dtype=rows.dtype, device=rows.device)
                idx = np.full(rows.shape[0], B, np.int64)
                idx[:n_active] = active_idx
                out[torch.as_tensor(idx, device=out.device)] = rows
                done_iters += k
                if done_iters >= max_iter:
                    break
                c = widths[0] + widths[1] + 1      # the solved column
                solved = rows[:n_active, c].cpu().numpy() > 0.5
                keep = np.nonzero(~solved)[0]
                if keep.size == 0:
                    break
                cur_seg = _grow(cur_seg, segment_growth, check_termination)
                active_idx = active_idx[keep]
                per_shard = min(bl, max(mb, _next_pow2(-(-keep.size // nd))))
                local = np.concatenate([
                    keep, np.full(per_shard * nd - keep.size, keep[-1],
                                  keep.dtype)])
                if segment_log is not None:
                    segment_log.append((done_iters, per_shard))
                sel = torch.as_tensor(local, device=rows.device)
                carry_g = rows.index_select(0, sel)[:, sum(widths[:3]):]
                x0_g = x0_g.index_select(0, sel.to(x0_g.device))
                x0_b = shard_batch(x0_g, mesh)
                carry_b = shard_batch(FusedCarry(*torch.split(
                    carry_g, widths[3:], dim=1)), mesh)
                carry_b = FusedCarry(*(a.contiguous() for a in carry_b))
        out = out[:B]
        U, X, st, *cy = torch.split(out, widths, dim=1)
        return FusedResult(U=U.contiguous(), X=X.contiguous(),
                           carry=FusedCarry(*(a.contiguous() for a in cy)),
                           stats=st.contiguous())

    return run
