"""PyTorch port, the fused cone pass's layout on the CPU.

The coned float32 kernels fold the cone projections and the dual ascent
into the forward stage (``cone_forward_stage`` in
``ops/csrc/admm_iteration.cuh``): the wrapper lays every slot group's
columns out in runs of 32 items, one run a warp pass, cut only between
knots that have cones (``ops/fused_admm.py`` ``cone_items``). The card is
needed to run the kernels; here are checked the layout (every column owned
once, every coned knot in one warp, which lists it), the cones that the
layout keeps together against the JAX package's own cone masks
(``accelerated_tinympc_tpu/ops/fused_admm.py`` ``pad_cones``: axis mask in
row ``ci * 8``, ball mask in ``ci * 8 + 1``, shift, mu), which path each
launch takes and the C entries' signatures. No solve: a few seconds."""

import pathlib
import re

import numpy as np
import pytest
import torch

from accelerated_tinympc_tpu.models import quadrotor_hovering_setup
from accelerated_tinympc_tpu.ops import fused_admm as fj
from accelerated_tinympc_tpu.precompute import condensed_operators
from accelerated_tinympc_tpu.solver import cones as cj
from accelerated_tinympc_tpu_torch.ops import fused_admm as ft
from accelerated_tinympc_tpu_torch.solver import cones as ct

from torch_parity_utils import (
    cache_to_torch, lander_pair, problem_to_torch, torch_pp,
)

LANDER = (6, 3, 15)
FLAGSHIP = (12, 4, 10)

# (dims, slots, register tile, input cones, state cones), by family: the
# lander at the main batch's 56 slots and at the comparison batch's 32, with
# one kind of cone or both; the quadrotor's tilt cone and the ten cones at
# 48 slots and at one register tile (128 threads); horizons of two passes
# (N=40) and of the 4-slot tile (N=129); narrow knots, of 5 columns that
# chain across every column group and of one input (four knots start in
# one column group)
LAYOUTS = {
    "lander": [(LANDER, 56, 8, True, True), (LANDER, 32, 8, True, True),
               (LANDER, 56, 8, True, False), (LANDER, 56, 8, False, True)],
    "quadrotor": [(FLAGSHIP, 48, 8, True, False),
                  (FLAGSHIP, 48, 8, True, True), (FLAGSHIP, 8, 8, True, True)],
    "long": [((12, 4, 40), 16, 8, True, True),
             ((12, 4, 129), 8, 4, True, True)],
    "narrow": [((5, 2, 20), 32, 8, True, True),
               ((3, 1, 30), 24, 8, True, True)],
}


def _decode(items):
    """Per item ``(run, lane, g, cg, own)``, padding left out."""
    out = []
    for run, row in enumerate(items):
        for lane, code in enumerate(row[:32].tolist()):
            if code >= 0:
                out.append((run, lane, code >> 20, (code >> 8) & 0xfff,
                            code & 15))
    return out


def _run_knots(items):
    """Per run its listed knots ``(g, first column)``, state then input."""
    out = []
    for row in items.tolist():
        kx, ku = row[32], row[33]
        out.append([(e >> 16, e & 0xffff) for e in row[34:34 + kx + ku]])
        assert all(e == -1 for e in row[34 + kx + ku:])
    return out


def _owners(items, dims, tile, ri):
    """``run[g, column]``: the run that owns each column of each slot
    group (asserting one owner each)."""
    nx, nu, N = dims
    W = (N * nx + (N - 1) * nu + 3) & ~3
    run = np.full((tile // ri, W), -1)
    for r, _lane, g, cg, own in _decode(items):
        for c in range(4):
            if (own >> c) & 1:
                assert run[g, 4 * cg + c] < 0, (g, 4 * cg + c)
                run[g, 4 * cg + c] = r
    assert (run >= 0).all()
    return run


def _knots(dims, has_u, has_x):
    """The coned knots as column ranges ``(first, end)``."""
    nx, nu, N = dims
    Dx = N * nx
    return ([(k * nx, (k + 1) * nx) for k in range(N)] if has_x else []) + (
        [(Dx + k * nu, Dx + (k + 1) * nu) for k in range(N - 1)]
        if has_u else [])


@pytest.mark.parametrize("family", list(LAYOUTS))
def test_every_column_is_owned_once_and_every_coned_knot_lies_in_one_warp(
        family):
    for layout in LAYOUTS[family]:
        _check_layout(*layout)


def _check_layout(dims, tile, ri, has_u, has_x):
    items = ft.cone_items(dims, tile, ri, has_u, has_x)
    assert items.dtype == np.int32 and items.shape[1] == ft.RUN_WORDS
    run = _owners(items, dims, tile, ri)
    knots = _knots(dims, has_u, has_x)
    for g in range(tile // ri):
        for first, end in knots:
            assert len(set(run[g, first:end])) == 1, (g, first)
    # each run lists the coned knots whose columns it owns, once, state
    # knots first (the counts say where input knots begin)
    listed = _run_knots(items)
    Dx = dims[2] * dims[0]
    for r, row in enumerate(items.tolist()):
        kinds = [first < Dx for _g, first in listed[r]]
        assert kinds == sorted(kinds, reverse=True)
        assert sum(kinds) == row[32] and len(kinds) - sum(kinds) == row[33]
    want = {(g, first, int(run[g, first])) for g in range(tile // ri)
            for first, _e in knots}
    got = {(g, first, r) for r, ks in enumerate(listed) for g, first in ks}
    assert got == want and sum(map(len, listed)) == len(want)
    # a group sits in two runs only where a run ends inside it: at most one
    # copy a run
    groups = [(g, cg) for _r, _l, g, cg, _o in _decode(items)]
    nx, nu, N = dims
    ncg = (N * nx + (N - 1) * nu + 3) // 4
    assert len(set(groups)) == (tile // ri) * ncg
    assert len(groups) - len(set(groups)) < len(items)


def test_the_lander_keeps_one_pass_of_eight_warps():
    # 56 slots of 33 column groups fill 231 lanes of the 256 a block has;
    # the cut knots add four copies and the runs stay eight: one pass, as
    # the box-only forward stage
    items = ft.cone_items(LANDER, 56, 8, True, True)
    assert items.shape == (8, ft.RUN_WORDS)
    assert (items[:, :32] >= 0).sum() == 235
    # input knot 12 (columns 126-128) crosses the float4 group 31 | 32: both
    # groups of slot group 0 sit in one run, which lists the knot
    run = _owners(items, LANDER, 56, 8)
    assert run[0, 126] == run[0, 128]
    assert (0, 126) in _run_knots(items)[run[0, 126]]


def test_a_knot_wider_than_a_warp_takes_the_three_passes():
    assert ft.cone_items((130, 2, 3), 8, 8, False, True) is None
    assert ft.cone_items((130, 2, 3), 8, 8, True, False) is not None


def _jax_masks(pj, cj_, cones_j):
    ops_j = condensed_operators(cj_, np.asarray(pj.A), np.asarray(pj.B),
                                pj.horizon)
    ppj = fj.pad_problem(pj, cj_, ops_j)
    return ppj, fj.pad_cones(ppj, cones_j)


def _ten_cones(mod):
    return mod.ConeSet(
        input_cones=tuple(mod.Cone((i,), (i + 1) % 4, 2.0, 1.0)
                          for i in range(4)),
        state_cones=(mod.Cone(tuple(range(10)), 10, 5.0, 1.0),)
        + tuple(mod.Cone((k,), k + 1, 3.0, 2.0) for k in range(5)))


@pytest.fixture(scope="module")
def coned_pairs():
    """(name, dims, JAX padded problem and cone ops, the port's cone ops)
    for the lander's two cones and the ten cones on the quadrotor."""
    pj, cache_j, cones_j, pt, cache_t, cones_t = lander_pair(LANDER[2])
    ppj, cops_j = _jax_masks(pj, cache_j, cones_j)
    _, ppt = torch_pp(pt, cache_t)
    out = [("lander", LANDER, ppj, cops_j, ft.pad_cones(ppt, cones_t))]
    qj, qcache_j, _x0 = quadrotor_hovering_setup()
    qppj, qcops_j = _jax_masks(qj, qcache_j, _ten_cones(cj))
    _, qppt = torch_pp(problem_to_torch(qj), cache_to_torch(qcache_j))
    out.append(("ten cones", FLAGSHIP, qppj, qcops_j,
                ft.pad_cones(qppt, _ten_cones(ct))))
    return out


def _table_rows(cops):
    """The port's device table decoded: per cone ``(nball, axis, ball)``,
    input cones first, as the kernels read it (offsets, then rows)."""
    tab = cops.table.tolist()
    n = cops.nc_u + cops.nc_x
    rows = []
    for q in range(n):
        o = tab[q]
        rows.append((tab[o], tab[o + 1], tuple(tab[o + 2:o + 2 + tab[o]])))
    return rows


@pytest.mark.parametrize("case", [0, 1], ids=["lander", "ten_cones"])
def test_the_device_table_holds_the_jax_masks(coned_pairs, case):
    # what the fused pass reads per cone (ball, axis, mu, shift) is, knot by
    # knot, what the JAX package's masks hold for instance 0
    _name, dims, ppj, cops_j, cops_t = coned_pairs[case]
    nx, nu, N = dims
    rows = _table_rows(cops_t)
    par = np.asarray(cops_t.params.tolist()).reshape(-1, 2)
    for kind, nc, dim, knots, vec in (
            ("u", cops_t.nc_u, nu, N - 1, cops_j.cu_vec),
            ("x", cops_t.nc_x, nx, N, cops_j.cx_vec)):
        vec = np.asarray(vec)
        for ci in range(nc):
            q = ci if kind == "u" else cops_t.nc_u + ci
            nball, axis, ball = rows[q]
            assert nball == len(ball)
            axis_mask = np.zeros(knots * dim)
            ball_mask = np.zeros(knots * dim)
            shift = np.zeros(knots * dim)
            for k in range(knots):
                axis_mask[k * dim + axis] = 1.0
                shift[k * dim + axis] = par[q, 1]
                ball_mask[[k * dim + b for b in ball]] = 1.0
            w = knots * dim
            np.testing.assert_array_equal(vec[ci * 8 + 0, :w], axis_mask)
            np.testing.assert_array_equal(vec[ci * 8 + 1, :w], ball_mask)
            np.testing.assert_allclose(vec[ci * 8 + 2, :w], shift, rtol=1e-7)
            np.testing.assert_allclose(vec[ci * 8 + 3, :w], par[q, 0],
                                       rtol=1e-7)


@pytest.mark.parametrize("case", [0, 1], ids=["lander", "ten_cones"])
@pytest.mark.parametrize("tile", [56, 8])
def test_each_jax_cone_lies_in_one_warp_that_lists_its_knot(
        coned_pairs, case, tile):
    # every cone's ball and axis entries at every knot (the JAX masks of
    # instance 0) are owned by one run, which lists the knot: the warp that
    # projects the knot reads and writes only its own slacks
    _name, dims, _ppj, cops_j, cops_t = coned_pairs[case]
    nx, nu, N = dims
    Dx = N * nx
    items = ft.cone_items(dims, tile, 8, cops_t.nc_u > 0, cops_t.nc_x > 0)
    run = _owners(items, dims, tile, 8)
    listed = {(g, first): r for r, ks in enumerate(_run_knots(items))
              for g, first in ks}
    for nc, dim, knots, vec, base in (
            (cops_t.nc_u, nu, N - 1, cops_j.cu_vec, Dx),
            (cops_t.nc_x, nx, N, cops_j.cx_vec, 0)):
        vec = np.asarray(vec)
        for ci in range(nc):
            touched = np.flatnonzero(vec[ci * 8] + vec[ci * 8 + 1])
            touched = touched[touched < knots * dim]
            for k in range(knots):
                cols = base + touched[touched // dim == k]
                first = base + k * dim
                for g in range(tile // 8):
                    assert set(run[g, cols]) == {listed[(g, first)]}


def test_which_path_each_launch_takes(coned_pairs, monkeypatch):
    _name, dims, _ppj, _cj, cops = coned_pairs[0]
    assert ft.cone_path(dims, 56, 8, None) is None
    assert ft.cone_path(dims, 56, 8, cops) == "fused"
    assert ft.cone_path(dims, 56, 8, cops, algo="bf16x3") == "three-pass"
    wide = ft.FusedConeOps(mu=torch.ones(1), shift=torch.zeros(1), nc_x=1)
    assert ft.cone_path((130, 2, 3), 8, 8, wide) == "three-pass"
    monkeypatch.setattr(ft, "FUSED_CONES", False)
    assert ft.cone_path(dims, 56, 8, cops) == "three-pass"
    assert ft._cone_items_arg(cops, dims, 56, 8, "f32", "cpu")[:2] == (None, 0)
    monkeypatch.setattr(ft, "FUSED_CONES", True)
    _ptr, chunks, items = ft._cone_items_arg(cops, dims, 56, 8, "f32", "cpu")
    assert chunks == 8 and torch.equal(
        items, torch.as_tensor(ft.cone_items(dims, 56, 8, True, True)))
    assert ft._cone_items_arg(cops, dims, 56, 8, "bf16x3", "cpu")[:2] == (
        None, 0)


def _c_params(src: str, fn: str) -> list[str]:
    body = re.search(rf"int {fn}\((.*?)\)\s*{{", src, re.S).group(1)
    return [p.strip() for p in body.split(",")]


@pytest.mark.parametrize("fn, argtypes", [
    ("atm_fused_solve", ft._SOLVE_ARGTYPES),
    ("atm_fused_rollout", ft._ROLLOUT_ARGTYPES)])
def test_ctypes_signatures_follow_the_c_entries(fn, argtypes):
    # a pointer for every pointer (the items among them), an int for every
    # int and a float for every float, in order: ctypes would pass a pointer
    # declared as an int cut to 32 bits
    src = (pathlib.Path(ft.__file__).parent / "csrc" /
           "fused_entry.cuh").read_text()
    params = _c_params(src, fn)
    kinds = ["p" if "*" in p else "f" if p.startswith("float") else "i"
             for p in params]
    want = ["p" if t is ft._P else "f" if t is ft._F else "i"
            for t in argtypes]
    assert kinds == want
    assert any("cone_items" in p for p in params)
