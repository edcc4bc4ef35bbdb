"""PyTorch port, K1's own body (``csrc/fixed_waves.cuh``: the fixed box-only
float32 solve, the slots of a block in lockstep with each thread's iterates
in its registers) on the CPU: the wrapper's mirror of its shared-memory
layout, the geometry and the path each shape takes, that every horizon the
JAX fused tier takes still gets a K1 kernel, that the card tools still find
the text they work on, and K1's plain version against the JAX package's
fused solve at the shapes the new body takes. The kernel itself runs only
on the card (``tests/test_torch_gpu.py -k fixed``)."""

import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
from accelerated_tinympc_tpu.ops import fused_admm as fj
from accelerated_tinympc_tpu.precompute import (
    condensed_operators as condensed_operators_j,
    riccati_cache as riccati_cache_j,
)
from accelerated_tinympc_tpu_torch.ops import fused_admm as ft

from torch_parity_utils import (
    DEV, assert_fused_close, cache_to_torch, lander_pair, perturbed_x0,
    problem_to_torch, torch_pp, LANDER_X0,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "accelerated_tinympc_tpu_torch" / "ops" / "csrc"
WAVES = CSRC / "fixed_waves.cuh"

QUAD, LANDER, RLTI = (12, 4, 10), (6, 3, 15), (6, 8, 12)
SHAPES = [QUAD, LANDER, (12, 4, 18), (12, 4, 19), (12, 4, 40), (12, 4, 78),
          (12, 4, 79), (12, 4, 129), RLTI]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  ROOT / "tools" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _c_wave_words(dims, tile, placement):
    """The words of ``make_wave_layout`` in fixed_waves.cuh, evaluated from
    its own text (one ``L.<region> = o; o += <words>;`` line a region)."""
    nx, nu, N = dims
    r4 = lambda n: (n + 3) & ~3
    Dx, Du = N * nx, (N - 1) * nu
    names = dict(DuP=r4(Du), DzP=r4(Dx + Du), nx=nx, t=tile, r4=r4,
                 staged=int(placement == "shared"))
    body = WAVES.read_text().split("make_wave_layout", 1)[1].split("}", 1)[0]
    regions = re.findall(r"L\.(\w+) = o;\s+o \+= ([^;]+);", body)
    assert [r for r, _ in regions] == ["Wf", "Wb", "lo", "hi", "cd", "D", "S",
                                       "x0", "res", "wave"]
    return sum(eval(w.replace("d.", ""), {}, names) for _, w in regions)


def test_the_wave_layout_mirrors_the_kernel():
    # the wrapper's bytes are the kernel's (the C entry refuses a launch
    # when they disagree); a slot holds D, S, x0 and four maxima: 832 bytes
    # at the flagship against the shared body's 3,548
    for dims in SHAPES:
        for tile in (8, 16, 48, 56):
            for pl in ft.PLACEMENTS:
                assert ft.fixed_smem_bytes(*dims, tile, pl) == \
                    4 * _c_wave_words(dims, tile, pl), (dims, tile, pl)
    assert ft.fixed_smem_bytes(*QUAD, 48) == 86_272
    per_slot = ft.fixed_smem_bytes(*QUAD, 56) - ft.fixed_smem_bytes(*QUAD, 48)
    assert per_slot == 8 * 832
    assert ft.kernel_smem_bytes(*QUAD, 56) - ft.kernel_smem_bytes(*QUAD, 48) \
        == 8 * 3_548


# (dims, batch) -> (slots a block, threads, placement, register tile, path)
GEOMETRY = {
    (QUAD, 65536): (48, 256, "shared", 8, "waves"),
    (QUAD, 4099): (32, 256, "shared", 8, "waves"),
    (QUAD, 37): (8, 128, "shared", 8, "waves"),
    (QUAD, 1): (8, 128, "shared", 8, "waves"),
    (LANDER, 65536): (56, 256, "shared", 8, "waves"),
    (LANDER, 4099): (32, 256, "shared", 8, "waves"),
    (RLTI, 1027): (8, 128, "shared", 8, "waves"),
    ((12, 4, 18), 65536): (8, 128, "shared", 8, "waves"),
    ((12, 4, 19), 65536): (32, 256, "device", 8, "slots"),
    ((12, 4, 19), 37): (8, 128, "device", 8, "waves"),
    ((12, 4, 40), 4099): (16, 256, "device", 8, "slots"),
    ((12, 4, 78), 4099): (8, 128, "device", 8, "slots"),
    ((12, 4, 79), 4099): (4, 256, "device", 4, "slots"),
    ((12, 4, 129), 4099): (4, 256, "device", 4, "slots"),
}


def test_the_slots_threads_and_path_of_each_shape():
    # K1's own body takes the shared body's geometry (so the backward
    # product's depth split, and the bits, are the same) wherever every
    # forward item of a block, 8 slots by 4 columns of z, has a thread:
    # the flagship, the lander and short horizons; the shared body keeps
    # the rest
    for (dims, batch), want in GEOMETRY.items():
        tile, threads, _smem, placement, ri = ft.geometry(dims, batch)
        path = ft.fixed_path(dims, tile, threads, ri)
        assert (tile, threads, placement, ri, path) == want, (dims, batch)
        nx, nu, N = dims
        items = (tile // ri) * ((N * nx + (N - 1) * nu + 3) // 4)
        assert (path == "waves") == (ri == 8 and items <= threads)


def test_every_horizon_of_the_jax_fused_tier_still_gets_a_k1_kernel():
    # up to the JAX package's fused limit (N=129 for the quadrotor, 213 for
    # the lander), every batch gets a launch of one of the two bodies that
    # fits shared memory, and the new body only with one item a thread
    for nx, nu in ((12, 4), (6, 3), (6, 8)):
        for N in range(2, ft.tpu_horizon_limit(nx, nu) + 1):
            dims = (nx, nu, N)
            for batch in (1, 4099, 65536):
                tile, threads, smem, placement, ri = ft.geometry(dims, batch)
                path = ft.fixed_path(dims, tile, threads, ri)
                assert smem <= ft.SMEM_LIMIT_BYTES
                if path == "waves":
                    assert ri == 8 and threads <= ft.MAX_THREADS
                    assert ft.fixed_smem_bytes(*dims, tile, placement) < smem
                else:
                    assert path == "slots"


def test_the_path_follows_the_mode_the_flag_and_the_register_tile(
        monkeypatch):
    assert ft.fixed_path(QUAD, 48, 256, 8) == "waves"
    assert ft.fixed_path(QUAD, 48, 256, 8, algo="bf16x3") == "slots"
    assert ft.fixed_path(QUAD, 56, 256, 8) == "slots"   # 273 items
    assert ft.fixed_path(QUAD, 8, 32, 8) == "slots"     # 39 items
    assert ft.fixed_path((12, 4, 40), 4, 256, 4) == "slots"
    assert ft.fixed_path(QUAD, 48, 256, 8, alpha=1.6) == "slots"
    monkeypatch.setattr(ft, "FIXED_WAVES", False)
    assert ft.fixed_path(QUAD, 48, 256, 8) == "slots"
    # the C side: the same rule, and the entry's path argument
    text = WAVES.read_text()
    assert ("d.ri == 8 && d.split == 0 && alpha == 1.0f &&\n"
            "         (d.tile / 8) * (d.DzP / TJ) <= threads") in text
    entry = (CSRC / "fused_entry.cuh").read_text()
    assert "int waves, uint32_t* w3" in entry
    assert "launch_waves(a, threads, smem_bytes, st)" in entry
    assert "wave_fits(a.d, threads, a.alpha)" in entry
    # the depth split of the main geometries, and the instantiations
    # compiled for the quadrotor's and the lander's widths at them
    splits = {(QUAD, 48, 256): 4, (QUAD, 32, 256): 4, (QUAD, 8, 128): 8,
              (LANDER, 56, 256): 2, (LANDER, 32, 256): 4}
    for (dims, tile, threads), H in splits.items():
        assert ft.backward_split(dims, tile, threads, 8) == H
    for shape in ("36, 156, 4", "36, 156, 8", "44, 132, 2", "44, 132, 4"):
        assert f"ATM_WAVE_SHAPE({shape})" in entry


def test_stage_clock_hooks_are_in_the_wave_body(tmp_path):
    # tools/torch_fused_stage_clocks.py clocks the new body with the shared
    # body's counters: forward (0), backward (3), the wave boundary in place
    # of the refill (4), iterations (7), the warps' products (11, 13), and
    # the slot spans per warp and wave (write-out, then loads)
    clk = _tool("torch_fused_stage_clocks.py")
    body = WAVES.read_text()
    for hook in ("ATM_CLK_BEGIN();", "ATM_CLK_MARK();", "ATM_CLK_END();",
                 "ATM_SCLK_BEGIN();", "ATM_SCLK_MID();"):
        assert body.count(hook) == 1, hook
    for k in (clk.BLOCK["forward"], clk.BLOCK["backward"],
              clk.BLOCK["refill"], clk.WARP["w_forward"],
              clk.WARP["w_backward"]):
        assert f"CLK({k});" in body, k
    assert f"ATM_CLK_COUNT({clk.ITERS});" in body
    assert "ATM_SCLK_END(false);" in body
    # the instrumented copy's fused_admm.cu reaches the header
    clk.instrumented_copy(ROOT, tmp_path)
    csrc = tmp_path / "accelerated_tinympc_tpu_torch" / "ops" / "csrc"
    assert (csrc / "fixed_waves.cuh").read_text() == body
    assert '#include "fixed_waves.cuh"' in (csrc / "fused_entry.cuh").read_text()


def test_the_clock_variants_find_their_text_once():
    # the throwaway variants of the shared body and of the new one
    # (--variants) are text substitutions, each found exactly once, or the
    # tool stops
    clk = _tool("torch_fused_stage_clocks.py")
    assert sorted(clk.VARIANTS) == ["no_dispatch", "no_products",
                                    "registers", "wave_adjacent_lanes",
                                    "wave_runtime_widths"]
    for name, subs in clk.VARIANTS.items():
        for sub in subs:
            src = sub[0] if len(sub) == 3 else "admm_iteration.cuh"
            old, new = sub[-2:]
            assert (CSRC / src).read_text().count(old) == 1, name
            assert old != new


def _jax_vs_port(pj, cj, pt, ct, x0, batch, **kw):
    ops_j = condensed_operators_j(cj, np.asarray(pj.A), np.asarray(pj.B),
                                  pj.horizon)
    ppj = fj.pad_problem(pj, cj, ops_j)
    _ops, ppt = torch_pp(pt, ct)
    x0s = perturbed_x0(x0, batch, seed=3, spread=0.2).astype(np.float32)
    want = fj.fused_solve(jnp.asarray(x0s), fj.FusedCarry.zeros(batch, ppj),
                          ppj, batch_tile=batch, interpret=True, **kw)
    got = ft.fused_solve(torch.as_tensor(x0s),
                         ft.FusedCarry.zeros(batch, ppt, device=DEV), ppt,
                         **kw)
    return got, want, ppt


@pytest.mark.parametrize("shape", ["lander", "random_lti"])
def test_k1_matches_the_jax_fused_solve_at_the_wave_shapes(shape):
    # K1's plain version (what fused_solve runs on the CPU) against the JAX
    # package's fused solve in interpret mode, at shapes the new body takes
    # on the card (the flagship is tests/test_torch_fused.py's): the lander
    # box-only, fixed 30; random_lti 6/8/12, fixed 20; U, X and the carries
    # within 1e-4 (the JAX tests' bar between float32 tiers), iteration
    # counts and solved flags equal
    if shape == "lander":
        pj, cj, _cones, pt, ct, _ = lander_pair(15)
        x0, kw = LANDER_X0, dict(max_iter=30, check_termination=0)
    else:
        pj, rho = atm_j.models.random_lti_problem(3, 6, 8, 12)
        cj = riccati_cache_j(pj.A, pj.B, pj.Q, pj.R, rho)
        pt, ct = problem_to_torch(pj), cache_to_torch(cj)
        x0 = np.zeros(6)
        kw = dict(max_iter=20, check_termination=0)
    got, want, ppt = _jax_vs_port(pj, cj, pt, ct, x0, 8, **kw)
    assert ft.fixed_path(ppt.dims, 8, 128, 8) == "waves"
    assert_fused_close(got, want, ppt.dims, atol=1e-4, label=shape + " ")
    np.testing.assert_array_equal(got.stats[:, :2].numpy(),
                                  np.asarray(want.stats)[:, :2])
