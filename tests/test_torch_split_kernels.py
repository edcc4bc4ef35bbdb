"""PyTorch port, the split-bf16 fused kernels' layout and their card tools,
on the CPU.

The split kernels (``ops/csrc/fused_admm_bf16x3.cu``) read the forward
operator's fragments from device memory and stage the backward operator's
in place of the float32 Wb and Wx, so a block holds as many slots as its
float32 twin's (the layout's bytes: tests/test_torch_bf16x3.py). Here:
that slot count, and that the card tools still find the kernel body's text
they work on (the planted faults of tools/torch_bf16x3_faults.py, the
stage hooks of tools/torch_fused_stage_clocks.py). No JAX, no card: well
under a second."""

import importlib.util
import pathlib

import pytest

from accelerated_tinympc_tpu_torch.ops import fused_admm as ft

ROOT = pathlib.Path(__file__).resolve().parents[1]
BODY = ROOT / "accelerated_tinympc_tpu_torch" / "ops" / "csrc" / \
    "admm_iteration.cuh"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  ROOT / "tools" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dims, ncp, slots", [
    ((12, 4, 10), 0, 48),      # the flagship quadrotor
    ((6, 3, 15), 0, 56),       # the lander, static cone parameters
    ((6, 3, 15), 2, 56),       # its two cones with per-instance rows
    ((12, 4, 18), 0, 8),       # the longest horizon with staged operators
    ((12, 4, 40), 0, 16),      # operators in device memory
])
def test_split_kernels_run_the_float32_kernels_slots(dims, ncp, slots):
    # with the forward fragments in device memory and the backward ones in
    # place of Wb and Wx, a split kernel's block holds as many slots as its
    # float32 twin's, at the same placement
    for split in (False, True):
        assert ft.choose_tile(dims, 65536, ncp=ncp, split=split) == slots
        assert ft.choose_placement(dims, ncp=ncp, split=split) \
            == ft.choose_placement(dims, ncp=ncp)


def test_every_planted_fault_finds_its_text_once():
    # tools/torch_bf16x3_faults.py plants each fault by text substitution
    # in the kernel body and stops if a text is not found exactly once
    faults = _tool("torch_bf16x3_faults.py").FAULTS
    body = BODY.read_text()
    assert len(faults) == 9 and faults["sound"] == []
    for name, subs in faults.items():
        for old, new in subs:
            assert body.count(old) == 1, name
            assert body.replace(old, new) != body


def test_stage_clock_hooks_are_in_the_body(tmp_path):
    # tools/torch_fused_stage_clocks.py defines the body's stage hooks in
    # a copy of the package (the body's own definitions are empty)
    clk = _tool("torch_fused_stage_clocks.py")
    clk.instrumented_copy(ROOT, tmp_path)
    csrc = tmp_path / "accelerated_tinympc_tpu_torch" / "ops" / "csrc"
    for cu in ("fused_admm.cu", "fused_admm_bf16x3.cu"):
        text = (csrc / cu).read_text()
        assert text.startswith(clk.HOOK_DEFS) and "atm_clocks" in text
    body = BODY.read_text()
    for hook in ("ATM_CLK_BEGIN();", "ATM_CLK_MARK();", "ATM_CLK_END();",
                 "ATM_SCLK_END(initial);"):
        assert body.count(hook) == 1, hook
    for k in list(clk.BLOCK.values()) + list(clk.WARP.values()):
        assert f"CLK({k});" in body, k
