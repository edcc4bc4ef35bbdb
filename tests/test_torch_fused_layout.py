"""PyTorch port, fused kernels' layout on the CPU.

The fused CUDA kernels (``ops/csrc/admm_iteration.cuh``) keep per-instance
slots in shared memory and compute their products by FP32 FMA from 8 x 4
register tiles. The card is needed to run them; here are checked the
shared-memory layout the wrapper mirrors, the tile it chooses and the launch
counters' names. No JAX and no Pallas kernel: well under a second."""

import pathlib
import re

import pytest
import torch

from accelerated_tinympc_tpu_torch.ops import fused_admm as ft

FLAGSHIP = (12, 4, 10)
LANDER = (6, 3, 15)


def test_smem_bytes_of_the_flagship_layout():
    # make_layout, region by region, at 48 slots (words):
    words = (36 * 156 + 156 * 36 + 12 * 156     # Wf, Wb, Wx
             + 2 * 156 + 144 + 48                 # lo, hi, A and B of the plant
             + 2 * 48 * 36 + 5 * 48 * 156         # D, cd; S, YG, ZV x2, Xb
             + 48 * 12 + 48 * 4 + 48 * 6 + 48 * 4  # x0, u0, stats, residuals
             + 9 * 48 + 4)                        # per-slot ints, nref
    assert ft.kernel_smem_bytes(*FLAGSHIP, 48) == 4 * words == 224_752
    # per-instance cone rows: two (ncp, tile) float arrays
    assert (ft.kernel_smem_bytes(*LANDER, 48, ncp=2)
            - ft.kernel_smem_bytes(*LANDER, 48)) == 4 * 2 * 2 * 48


@pytest.mark.parametrize("dims, fit", [(FLAGSHIP, 48), (LANDER, 56)])
def test_choose_tile_rounds_to_the_register_tile(dims, fit):
    tile = ft.choose_tile(dims, 65536)
    assert tile == fit and tile % ft.REGISTER_TILE == 0
    assert ft.kernel_smem_bytes(*dims, tile) <= ft.SMEM_LIMIT_BYTES
    assert ft.kernel_smem_bytes(*dims, tile + ft.REGISTER_TILE) > \
        ft.SMEM_LIMIT_BYTES
    assert ft.choose_tile(dims, 1) == ft.REGISTER_TILE      # one register tile
    assert ft.choose_tile(dims, 132 * 20) == 24         # spread over the SMs
    assert ft.choose_tile((6, 8, 12), 10 ** 6) == 24    # wide operators


def test_smem_bytes_of_the_lander_layout():
    # Dx = 90, Du = 42: Du pads to 44 (float4 rows), Dz = 132 does not pad
    words = (44 * 132 + 132 * 44 + 6 * 132       # Wf, Wb, Wx
             + 2 * 132 + 36 + 20                  # lo, hi, A (6x6), B (6x3 -> 20)
             + 2 * 56 * 44 + 5 * 56 * 132         # D, cd; S, YG, ZV x2, Xb
             + 56 * 6 + 56 * 3 + 56 * 6 + 56 * 4  # x0, u0, stats, residuals
             + 9 * 56 + 4)                        # per-slot ints, nref
    assert ft.kernel_smem_bytes(*LANDER, 56) == 4 * words == 224_752


@pytest.mark.parametrize("batch, tile", [
    (132 * 8, 8), (132 * 8 + 1, 16), (132 * 40, 40), (10 ** 6, 48)])
def test_choose_tile_spreads_the_batch_over_the_sms(batch, tile):
    # the least multiple of the register tile that gives every SM a block,
    # up to what fits shared memory (48 slots at the flagship)
    assert ft.choose_tile(FLAGSHIP, batch) == tile


def test_launch_counts_name_every_fused_kernel():
    # one counter per instantiation in fused_admm.cu, each named after it
    src = (pathlib.Path(ft.__file__).parent / "csrc" / "fused_admm.cu")
    kernels = set(re.findall(r"^ATM_KERNEL\((\w+)_kernel,", src.read_text(),
                             re.M))
    assert len(kernels) == 8 and set(ft.LAUNCH_COUNTS) == kernels
    before = dict(ft.LAUNCH_COUNTS)
    counter = ft.work_counter("cpu")     # zero at every launch
    assert counter.dtype == torch.int32 and counter.tolist() == [0]
    assert ft.LAUNCH_COUNTS == before
