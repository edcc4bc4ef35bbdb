"""PyTorch port, fused kernels' layout on the CPU.

The fused CUDA kernels (``ops/csrc/admm_iteration.cuh``) keep per-instance
slots in shared memory and compute their products by FP32 FMA from 8 x 4
register tiles (4 x 4 where one tile of 8 slots does not fit). The card is
needed to run them; here are checked the shared-memory layout the wrapper
mirrors, the tiles it chooses and the launch counters' names. No JAX and no
Pallas kernel: well under a second."""

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


@pytest.mark.parametrize("N, placement, tile", [
    (10, "shared", 48), (18, "shared", 8), (20, "device", 32),
    (64, "device", 8), (78, "device", 8)])
def test_operators_stay_in_shared_memory_where_they_fit(N, placement, tile):
    # the quadrotor: its operators fit beside one register tile up to N=18;
    # past that the kernels read them from device memory and shared memory
    # holds the bounds and the per-slot state alone
    dims = (12, 4, N)
    assert ft.choose_placement(dims) == placement
    assert ft.choose_tile(dims, 65536) == tile
    Dz, Du = N * 12 + (N - 1) * 4, (N - 1) * 4
    r4 = lambda n: (n + 3) & ~3
    operators = 4 * (2 * r4(Du) * r4(Dz) + 12 * r4(Dz))   # Wf, Wb, Wx
    for t in (8, tile):
        assert (ft.kernel_smem_bytes(*dims, t) - operators
                == ft.kernel_smem_bytes(*dims, t, placement="device"))
        assert ft.kernel_smem_bytes(*dims, t, placement=placement) \
            <= ft.SMEM_LIMIT_BYTES
    assert (ft.kernel_smem_bytes(*dims, 8) <= ft.SMEM_LIMIT_BYTES) == (N <= 18)


def test_past_one_register_tile_of_state_the_fused_tier_refuses():
    # N=151: 4 slots of per-slot state alone exceed a block's shared memory
    # (8 slots already at N=79, where the 4-slot tile takes over); the
    # message gives the bytes and the JAX package's boundary (its 12 MB VMEM
    # sizing takes the quadrotor to N=129, the lander to N=213)
    need = ft.kernel_smem_bytes(12, 4, 151, 4, placement="device")
    assert need == 232_800 > ft.SMEM_LIMIT_BYTES
    assert ft.kernel_smem_bytes(12, 4, 79, 8, placement="device") == 233_552
    assert ft.choose_tile((12, 4, 150), 65536) == 4
    with pytest.raises(ValueError, match=f"needs {need} bytes.*N=129"):
        ft.choose_tile((12, 4, 151), 65536)
    assert ft.tpu_horizon_limit(12, 4) == 129
    assert ft.tpu_horizon_limit(6, 3) == 213
    assert ft.choose_placement((6, 3, 261)) == "device"    # the lander
    with pytest.raises(ValueError, match="N=213"):
        ft.choose_placement((6, 3, 262))
    with pytest.raises(ValueError, match="operators in shared memory"):
        ft.choose_tile((12, 4, 20), 65536, placement="shared")
    with pytest.raises(ValueError, match="4 with the operators in device"):
        ft.choose_tile((12, 4, 10), 65536, placement="shared", register_tile=4)


@pytest.mark.parametrize("dims, ri", [
    ((12, 4, 78), 8), ((12, 4, 79), 4), ((12, 4, 100), 4), ((12, 4, 129), 4),
    ((6, 3, 135), 8), ((6, 3, 213), 4), ((12, 4, 10), 8)])
def test_register_tile_follows_the_sizing(dims, ri):
    # 8 slots a register tile wherever one such tile fits (every shape that
    # ran before keeps its kernel); 4 only where 8 do not fit even with the
    # operators in device memory
    assert ft.choose_register_tile(dims) == ri
    tile = ft.choose_tile(dims, 65536)
    assert tile % ri == 0
    placement = ft.choose_placement(dims)
    assert ft.kernel_smem_bytes(*dims, tile, placement=placement) \
        <= ft.SMEM_LIMIT_BYTES
    if ri == 4:
        assert placement == "device" and tile == 4
        assert ft.kernel_smem_bytes(*dims, 8, placement="device") \
            > ft.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("nx, nu, jax_limit, port_limit", [
    (12, 4, 129, 150), (6, 3, 213, 261), (4, 1, 448, 491), (8, 3, 171, 217),
    (5, 2, 257, 340), (6, 8, 97, 156), (16, 8, 80, 97), (32, 12, 43, 53),
    (1, 1, 769, 1114)])
def test_every_horizon_of_the_jax_fused_tier_is_taken(nx, nu, jax_limit,
                                                      port_limit):
    # the JAX package's fused tier takes these widths up to jax_limit (its
    # VMEM sizing, copied in tpu_horizon_limit); the port takes every one of
    # those horizons and refuses first at port_limit + 1
    assert ft.tpu_horizon_limit(nx, nu) == jax_limit
    for N in range(2, port_limit + 1):
        assert ft.choose_tile((nx, nu, N), 65536) >= 4
    with pytest.raises(ValueError, match=f"N={jax_limit}"):
        ft.choose_tile((nx, nu, port_limit + 1), 65536)


def test_kernel_operands_come_padded_to_float4_rows():
    # Wf, Wb, Wx as the kernels read them, staged or in place: zero rows
    # and columns up to multiples of 4 (nx=6, nu=3, N=15: Du = 42 -> 44)
    import accelerated_tinympc_tpu_torch as atm

    prob, rho = atm.models.random_lti_problem(3, 6, 3, 15, device="cpu")
    cache = atm.riccati_cache(prob.A, prob.B, prob.Q, prob.R, rho,
                              device="cpu")
    ops = atm.condensed_operators(cache, prob.A, prob.B, 15, device="cpu")
    pp = ft.pad_problem(prob, cache, ops, device="cpu")
    assert (pp.Du, pp.Dx) == (42, 90)
    assert pp.W_f.shape == (44, 132) and pp.W_b.shape == (132, 44)
    assert pp.W_x.shape == (6, 132)
    assert torch.equal(pp.W_f[:42, :90], pp.W_fd)
    assert torch.equal(pp.W_f[:42, 90:], pp.W_gd)
    assert torch.equal(pp.W_b[:, :42], torch.cat([pp.W_q, pp.W_r]))
    assert not pp.W_f[42:].any() and not pp.W_b[:, 42:].any()
