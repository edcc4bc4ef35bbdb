// Split-bf16 fused ADMM kernels for Hopper (sm_90a): the fused kernels of
// fused_admm.cu with the JAX package's algo="bf16x3" arithmetic.
//
// Replaces the split-operand mode of the TPU kernels
// (accelerated_tinympc_tpu/ops/fused_admm.py _kernel_fixed / _kernel_adaptive
// with algo="bf16x3": _split_bf16, _dot3, _make_ws, the schedules of
// _fixed_core and _adaptive_core; ops/fused_rollout.py _kernel_rollout per
// tick; _cone_apply in the coned instantiations). The same eight kernels as
// fused_admm.cu, each named with _bf16x3, built from the same body
// (admm_iteration.cuh, SPLIT = true): a split iteration runs both products
// as three bf16 passes, hi.hi + (hi.lo + lo.hi) with float32 accumulators,
// on the tensor cores (mma.sync m16n8k16, split_item); every other
// iteration, the x0 products and the frozen slots' results run the float32
// kernels' FFMA arithmetic. A fixed solve splits its first max_iter -
// max(1, polish) iterations (n3), an adaptive one every iteration but its
// checks past the warmup and the one at the cap. Each launch first splits
// the operators into fragment order in device memory
// (split_operators_kernel, fused_entry.cuh). The forward fragments are read
// from there (resident in L2); with the operators in shared memory the
// backward fragments are staged in place of the float32 Wb and Wx, which a
// split launch reads from device memory instead, so shared memory is the
// float32 kernels' layout with those swapped plus one flag per slot, and a
// split kernel runs as many slots per block as its float32 twin (48 at the
// flagship, 56 on the lander).
//
// What bounds it on this card: operations, as the float32 kernels; the
// split iterations' products at the dense bf16 tensor rate (three passes),
// the float32 ones at the FFMA rate. With one block of eight warps a SM
// the mma are latency-bound, so the design keeps many in flight: a warp
// sums several tiles at once (2 x 2 in the forward product, 3 x 1 in the
// backward one) with no branch between their mma, two k-steps a loop
// pass, and a split slot's elementwise stage runs in the warp that summed
// its product, beside the float32 slots' stage, with no barrier between.
// With no split iteration (polish >= max_iter, or check_every 1 without
// warmup) a launch gives the float32 kernel's bits at the same geometry.

#define ATM_SPLIT 1
#include "fused_entry.cuh"
