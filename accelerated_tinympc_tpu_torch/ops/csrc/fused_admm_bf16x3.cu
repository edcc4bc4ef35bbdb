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
// on the tensor cores (mma.sync m16n8k16, split_product); every other
// iteration, the x0 products and the frozen slots' results run the float32
// kernels' FFMA arithmetic. A fixed solve splits its first max_iter -
// max(1, polish) iterations (n3), an adaptive one every iteration but its
// checks past the warmup and the one at the cap. Each launch first splits
// the operators into fragment order in device memory
// (split_operators_kernel, fused_entry.cuh); with the operators in shared
// memory each block stages the fragments beside them.
//
// What bounds it on this card: operations, as the float32 kernels; the
// split iterations' products at the dense bf16 tensor rate (three passes),
// the float32 ones at the FFMA rate. With no split iteration (polish >=
// max_iter, or check_every 1 without warmup) a launch gives the float32
// kernel's bits at the same geometry.

#define ATM_SPLIT 1
#include "fused_entry.cuh"
