// Fused ADMM kernels for Hopper (sm_90a): the whole batched solve, or a whole
// receding-horizon mission, in one launch. The kernels share the iteration
// body in admm_iteration.cuh (see the design note there: persistent blocks
// of per-instance slots fed by a work counter, FP32 FMA products from
// register tiles); the fixed box-only solve has a body of its own,
// fixed_waves.cuh (waves of slots in lockstep, each thread's iterates in
// its registers), wherever a block's forward items fit its threads, and
// the shared body elsewhere, to the same bits:
//
//   fused_solve_fixed_kernel     replaces accelerated_tinympc_tpu/ops/
//                                fused_admm.py _kernel_fixed
//   fused_solve_adaptive_kernel  replaces fused_admm.py _kernel_adaptive
//   fused_rollout_kernel         replaces ops/fused_rollout.py
//                                _kernel_rollout (adaptive tick solves;
//                                fused_rollout_fixed_kernel the fixed ones)
//
// Each has a second instantiation with second-order cones in the slack stage
// (template parameter CONES; replaces fused_admm.py _cone_apply, which the
// TPU kernels close over when cone operands are given): the cone projections
// and the dual ascent run in the forward stage's pass, each warp over whole
// knots (cone_forward_stage, the items from the wrapper), so a coned
// iteration has the box-only one's barriers. The box-only instantiations
// contain no cone code. Every kernel is a template over the
// operators' placement (GOPS: staged in shared memory, or read from device
// memory where they do not fit beside one register tile of slots); both
// placements of a kernel share its name and its launch counter. A third
// instantiation, with the operators in device memory and register tiles of
// 4 slots (RI = 4), takes the horizons where one tile of 8 slots' state does
// not fit shared memory; it counts under the same name too.
//
// All are bound by operations (FP32 FMA), not bytes: global memory is read
// once and written once per solve; the rollout writes one u0/iteration trace
// row per tick and keeps the (x0, D, Z, V) carry of an instance in its slot
// across ticks (the TPU kernel's sequential tick grid dimension becomes a
// per-slot tick counter).
//
// Plain C interface (loaded with ctypes). Every entry launches on the given
// stream, does not synchronise, allocates nothing (the work counter is the
// caller's, zeroed before the launch), and returns cudaGetLastError() (or -1
// when the caller's launch geometry does not match the kernel's own
// shared-memory layout).

#define ATM_SPLIT 0
#include "fused_entry.cuh"
