"""CUDA kernels (the fused hot path) with their plain PyTorch versions."""

from .fused_admm import (  # noqa: F401
    LAUNCH_COUNTS,
    FusedCarry,
    FusedResult,
    PaddedProblem,
    fused_solve,
    fused_solve_plain,
    pad_problem,
    ref_vectors,
    reset_launch_counts,
    unpad_controls,
    unpad_states,
)
from .fused_rollout import (  # noqa: F401
    RolloutOps,
    RolloutResult,
    fused_rollout,
    fused_rollout_plain,
    rollout_const_seq,
    rollout_ops,
)
