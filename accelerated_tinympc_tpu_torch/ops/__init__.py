"""CUDA kernels (the fused hot path, the hetero fleets, the long-horizon
stream and hstream tiers) with their plain PyTorch versions."""

from .fused_admm import (  # noqa: F401
    LAUNCH_COUNTS,
    FusedCarry,
    FusedConeOps,
    FusedResult,
    PaddedProblem,
    fused_solve,
    fused_solve_plain,
    pad_cones,
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
from .hetero_admm import (  # noqa: F401
    HeteroCarry,
    HeteroProblem,
    HeteroResult,
    gather_hetero,
    hetero_solve,
    hetero_solve_plain,
    pad_hetero_cone_masks,
    pad_hetero_cone_params,
    pad_hetero_from_plants,
    pad_hetero_problem,
    repack_hetero_caches,
)
from .riccati_kernel import (  # noqa: F401
    riccati_cache_kernel,
    riccati_cache_kernel_plain,
    riccati_cache_newton,
    riccati_cache_newton_plain,
    riccati_fixed_point_kernel,
    riccati_newton_kernel,
)
from .stream_admm import (  # noqa: F401
    StreamCarry,
    StreamProblem,
    StreamResult,
    pad_stream_problem,
    stream_ref_vectors,
    stream_solve,
    stream_solve_plain,
)
from .hstream_admm import (  # noqa: F401
    HStreamProblem,
    gather_hstream,
    hstream_carry_zeros,
    hstream_ref_vectors,
    hstream_solve,
    hstream_solve_plain,
    pad_hstream_from_plants,
    pad_hstream_problem,
)
