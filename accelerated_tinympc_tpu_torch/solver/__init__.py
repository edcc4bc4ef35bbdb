"""Solver tiers: scan (ground truth), batched (leading batch axis + masked
early termination), condensed (dense horizon operators). The fused CUDA tier
lives in :mod:`..ops.fused_admm`. Beside them: second-order cones, the
compaction cascades over the fused and hetero adaptive kernels, adaptive
rho (single instance, and per instance on the einsum, hetero and scan
tiers), the per-instance-operator tier, and the long-horizon sweeps
(associative scan, block-condensed)."""

from . import admm  # noqa: F401
from .admm import admm_iteration, solve  # noqa: F401
from .batched import init_state_batched, solve_batched, batch_stats  # noqa: F401
from .condensed import (  # noqa: F401
    FlatProblem,
    FlatState,
    condensed_iteration,
    flat_from_state,
    flatten_problem,
    init_flat_state,
    solve_condensed,
    state_from_flat,
)
from .assoc_scan import (  # noqa: F401
    backward_pass_assoc,
    forward_pass_assoc,
    solve_assoc,
)
from .block_condensed import (  # noqa: F401
    block_ops_batched,
    block_sizes,
    block_sweeps,
    solve_block,
    solve_block_batched,
)
from .adaptive_rho import AdaptiveRhoResult, solve_adaptive_rho  # noqa: F401
from .adaptive_hetero import (  # noqa: F401
    AdaptiveHeteroResult,
    solve_adaptive_rho_hetero,
)
from .adaptive_scan import AdaptiveScanResult, solve_adaptive_rho_scan  # noqa: F401
from .batched_ops import (  # noqa: F401
    AdaptiveRhoBatchedResult,
    InstanceOps,
    OpsState,
    build_instance_ops,
    build_instance_ops_from_plants,
    solve_adaptive_rho_batched,
    solve_adaptive_rho_chunked,
    solve_instance_ops,
)
from .cascade import (  # noqa: F401
    cascade_solve,
    hetero_cascade_solve,
    hstream_cascade_solve,
    stream_cascade_solve,
)
from .cones import (  # noqa: F401
    Cone,
    ConeSet,
    cone_slack_update,
    cone_violation,
    make_cone_args,
    project_cone,
    project_cone_masked,
)
