"""Public API layer: the high-level solver object, the fleet of distinct
plants, the receding-horizon MPC rollouts, offline codegen, and AOT
export."""

from .solver import TinyMPC  # noqa: F401
from .fleet import FLEET_TIERS, TinyMPCFleet  # noqa: F401
from .mpc import (  # noqa: F401
    MPCTrace,
    default_plant,
    fleet_mpc_rollout,
    fused_mpc_rollout,
    mpc_rollout,
    tracking_error,
)
from .codegen import build_project, tiny_codegen  # noqa: F401
from .export import (  # noqa: F401
    export_batched_solve,
    export_fused_solve,
    load_exported,
    save_exported,
)
