"""Public API layer: the high-level solver object, the fleet of distinct
plants, and the receding-horizon MPC rollouts."""

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
