"""Public API layer: the high-level solver object and the receding-horizon
MPC rollouts."""

from .solver import TinyMPC  # noqa: F401
from .mpc import (  # noqa: F401
    MPCTrace,
    default_plant,
    fused_mpc_rollout,
    mpc_rollout,
    tracking_error,
)
