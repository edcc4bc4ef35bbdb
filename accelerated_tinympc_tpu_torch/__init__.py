"""Accelerated-TinyMPC in PyTorch and CUDA: the port of
``accelerated_tinympc_tpu`` to an NVIDIA H100.

A batched convex-MPC engine (TinyMPC v0.2.0 semantics): ADMM box-constrained
LQR tracking with an infinite-horizon Riccati cache. Plain tiers are tensor
code; the fused tier runs a whole batched solve, or a whole
receding-horizon mission, inside one hand-written CUDA kernel
(``ops/csrc``), built with ``nvcc`` at first use.

Imports ``torch`` and ``numpy`` only. Functions that create tensors take
``device=`` and default to ``"cuda"``.
"""

from .types import (  # noqa: F401
    SOLVED,
    UNSOLVED,
    Cache,
    Problem,
    Settings,
    State,
    init_state,
    reset_duals,
    set_x0,
)
from .precompute import (  # noqa: F401
    CondensedOperators,
    condensed_operators,
    riccati_cache,
    riccati_cache_jax,
)
from .solver import admm  # noqa: F401
from .solver.admm import solve  # noqa: F401
from . import models  # noqa: F401
from . import api, convert, ops, parallel, utils  # noqa: F401
from .api import (  # noqa: F401
    TinyMPC, TinyMPCFleet, mpc_rollout, tiny_codegen,
)

__version__ = "0.1.0"
