"""Shared helpers for the parity tests of the PyTorch port
(``tests/test_torch_*.py``): the same numpy inputs go through a function of
the JAX package and its counterpart in ``accelerated_tinympc_tpu_torch``
(``device="cpu"``), and the results are compared field by field."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu_torch import convert

DEV = "cpu"

# The tests run at small sizes beside other test processes: one thread per
# process, or every worker's torch pool competes for all cores.
torch.set_num_threads(1)


def to_np(a) -> np.ndarray:
    """numpy view of a torch tensor, a JAX array or anything array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def fields_of(obj) -> dict[str, np.ndarray]:
    """Array fields of a dataclass (flax or plain), a NamedTuple or a dict,
    as numpy, keyed by field name."""
    if isinstance(obj, dict):
        items = obj.items()
    elif hasattr(obj, "_fields"):
        items = ((k, getattr(obj, k)) for k in obj._fields)
    else:
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    out = {}
    for k, v in items:
        if isinstance(v, (torch.Tensor, np.ndarray)) or hasattr(v, "dtype"):
            out[k] = to_np(v)
    return out


def assert_fields_close(got, want, *, atol, rtol=0.0, names=None, label="",
                        scaled=False):
    """Every (named) array field of ``got`` equals the one of ``want`` within
    the tolerance; integer fields must be equal. ``scaled=True`` multiplies
    ``atol`` by ``max(1, max|want field|)``: float rounding is relative to
    the largest entry a product mixes in (the costate ``p`` reaches 1e3)."""
    g, w = fields_of(got), fields_of(want)
    names = list(names) if names is not None else sorted(w)
    assert names, "nothing to compare"
    for k in names:
        a, b = g[k], w[k]
        assert a.shape == b.shape, f"{label}{k}: {a.shape} vs {b.shape}"
        if np.issubdtype(b.dtype, np.integer) or b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}{k}")
        else:
            tol = atol
            if scaled and b.size:
                tol = atol * max(1.0, float(np.max(np.abs(b))))
            np.testing.assert_allclose(
                a, b, rtol=rtol, atol=tol, err_msg=f"{label}{k}")


def torch_dtype(np_dtype):
    return torch.float64 if np.dtype(np_dtype) == np.float64 else torch.float32


def problem_to_torch(jproblem, dtype=torch.float32):
    return convert.problem_from_numpy(
        fields_of(jproblem), dtype=dtype, device=DEV)


def cache_to_torch(jcache, dtype=torch.float32):
    return convert.cache_from_numpy(fields_of(jcache), dtype=dtype, device=DEV)


def state_to_torch(jstate, dtype=torch.float32):
    return convert.state_from_numpy(fields_of(jstate), dtype=dtype, device=DEV)


def settings_to_torch(jsettings):
    return convert.settings_from({
        f.name: getattr(jsettings, f.name)
        for f in dataclasses.fields(jsettings)
    })


def perturbed_x0(x0, batch: int, seed: int, spread: float = 0.1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x0 = np.asarray(x0, np.float64)
    return x0[None] + spread * rng.standard_normal((batch, x0.size))


def torch_pp(tproblem, tcache, dtype=torch.float32):
    """(ops, pp) of the port for a torch problem/cache on the CPU."""
    from accelerated_tinympc_tpu_torch.ops import pad_problem

    ops = atm_t.condensed_operators(
        tcache, tproblem.A, tproblem.B, tproblem.horizon,
        dtype=dtype, device=DEV)
    return ops, pad_problem(tproblem, tcache, ops, dtype=dtype, device=DEV)


def jax_fused_result_fields(res) -> dict:
    """The JAX FusedResult as the nested dict ``convert`` takes."""
    return {
        "U": to_np(res.U), "X": to_np(res.X), "stats": to_np(res.stats),
        "carry": {k: to_np(getattr(res.carry, k)) for k in res.carry._fields},
    }


def assert_fused_close(got, jres, dims, *, atol, label=""):
    """A port FusedResult vs a JAX FusedResult (padded layout): U, X and the
    five carries within ``atol``."""
    want = convert.fused_result_from_numpy(
        jax_fused_result_fields(jres), dims, device=DEV)
    assert_fields_close(
        {"U": got.U, "X": got.X}, {"U": want.U, "X": want.X},
        atol=atol, label=label)
    assert_fields_close(got.carry, want.carry, atol=atol, label=label + "carry.")
    return want
