"""PyTorch port, ``utils/serialization.py`` against the JAX package's on
the CPU: files written by either package's ``save_pytree`` /
``save_problem_cache`` load in the other (``Problem``, ``Cache``,
``State`` and a tuple of them with an array), with the same leaf names,
order, dtypes, values and manifest; broken files raise the same errors,
word for word. Bars: exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
from accelerated_tinympc_tpu.models import quadrotor_hovering_setup as hover_j
from accelerated_tinympc_tpu.utils import serialization as ser_j
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu_torch.utils import serialization as ser_t

from torch_parity_utils import DEV, fields_of, to_np


def _pair(dtype_j=jnp.float32, dtype_t=torch.float32):
    """The hovering quadrotor in both packages, and a state of each with
    every field distinct (x0 set, the rest seeded noise)."""
    pj, cj, x0 = hover_j()
    pt, ct, _ = atm_t.models.quadrotor_hovering_setup(device=DEV)
    rng = np.random.default_rng(3)
    sj = atm_j.init_state(12, 4, 10, dtype_j)
    sj = sj.replace(**{
        k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
        for k, v in fields_of(sj).items() if v.dtype.kind == "f"})
    sj = sj.replace(iter=jnp.asarray(7, jnp.int32),
                    status=jnp.asarray(1, jnp.int32))
    st = atm_t.init_state(12, 4, 10, dtype_t, device=DEV)
    return pj, cj, sj, pt, ct, st, x0


def _trees(kind, pj, cj, sj, pt, ct, st, x0):
    x = np.asarray(x0, np.float32)
    return {
        "problem": (pj, pt),
        "cache": (cj, ct),
        "state": (sj, st),
        "tuple": ((sj, jnp.asarray(x), cj),
                  (st, torch.as_tensor(x), ct)),
    }[kind]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["problem", "cache", "state", "tuple"])
def test_files_load_in_the_other_package(tmp_path, kind, writer):
    """save_pytree of either package writes what the other's load_like
    reads: same leaf names (keystr paths), order, shapes, dtypes and
    values, and the same manifest."""
    pj, cj, sj, pt, ct, st, x0 = _pair()
    tj, tt = _trees(kind, pj, cj, sj, pt, ct, st, x0)
    if writer == "port":   # the port writes the JAX tree's values
        tt = ser_t.load_like(_saved(tmp_path / "seed.npz", ser_j, tj), tt)
    f = tmp_path / "ck.npz"
    (ser_j if writer == "jax" else ser_t).save_pytree(
        f, tj if writer == "jax" else tt)
    mj, mt = ser_j.read_manifest(f), ser_t.read_manifest(f)
    assert mj == mt
    assert [e["name"] for e in mj["leaves"]] == ser_t._flatten_with_names(
        tt)[0]
    got_t = ser_t.load_like(f, tt)
    got_j = ser_j.load_like(f, tj)
    assert type(got_t) is type(tt) and type(got_j) is type(tj)
    for a, b in zip(jax.tree.leaves(tj), ser_t._flatten_with_names(got_t)[1]):
        np.testing.assert_array_equal(to_np(b), np.asarray(a))
        assert to_np(b).dtype == np.asarray(a).dtype
    for a, b in zip(jax.tree.leaves(tj), jax.tree.leaves(got_j)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _saved(path, ser, tree):
    ser.save_pytree(path, tree)
    return path


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_problem_cache_bundle_both_ways(tmp_path, writer):
    """save_problem_cache of either package loads in both, settings
    included."""
    pj, cj, _ = hover_j()
    pt, ct, _ = atm_t.models.quadrotor_hovering_setup(device=DEV)
    f = tmp_path / "bundle.npz"
    if writer == "jax":
        ser_j.save_problem_cache(f, pj, cj, atm_j.Settings(
            max_iter=42, check_termination=3))
    else:
        ser_t.save_problem_cache(f, pt, ct, atm_t.Settings(
            max_iter=42, check_termination=3))
    p1, c1, s1 = ser_t.load_problem_cache(f, device=DEV)
    p2, c2, s2 = ser_j.load_problem_cache(f)
    for want, got in ((pj, p1), (cj, c1), (pj, p2), (cj, c2)):
        for k, v in fields_of(want).items():
            np.testing.assert_array_equal(to_np(getattr(got, k)), v)
    for s in (s1, s2):
        assert (s.max_iter, s.check_termination) == (42, 3)
        assert s.en_state_bound and s.en_input_bound


def _break(kind, tmp_path, ser, state, cache):
    """A broken checkpoint and the template that must refuse it."""
    p = tmp_path / f"{kind}.npz"
    if kind == "no_manifest":
        np.savez(p, leaf_0=np.zeros(3))
        return p
    ser.save_pytree(p, cache if kind == "wrong_type" else state)
    if kind == "truncated":
        d = dict(np.load(p))
        del d[[k for k in d if k.startswith("leaf_")][-1]]
        np.savez(p, **d)
    return p


@pytest.mark.parametrize("kind", ["wrong_dims", "wrong_type", "truncated",
                                  "no_manifest", "bundle_dims",
                                  "bundle_missing"])
def test_validation_errors_equal_jax(tmp_path, kind):
    """A checkpoint with the wrong dims, the wrong type, a missing leaf or
    no manifest, and a bundle with inconsistent or missing fields, raise
    the same ValueError, word for word, in both packages."""
    pj, cj, _ = hover_j()
    if kind.startswith("bundle"):
        p = tmp_path / "pc.npz"
        ser_j.save_problem_cache(p, pj, cj, atm_j.Settings())
        d = dict(np.load(p))
        del d["__manifest__"]
        d["cache_Kinf"] = np.zeros((3, 7), np.float32)
        if kind == "bundle_missing":
            del d["cache_Pinf"]
        np.savez(p, **d)
        calls = (lambda: ser_j.load_problem_cache(p),
                 lambda: ser_t.load_problem_cache(p, device=DEV))
    else:
        p = _break(kind, tmp_path, ser_j,
                   atm_j.set_x0(atm_j.init_state(12, 4, 10), jnp.ones(12)), cj)
        dims = (8, 2, 5) if kind == "wrong_dims" else (12, 4, 10)
        calls = (lambda: ser_j.load_like(p, atm_j.init_state(*dims)),
                 lambda: ser_t.load_like(p, atm_t.init_state(*dims,
                                                             device=DEV)))
    msgs = []
    for call in calls:
        with pytest.raises(ValueError) as e:
            call()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    want = {"wrong_dims": "shape", "wrong_type": "leaves",
            "truncated": "truncated", "no_manifest": "manifest",
            "bundle_dims": "Kinf", "bundle_missing": "Pinf"}[kind]
    assert want in msgs[0]
