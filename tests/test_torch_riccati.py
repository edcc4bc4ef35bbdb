"""PyTorch port, on-device Riccati routines on the CPU: the batched
``riccati_cache_jax`` / ``riccati_newton_jax`` / ``condensed_operators_jax``
/ ``riccati_polish_f64`` and the plain versions of the Riccati CUDA kernels
against the JAX package's vmapped functions and a float64 numpy truth, on
the same random plants.

The Pallas Riccati kernels are not run here: tests/test_riccati_kernel.py
notes that their interpret-mode graphs are the suite's largest. The port's
kernels are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).

Bars: float32 against JAX float32 1e-4 relative to the field's largest
entry (coeff_d2p: relative to Pinf's, it is a difference of terms of that
size that vanishes at the fixed point); float64 against the float64 truth
1e-9; iteration counts within one step in float32, equal in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_tinympc_tpu import precompute as pj
from accelerated_tinympc_tpu.types import Cache as CacheJ
from accelerated_tinympc_tpu_torch import precompute as pt
from accelerated_tinympc_tpu_torch.ops import riccati_kernel as rk

from torch_parity_utils import DEV, cache_to_torch, fields_of, to_np

B = 7
FIELDS = ("Kinf", "Pinf", "Quu_inv", "AmBKt", "coeff_d2p")


def plants(batch, nx, nu, seed=0, dtype=np.float32):
    """Random plants scaled to spectral radius 0.95, positive diagonals."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, nx, nx))
    A *= (0.95 / np.abs(np.linalg.eigvals(A)).max(axis=1))[:, None, None]
    return tuple(a.astype(dtype) for a in (
        A, rng.standard_normal((batch, nx, nu)),
        rng.uniform(0.5, 5.0, (batch, nx)), rng.uniform(0.5, 5.0, (batch, nu)),
        rng.uniform(0.5, 5.0, batch)))


def truth64(A, Bm, Q, R, rho, tol=1e-12, max_iters=20000):
    """float64 numpy fixed point, one instance at a time."""
    out = []
    for a, b, q, r, p in zip(A, Bm, Q, R, rho):
        out.append(fields_of(pj.riccati_cache(
            a.astype(np.float64), b.astype(np.float64), q.astype(np.float64),
            r.astype(np.float64), float(p), tol=tol, max_iters=max_iters,
            dtype=np.float64)))
    return {k: np.stack([o[k] for o in out]) for k in out[0]}


def close(got, want, atol, names=FIELDS, rows=slice(None)):
    g, w = fields_of(got), fields_of(want)
    for k in names:
        ref = w["Pinf"] if k == "coeff_d2p" else w[k]
        tol = atol * max(1.0, float(np.abs(ref[rows]).max()))
        np.testing.assert_allclose(g[k][rows], w[k][rows], rtol=0, atol=tol,
                                   err_msg=k)


tt = lambda arrays: tuple(torch.as_tensor(a) for a in arrays)
jj = lambda arrays: tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("dims", [(6, 2), (4, 3), (1, 1)])
def test_fixed_point_matches_jax_vmap(dims):
    P = plants(B, *dims, seed=dims[0])
    want = jax.jit(jax.vmap(pj.riccati_cache_jax))(*jj(P))
    got = pt.riccati_cache_jax(*tt(P))
    close(got, want, 1e-4)
    # the kernel's plain version is the same function in float32
    plain, iters = rk.riccati_fixed_point_kernel(*tt(P))  # CPU tensors: plain
    close(plain, got, 1e-6)
    close(rk.riccati_cache_kernel(*tt(P)), got, 1e-6)
    assert iters.shape == (B,) and iters.dtype == torch.int32
    # and both sit near the float64 truth
    close(got, truth64(*P), 2e-3, names=("Kinf", "Pinf"))


def test_fixed_point_float64_exact_counts_and_freeze():
    with jax.enable_x64(True):
        P = plants(B, 6, 2, seed=1, dtype=np.float64)
        want = jax.jit(jax.vmap(
            lambda a, b, q, r, p: pj.riccati_cache_jax(a, b, q, r, p, tol=1e-9)
        ))(*jj(P))
        got, iters = pt.riccati_fixed_point(*tt(P), tol=1e-9)
        close(got, want, 1e-10)
        # per-instance freeze: instances stop at different steps, and
        # stopping the whole batch at the slowest one's count changes them
        it = to_np(iters)
        assert it.min() < it.max() <= 1000
        capped, it2 = pt.riccati_fixed_point(*tt(P), tol=1e-9,
                                             max_iters=int(it.min()))
        assert int(it2.max()) == int(it.min())
        slow = int(np.argmax(it))
        assert not np.allclose(to_np(capped.Kinf)[slow], to_np(got.Kinf)[slow],
                               atol=1e-9)
        fast = int(np.argmin(it))
        np.testing.assert_array_equal(to_np(capped.Kinf)[fast],
                                      to_np(got.Kinf)[fast])


def test_warm_start_verifies_in_one_step_and_unbatched_call():
    P = plants(B, 6, 2, seed=2)
    cold, it_cold = pt.riccati_fixed_point(*tt(P))
    warm, it_warm = pt.riccati_fixed_point(*tt(P), P0=cold.Pinf, K0=cold.Kinf)
    assert int(it_warm.max()) <= 2 < int(it_cold.min())
    close(warm, cold, 1e-4)
    one = pt.riccati_cache_jax(*(a[0] for a in tt(P)))
    assert one.Kinf.shape == (2, 6) and one.rho.shape == ()
    np.testing.assert_allclose(to_np(one.Kinf), to_np(cold.Kinf)[0], atol=1e-6)
    want = pj.riccati_cache_jax(*(a[0] for a in jj(P)))
    np.testing.assert_allclose(to_np(one.Pinf), np.asarray(want.Pinf),
                               atol=1e-4 * float(np.abs(want.Pinf).max()))


def test_newton_matches_jax_vmap_and_flags_a_bad_gain():
    A, Bm, Q, R, rho = plants(B, 6, 2, seed=3)
    K0 = to_np(pt.riccati_cache_jax(*tt((A, Bm, Q, R, rho))).Kinf).copy()
    rho2 = (rho * 7.0).astype(np.float32)
    K0[2] = -50.0 * K0[2] + 3.0          # does not stabilise plant 2
    kw = dict(tol=1e-5, max_outer=12, inner_iters=13)
    want = jax.jit(jax.vmap(
        lambda a, b, q, r, p, k: pj.riccati_newton_jax(a, b, q, r, p, k, **kw)
    ))(*jj((A, Bm, Q, R, rho2, K0)))
    got, it = rk.riccati_newton_kernel(*tt((A, Bm, Q, R, rho2, K0)))  # plain
    ok = np.ones(B, bool)
    ok[2] = False
    close(got, want, 1e-4, rows=ok)
    assert not np.isfinite(to_np(got.Kinf)[2]).all()
    assert not np.isfinite(np.asarray(want.Kinf)[2]).all()
    assert np.isfinite(to_np(got.Kinf)[ok]).all()
    # Newton lands on the true fixed point of the new rho
    close(got, truth64(A, Bm, Q, R, rho2), 2e-3, names=("Kinf", "Pinf"),
          rows=ok)
    assert to_np(it)[ok].max() <= 6


def test_polish_f64_reaches_the_float64_truth():
    P = plants(B, 6, 2, seed=4)
    rough = pt.riccati_cache_jax(*tt(P))
    polished = pt.riccati_polish_f64(rough, *tt(P), batch_chunk=3)
    truth = truth64(*P)
    for k in ("Kinf", "Pinf", "Quu_inv", "AmBKt"):
        tol = 2e-7 * max(1.0, float(np.abs(truth[k]).max()))
        np.testing.assert_allclose(to_np(getattr(polished, k)), truth[k],
                                   rtol=0, atol=tol, err_msg=k)
        assert getattr(polished, k).dtype == torch.float32
    err = lambda c: np.abs(to_np(c.Kinf) - truth["Kinf"]).max()
    assert err(polished) < err(rough)


@pytest.mark.parametrize("dims", [(6, 2, 5), (3, 3, 4)])
def test_condensed_operators_jax_matches_jax(dims):
    nx, nu, N = dims
    A, Bm, Q, R, rho = plants(B, nx, nu, seed=5)
    caches_j = jax.vmap(pj.riccati_cache_jax)(*jj((A, Bm, Q, R, rho)))
    want = jax.jit(jax.vmap(
        lambda c, a, b: pj.condensed_operators_jax(c, a, b, N)
    ))(caches_j, jnp.asarray(A), jnp.asarray(Bm))
    caches_t = cache_to_torch(caches_j)
    got = pt.condensed_operators_jax(
        caches_t, torch.as_tensor(A), torch.as_tensor(Bm), N)
    for k in want._fields:
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(
            to_np(getattr(got, k)), w, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=k)
    # an unbatched call is instance 0, and agrees with the host float64 build
    one_cache = cache_to_torch(
        CacheJ(**{k: v[0] for k, v in fields_of(caches_j).items()}))
    one = pt.condensed_operators_jax(
        one_cache, torch.as_tensor(A[0]), torch.as_tensor(Bm[0]), N)
    host = pt.condensed_operators(one_cache, A[0], Bm[0], N, device=DEV)
    for k in one._fields:
        h = to_np(getattr(host, k))
        np.testing.assert_allclose(
            to_np(getattr(one, k)), h, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(h).max())), err_msg=k)


def test_kernel_wrappers_validate_on_any_device():
    A, Bm, Q, R, rho = tt(plants(3, 4, 2))
    with pytest.raises(ValueError, match="both P0 and K0"):
        rk.riccati_cache_kernel(A, Bm, Q, R, rho, P0=torch.zeros(3, 4, 4))
    with pytest.raises(ValueError, match="nx <= 16"):
        rk._prepare(torch.zeros(3, 17, 17), torch.zeros(3, 17, 2),
                    torch.ones(3, 17), R, rho)
    with pytest.raises(ValueError, match="shape"):
        rk._prepare(A, Bm, Q[:, :3], R, rho)
    assert set(rk.LAUNCH_COUNTS) == {"riccati_fixed_point", "riccati_newton"}
    assert not any(rk.LAUNCH_COUNTS.values())   # the CPU launches nothing
