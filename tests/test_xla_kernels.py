"""The XLA kernels of the hot path against plain numpy/scipy references.

- the leaf factor exactly as ArrowBackend._leaf_factor runs it: batched
  Cholesky plus the explicit inverse from two batched triangular solves
  (linalg/arrow_backend.batched_cholesky_factor);
- the ELL sparse products of the CG leaf (core/sparse.ell_mv,
  ell_mv_multi);
- f32 matmul precision ("highest" = full f32; on the GPU "high" = TF32).

The `check_*` functions hold each check; the small-shape tests run them on
the CPU, and the `gpu` tests run them at real widths on the card, where
`chip_smoke.py` imports this module and calls the same functions.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pips_ipmpp_tpu.core.sparse import Ell, ell_mv, ell_mv_multi
from pips_ipmpp_tpu.linalg.arrow_backend import batched_cholesky_factor

# real widths: (blocks, condensed leaf size a) of the flagship, the
# 512-block and the big-leaf configurations; ELL rows per block of the
# 8-block sparse LPs (10 nnz/row, 24 right-hand sides = its Schur border)
LEAF_SHAPES = [(64, 256), (512, 128), (64, 1024)]
ELL_ROWS = [2048, 8192]
# ||N^{-1} A - I||_F / sqrt(a) at cond 1e3: eps x cond x growth
LEAF_BOUND = {"float32": 1e-3, "float64": 1e-10}


def _time_per_call(fn, *args, reps: int = 5) -> float:
    """Seconds per call of a jitted fn, compile excluded."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def spd_batch(N: int, a: int, cond: float, seed: int = 0) -> np.ndarray:
    """[N, a, a] symmetric positive definite, eigenvalues log-spaced on
    [1/cond, 1] (host f64)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((N, a, a)))
    lam = np.logspace(0.0, -np.log10(cond), a)
    A = (Q * lam[None, None, :]) @ np.swapaxes(Q, 1, 2)
    return 0.5 * (A + np.swapaxes(A, 1, 2))


def check_leaf_factor(N: int, a: int, dtype: str, cond: float = 1e3,
                      seed: int = 0, reps: int = 5) -> dict:
    """Leaf factor + explicit inverse in `dtype` against numpy f64."""
    A64 = spd_batch(N, a, cond, seed)
    A = jnp.asarray(A64, dtype)
    fn = jax.jit(lambda m: batched_cholesky_factor(m, True))
    with jax.default_matmul_precision("highest"):
        _, Ninv, ok = fn(A)
        sec = _time_per_call(fn, A, reps=reps)
    Ninv64 = np.asarray(Ninv, np.float64)
    resid = Ninv64 @ A64 - np.eye(a)
    err = float(np.max(np.linalg.norm(resid, axis=(1, 2)))) / np.sqrt(a)
    ref = np.linalg.inv(A64)
    vs_numpy = float(np.max(np.linalg.norm(Ninv64 - ref, axis=(1, 2))
                            / np.linalg.norm(ref, axis=(1, 2))))
    assert bool(ok), "non-finite leaf factor"
    assert err <= LEAF_BOUND[dtype], (N, a, dtype, err)
    return dict(shape=[N, a, a], dtype=dtype, inv_resid=err,
                rel_diff_vs_numpy_inv=vs_numpy, ms_per_call=1e3 * sec)


def random_ell(N: int, rows: int, cols: int, K: int, seed: int = 0):
    """Host ELL arrays (val f64 [N, rows, K], col int32) with random
    columns; repeated columns in a row are duplicates that sum."""
    rng = np.random.default_rng(seed)
    col = rng.integers(0, cols, size=(N, rows, K), dtype=np.int32)
    val = rng.standard_normal((N, rows, K))
    return val, col


def ell_reference(val, col, cols: int, X: np.ndarray) -> np.ndarray:
    """scipy.sparse f64 products, one CSR matrix per block: X [N, cols, c]
    -> [N, rows, c]."""
    import scipy.sparse as sp
    N, rows, K = val.shape
    r = np.repeat(np.arange(rows), K)
    return np.stack([
        sp.csr_matrix((val[i].ravel(), (r, col[i].ravel())),
                      shape=(rows, cols)) @ X[i] for i in range(N)])


def check_ell_spmv(rows: int, N: int = 8, K: int = 10, c: int = 24,
                   dtype: str = "float32", seed: int = 0,
                   reps: int = 10) -> dict:
    """ell_mv_multi (c right-hand sides) and ell_mv in `dtype` against
    scipy.sparse f64, square blocks of `rows` rows."""
    val, col = random_ell(N, rows, rows, K, seed)
    X = np.random.default_rng(seed + 1).standard_normal((N, rows, c))
    ell = Ell(jnp.asarray(val, dtype), jnp.asarray(col))
    Xd = jnp.asarray(X, dtype)
    multi = jax.jit(ell_mv_multi)
    single = jax.jit(ell_mv)
    with jax.default_matmul_precision("highest"):
        Y = np.asarray(multi(ell, Xd), np.float64)
        y = np.asarray(single(ell, Xd[:, :, 0]), np.float64)
        sec = _time_per_call(multi, ell, Xd, reps=reps)
        sec1 = _time_per_call(single, ell, Xd[:, :, 0], reps=reps)
    ref = ell_reference(val, col, rows, X)
    err = float(np.linalg.norm(Y - ref) / np.linalg.norm(ref))
    err1 = float(np.linalg.norm(y - ref[:, :, 0])
                 / np.linalg.norm(ref[:, :, 0]))
    bound = 1e-6 if dtype == "float32" else 1e-13
    assert err <= bound and err1 <= bound, (rows, err, err1)
    return dict(blocks=N, rows=rows, nnz_per_row=K, rhs=c, dtype=dtype,
                rel_err=err, rel_err_single=err1, ms_per_call=1e3 * sec,
                ms_per_call_single=1e3 * sec1)


def check_precision(N: int = 64, a: int = 256, seed: int = 0) -> dict:
    """Batched f32 matmul at "highest" against numpy f64 (bound 1e-6);
    the "high" error is reported, not asserted (TF32 on the GPU)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, a, a)).astype(np.float32)
    y = rng.standard_normal((N, a, a)).astype(np.float32)
    ref = np.matmul(x.astype(np.float64), y.astype(np.float64))
    errs = {}
    for prec in ("highest", "high"):
        out = jax.jit(lambda u, v, p=prec: jnp.matmul(u, v, precision=p))(
            jnp.asarray(x), jnp.asarray(y))
        errs[prec] = float(np.linalg.norm(np.asarray(out, np.float64) - ref)
                           / np.linalg.norm(ref))
    assert errs["highest"] <= 1e-6, errs
    return dict(shape=[N, a, a], err_highest=errs["highest"],
                err_high=errs["high"])


# ---------------------------------------------------------------- CPU --

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("a", [5, 16, 37, 48, 130])
def test_leaf_factor_matches_numpy_inverse(a, dtype):
    out = check_leaf_factor(3, a, dtype, seed=a, reps=1)
    tol = 1e-4 if dtype == "float32" else 1e-11
    assert out["rel_diff_vs_numpy_inv"] < tol


def test_leaf_factor_without_inverse_flags_indefinite():
    """explicit_inverse=False keeps only L; a non-SPD block makes the
    Cholesky non-finite and the health flag false."""
    A = spd_batch(2, 8, 10.0)
    L, Ninv, ok = batched_cholesky_factor(jnp.asarray(A), False)
    assert bool(ok) and Ninv.shape == ()
    assert np.allclose(np.asarray(L) @ np.swapaxes(np.asarray(L), 1, 2), A)
    A[1] = -A[1]
    assert not bool(batched_cholesky_factor(jnp.asarray(A), False)[2])


def _dense(val, col, cols):
    N, rows, K = val.shape
    out = np.zeros((N, rows, cols))
    for b in range(N):
        for r in range(rows):
            for k in range(K):
                out[b, r, col[b, r, k]] += val[b, r, k]
    return out


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("m,n,c", [(64, 96, 3), (130, 257, 9), (128, 128, 1)])
def test_ell_products_match_dense(m, n, c, multi):
    val, col = random_ell(3, m, n, 5, seed=m + n)
    dense = _dense(val, col, n)
    X = np.random.default_rng(c).standard_normal((3, n, c))
    ell = Ell(jnp.asarray(val), jnp.asarray(col))
    if multi:
        out, ref = ell_mv_multi(ell, jnp.asarray(X)), dense @ X
    else:
        out = ell_mv(ell, jnp.asarray(X[:, :, 0]))
        ref = np.einsum("bmn,bn->bm", dense, X[:, :, 0])
    assert np.max(np.abs(np.asarray(out) - ref)) < 1e-12 * max(
        1.0, np.max(np.abs(ref)))


def test_ell_duplicate_and_zero_entries():
    """Duplicate (row, col) slots accumulate; zero-valued padding slots
    (col 0, val 0) contribute nothing."""
    val = np.array([[[1.5, 2.5, 0.0], [3.0, 0.0, 0.0]]])
    col = np.array([[[2, 2, 0], [1, 0, 0]]], np.int32)
    ell = Ell(jnp.asarray(val), jnp.asarray(col))
    x = np.arange(1.0, 5.0).reshape(1, 4)
    # row0: (1.5 + 2.5) * x[2] = 12; row1: 3 * x[1] = 6
    assert np.allclose(np.asarray(ell_mv(ell, jnp.asarray(x)))[0], [12, 6])
    Y = ell_mv_multi(ell, jnp.asarray(np.stack([x, 2 * x], axis=2)))
    assert np.allclose(np.asarray(Y)[0], [[12, 24], [6, 12]])
    assert np.allclose(ell_reference(val, col, 4, x[:, :, None])[0, :, 0],
                       [12, 6])


# ---------------------------------------------------------------- GPU --

@pytest.mark.gpu
def test_precision_probe_real_width(gpu):
    check_precision()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N,a", LEAF_SHAPES)
def test_leaf_factor_real_width(gpu, N, a, dtype):
    check_leaf_factor(N, a, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ELL_ROWS)
def test_ell_spmv_real_width(gpu, rows):
    check_ell_spmv(rows)
