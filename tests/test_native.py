"""Native C++ kernel tests: build, ABI, and native == Python-fallback
equivalence on random data."""
import numpy as np
import pytest

from pips_ipmpp_tpu import native


@pytest.fixture(scope="module")
def lib():
    l = native.get_lib()
    if l is None:
        pytest.skip("native library unavailable (no compiler)")
    return l


def test_builds_and_abi(lib):
    # ABI 2: round-5 added the fused drop_tiny_impact presolve kernel
    assert lib.pips_native_abi_version() == 2


def test_row_support_stats(lib):
    rng = np.random.default_rng(0)
    M = rng.normal(size=(20, 15))
    M[M < 0.5] = 0.0
    M[3, :] = 0.0
    M[4, :] = 0.0
    M[4, 7] = 2.5
    nnz, single, mx = native.row_support_stats(M)
    a = np.abs(M)
    np.testing.assert_array_equal(nnz, (a > 0).sum(axis=1))
    np.testing.assert_allclose(mx, a.max(axis=1))
    assert single[3] == -1 and nnz[3] == 0
    assert single[4] == 7 and nnz[4] == 1


def test_drop_tiny(lib):
    M = np.array([[1.0, 1e-15, 0.5], [1e-13, 2.0, 1e-9]])
    M2 = M.copy()
    n = native.drop_tiny_entries(M2, 1e-12, 1e-10)
    # 1e-15 < abs tol; 1e-13 < abs tol; 1e-9 < 1e-10*2.0=2e-10? no, 1e-9 > 2e-10 -> kept
    assert n == 2
    np.testing.assert_array_equal(M2, [[1.0, 0.0, 0.5], [0.0, 2.0, 1e-9]])


def test_detect_parallel_rows(lib):
    rng = np.random.default_rng(1)
    M = rng.normal(size=(10, 8))
    M[np.abs(M) < 0.7] = 0.0
    M[4] = 2.0 * M[1]
    M[7] = -0.5 * M[1]
    M[9] = 3.0 * M[2]
    kept, dup, fct = native.detect_parallel_rows(M)
    pairs = {(int(k), int(d)): f for k, d, f in zip(kept, dup, fct)}
    assert (1, 4) in pairs and abs(pairs[(1, 4)] - 2.0) < 1e-12
    assert (1, 7) in pairs and abs(pairs[(1, 7)] + 0.5) < 1e-12
    assert (2, 9) in pairs and abs(pairs[(2, 9)] - 3.0) < 1e-12
    assert len(pairs) == 3


def test_row_activity_bounds(lib):
    M = np.array([[1.0, -2.0, 0.0], [0.0, 1.0, 1.0]])
    lo = np.array([0.0, -1.0, -np.inf])
    up = np.array([2.0, 3.0, 5.0])
    mn, mx = native.row_activity_bounds(M, lo, up)
    # row0: 1*[0,2] + (-2)*[-1,3] -> min 0 + (-6) = -6, max 2 + 2 = 4
    np.testing.assert_allclose(mn[0], -6.0)
    np.testing.assert_allclose(mx[0], 4.0)
    # row1: x2 in [-1,3], x3 in [-inf,5]
    assert mn[1] == -np.inf and mx[1] == 8.0


def test_native_matches_python_fallback():
    """Force the fallback path and compare against native."""
    if not native.available():
        pytest.skip("native unavailable")
    rng = np.random.default_rng(2)
    M = rng.normal(size=(30, 12))
    M[np.abs(M) < 0.8] = 0.0
    M[11] = 1.5 * M[5]

    import pips_ipmpp_tpu.native as nat
    saved = nat._lib
    try:
        res_native = (nat.row_support_stats(M),
                      nat.detect_parallel_rows(M))
        nat._lib = None
        nat._tried = True
        res_py = (nat.row_support_stats(M), nat.detect_parallel_rows(M))
    finally:
        nat._lib = saved
        nat._tried = True
    for a, b in zip(res_native[0], res_py[0]):
        np.testing.assert_allclose(a, b)
    for a, b in zip(res_native[1], res_py[1]):
        np.testing.assert_allclose(np.sort(np.asarray(a, float)),
                                   np.sort(np.asarray(b, float)))


def test_native_mps_parser_matches_python(tmp_path):
    """The native C++ MPS core (native/src/mps_reader.cpp, the role of the
    reference's MpsReader.C) must produce the exact same LP as the pure
    Python parser on every reader-depth fixture."""
    import dataclasses
    from pips_ipmpp_tpu import native
    from pips_ipmpp_tpu.io.mps import read_mps_with_info
    from tests.test_io import MPS_SAMPLE, MPS_FIXED_SAMPLE

    if not native.available():
        import pytest
        pytest.skip("no native library")

    fixtures = [("free.mps", MPS_SAMPLE, "free"),
                ("fixed.mps", MPS_FIXED_SAMPLE, "fixed")]
    # ranges + objsense + bounds-without-set-name variant
    variant = MPS_SAMPLE.replace(
        "ROWS", "OBJSENSE\n    MAX\nROWS").replace(
        " UP BND       X1           4.0", " UP X1 4.0")
    variant = variant.replace(
        "BOUNDS", "RANGES\n    RNG       LIM1         2.0\nBOUNDS")
    fixtures.append(("variant.mps", variant, "free"))

    for fname, text, fmt in fixtures:
        p = tmp_path / fname
        p.write_text(text)
        lp_n, info_n = read_mps_with_info(str(p), format=fmt, native=True)
        lp_p, info_p = read_mps_with_info(str(p), format=fmt, native=False)
        for f in dataclasses.fields(lp_p):
            np.testing.assert_array_equal(
                np.asarray(getattr(lp_n, f.name)),
                np.asarray(getattr(lp_p, f.name)),
                err_msg=f"{fname}: field {f.name}")
        assert info_n.name == info_p.name
        assert info_n.objective_row == info_p.objective_row
        assert info_n.objective_constant == info_p.objective_constant
        assert info_n.maximize == info_p.maximize
        assert info_n.row_names == info_p.row_names
        assert info_n.col_names == info_p.col_names
        assert info_n.free_rows == info_p.free_rows


def test_build_falls_back_to_serial(lib, monkeypatch, tmp_path):
    """A compiler without the OpenMP runtime fails the -fopenmp build; the
    serial retry (OPENMP=) still produces the library.  Builds into a copy
    of the sources so the shared library stays untouched."""
    import os
    import shutil
    import subprocess

    real_run = subprocess.run
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        if "OPENMP=" not in cmd:
            raise subprocess.CalledProcessError(1, cmd)
        return real_run(cmd, **kw)

    d = tmp_path / "native"
    shutil.copytree(os.path.dirname(native.__file__), d,
                    ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    monkeypatch.setattr(native, "_DIR", str(d))
    monkeypatch.setattr(native, "_LIB_PATH", str(d / "libpips_native.so"))
    monkeypatch.setattr(native.subprocess, "run", run)
    assert native._build()
    assert (d / "libpips_native.so").exists()
    assert len(calls) == 2
