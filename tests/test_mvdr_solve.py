"""The MVDR per-bin solve (models/mvdr.py: mvdr_solve) against direct
float64 NumPy math: w = R^-1 d / (d^H R^-1 d) on the sliding covariance of
the last W frames with the reference's 1.001 diagonal loading."""

import numpy as np
import jax.numpy as jnp
import pytest

from beamform_tpu.models.mvdr import mvdr_solve, white_r


def covariances(x_hist):
    """(T, W, M, Nib) history windows -> (T, Nib, M, M) loaded R."""
    m = x_hist.shape[2]
    s = np.einsum("twmn,twkn->tnmk", x_hist, x_hist.conj())
    return s * (np.ones((m, m)) + 0.001 * np.eye(m))


def reference(r, d):
    t, nib, m, _ = r.shape
    w = np.zeros((t, nib, m), dtype=np.complex128)
    for f in range(t):
        for b in range(nib):
            u = np.linalg.solve(r[f, b], d[f, b])
            w[f, b] = u / (d[f, b].conj() @ u)
    return w


def case(seed, t, m, w_hist, nib):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, w_hist, m, nib))
         + 1j * rng.standard_normal((t, w_hist, m, nib)))
    d = np.exp(1j * rng.uniform(0, 2 * np.pi, (t, nib, m)))
    d[..., 0] = 1.0
    return covariances(x), d


@pytest.mark.parametrize("seed", [0, 1])
def test_mvdr_solve_float32_matches_direct(seed):
    r, d = case(seed, t=6, m=4, w_hist=5, nib=5)
    w = np.asarray(mvdr_solve(jnp.asarray(r.astype(np.complex64)),
                              jnp.asarray(d.astype(np.complex64))))
    ref = reference(r, d)
    assert np.isfinite(w).all()
    assert np.abs(w - ref).max() / np.abs(ref).max() < 1e-3


def test_mvdr_solve_sixteen_mics_long_history():
    """The AIRA-16 width with a 10-frame history (the launch preset)."""
    r, d = case(2, t=4, m=16, w_hist=10, nib=7)
    w = np.asarray(mvdr_solve(jnp.asarray(r.astype(np.complex64)),
                              jnp.asarray(d.astype(np.complex64))))
    ref = reference(r, d)
    assert np.abs(w - ref).max() / np.abs(ref).max() < 1e-3
    # distortionless: w^H d == 1 on every bin
    resp = np.einsum("tnm,tnm->tn", w.conj(), d)
    np.testing.assert_allclose(resp, 1.0, atol=1e-3)
    assert np.allclose(np.asarray(white_r(3, jnp.float64)),
                       np.ones((3, 3)) + 0.001 * np.eye(3))
