"""The LCMV per-bin solve (models/lcmv.py: lcmv_solve) against direct
float64 NumPy math: w = R^-1 C (C^H R^-1 C)^-1 e0, with masked constraint
slots closed by an identity on the inner matrix."""

import numpy as np
import jax.numpy as jnp

from beamform_tpu.models.lcmv import lcmv_solve


def reference(r, c):
    t, nib, m, s_cap = c.shape
    w = np.zeros((t, nib, m), dtype=np.complex128)
    for f in range(t):
        for b in range(nib):
            cc = c[f, b]
            xs = np.linalg.solve(r[f, b], cc)
            g = cc.conj().T @ xs
            for a in range(s_cap):
                if np.all(cc[:, a] == 0):
                    g[a, a] += 1.0
            w[f, b] = xs @ np.linalg.solve(g, np.eye(s_cap)[:, 0])
    return w


def case(seed, t, m, nib, s_cap):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, 6, m, nib))
         + 1j * rng.standard_normal((t, 6, m, nib)))
    r = np.einsum("twmn,twkn->tnmk", x, x.conj())
    r = r * (np.ones((m, m)) + 0.001 * np.eye(m))
    c = np.exp(1j * rng.uniform(0, 2 * np.pi, (t, nib, m, s_cap)))
    return r, c


def test_lcmv_solve_masked_slot_matches_direct():
    r, c = case(3, t=5, m=4, nib=5, s_cap=3)
    c[..., 2] = 0.0                                 # one inactive slot
    inact = np.array([0.0, 0.0, 1.0])
    w = np.asarray(lcmv_solve(jnp.asarray(r.astype(np.complex64)),
                              jnp.asarray(c.astype(np.complex64)),
                              jnp.asarray(inact)[None, None, :]))
    ref = reference(r, c)
    assert np.isfinite(w).all()
    assert np.abs(w - ref).max() / np.abs(ref).max() < 1e-3
    # the constraints hold: unit response on the DOI, nulls elsewhere
    resp = np.einsum("tnm,tnms->tns", w.conj(), c[..., :2])
    np.testing.assert_allclose(resp[..., 0], 1.0, atol=1e-3)
    np.testing.assert_allclose(resp[..., 1], 0.0, atol=1e-3)


def test_lcmv_single_constraint_is_mvdr():
    """With S=1 the LCMV solve reduces to w = R^-1 d / (d^H R^-1 d)."""
    from beamform_tpu.models.mvdr import mvdr_solve
    r, c = case(5, t=4, m=4, nib=4, s_cap=1)
    r32, c32 = (jnp.asarray(a.astype(np.complex64)) for a in (r, c))
    w_l = np.asarray(lcmv_solve(r32, c32))
    w_m = np.asarray(mvdr_solve(r32, c32[..., 0]))
    assert np.abs(w_l - w_m).max() / np.abs(w_m).max() < 1e-4
    assert np.abs(w_l - reference(r, c)).max() / np.abs(w_m).max() < 1e-3
