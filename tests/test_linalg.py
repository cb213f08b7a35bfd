"""Batched Gauss-Jordan inverse (kernels/linalg.py) and the solve
refinement the MVDR/LCMV route builds on it (models/mvdr.py).

Replaces Eigen's per-bin ``.inverse()`` (mvdr.cpp:88, lcmv.cpp:116).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from beamform_tpu.kernels.linalg import gauss_jordan_inv
from beamform_tpu.models.mvdr import batched_inv


def make_hpd(b, m, seed=0, cond_boost=2.0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((b, m, m))
         + 1j * rng.standard_normal((b, m, m)))
    h = a @ a.conj().transpose(0, 2, 1) / m
    return (h + cond_boost * np.eye(m)).astype(np.complex64)


@pytest.mark.parametrize("m", [3, 16, 32, 64])
def test_gauss_jordan_inv_matches_numpy(m):
    """Array widths from the reference's 3-mic preset to 64 channels."""
    a = make_hpd(24, m, seed=m).astype(np.complex128)
    inv = np.asarray(gauss_jordan_inv(jnp.asarray(a)))
    ref = np.linalg.inv(a)
    assert np.max(np.abs(inv - ref)) < 1e-10 * np.max(np.abs(ref))


def test_gauss_jordan_inv_float32_identity():
    a = make_hpd(700, 16, seed=2)
    inv = np.asarray(gauss_jordan_inv(jnp.asarray(a)))
    prod = np.einsum("bmk,bkn->bmn", a.astype(np.complex128), inv)
    assert np.max(np.abs(prod - np.eye(16)[None])) < 1e-4


def test_polished_inverse_matches_numpy():
    """batched_inv's Newton-Schulz step (pinned to full precision) keeps a
    poorly conditioned float32 inverse at round-off."""
    a = make_hpd(256, 16, seed=3, cond_boost=0.05)
    ref = np.linalg.inv(a.astype(np.complex128))
    pol = np.asarray(batched_inv(jnp.asarray(a), polish=True))
    assert np.max(np.abs(pol - ref)) < 1e-5 * np.max(np.abs(ref))


def test_rhs_refinement_equals_newton_polish():
    """x = X d; x += X (d - A x) must reproduce X(2I - AX) d — the identity
    that lets mvdr_solve/lcmv_solve skip the M^3 Newton step."""
    a = make_hpd(512, 16, seed=4, cond_boost=0.05)
    aj = jnp.asarray(a)
    rng = np.random.default_rng(5)
    d = (rng.standard_normal((512, 16))
         + 1j * rng.standard_normal((512, 16))).astype(np.complex64)
    dj = jnp.asarray(d)
    hp = "highest"

    polished = batched_inv(aj, polish=True)
    x_newton = np.asarray(jnp.einsum("bmk,bk->bm", polished, dj,
                                     precision=hp))

    raw = batched_inv(aj, polish=False)
    x0 = jnp.einsum("bmk,bk->bm", raw, dj, precision=hp)
    resid = dj - jnp.einsum("bmk,bk->bm", aj, x0, precision=hp)
    x_refined = np.asarray(x0 + jnp.einsum("bmk,bk->bm", raw, resid,
                                           precision=hp))

    scale = np.max(np.abs(x_newton))
    assert np.max(np.abs(x_refined - x_newton)) < 1e-5 * scale
    # and the refined solution is a genuine solve of the system
    x_ref64 = np.linalg.solve(a.astype(np.complex128),
                              d.astype(np.complex128)[..., None])[..., 0]
    assert np.max(np.abs(x_refined - x_ref64)) < 1e-4 * scale
