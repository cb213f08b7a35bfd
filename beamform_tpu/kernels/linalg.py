"""Batched small-matrix linear algebra.

The MVDR/LCMV matrices are Hermitian positive (semi)definite after the
reference's 1.001 diagonal loading (mvdr.cpp:87), so an unpivoted
Gauss-Jordan elimination is numerically safe and fully vectorizes over the
batch: M steps of rank-1 updates, every step a handful of (B, M, M)
elementwise ops that XLA fuses. ``jnp.linalg.inv`` would instead run a
pivoted LU per matrix.

Singular inputs (the cold-start covariance) produce inf/NaN like the
reference's Eigen ``.inverse()`` garbage.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gauss_jordan_inv(a):
    """Batched matrix inverse via unpivoted Gauss-Jordan.

    a: (..., M, M) real or complex, diagonally dominant / HPD. Every step
    is elementwise (no matrix product), so no TF32 rounding can enter.
    """
    m = a.shape[-1]
    inv0 = jnp.broadcast_to(jnp.eye(m, dtype=a.dtype), a.shape)
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)

    def step(i, carry):
        mat, inv = carry
        prow = jax.lax.dynamic_slice_in_dim(mat, i, 1, axis=-2)
        pirow = jax.lax.dynamic_slice_in_dim(inv, i, 1, axis=-2)
        piv = jax.lax.dynamic_slice_in_dim(prow, i, 1, axis=-1)
        prow = prow / piv
        pirow = pirow / piv
        col = jax.lax.dynamic_slice_in_dim(mat, i, 1, axis=-1)  # (.., M, 1)
        is_pivot_row = row_ids == i                             # (M, 1)
        factor = jnp.where(is_pivot_row, 0, col)
        mat = mat - factor * prow
        inv = inv - factor * pirow
        mat = jnp.where(is_pivot_row, prow, mat)
        inv = jnp.where(is_pivot_row, pirow, inv)
        return mat, inv

    _, inv = jax.lax.fori_loop(0, m, step, (a, inv0))
    return inv
