"""MVDR beamformer with band/energy-gated frequency subset.

Reference: mvdr.cpp — per bin, sample covariance R from the last
``past_windows`` FFTs with 1.001 multiplicative diagonal loading
(R = (P P^H) .* whiteR, mvdr.cpp:87, 239-243), distortionless weights
w = R^-1 d / (d^H R^-1 d) (mvdr.cpp:88-94), band gate ``freq_min..freq_max``
(else output 0), energy gate ``freq_mag_threshold`` on the mic-mean |X|
(else passthrough 0.01 * X0), ``out_amp`` gain applied to the processed time
window (mvdr.cpp:112-114). The FFT history shifts every frame for in-band
bins regardless of the energy gate (mvdr.cpp:100-101).

Design: the per-bin history is a rolling ``(W, M, N_ib)`` tensor carried
through a ``lax.scan`` over blocks of frames; covariances are batched outer
products summed by one banded product; the per-bin Eigen ``.inverse()``
becomes a batched complex inverse over the static in-band bin subset
(masking replaces data-dependent branching). Every float32 product is
pinned to full precision, so no TF32 pass enters the solve.
Like the reference, singular early-history covariances produce non-finite
weights — parity scenes keep the first W windows below the energy gate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from beamform_tpu.config import EngineConfig, MvdrParams
from beamform_tpu.geometry import ArrayGeometry
from beamform_tpu.models import common
from beamform_tpu.models.batching import BatchableModel


def white_r(m: int, rdtype):
    """ones + 0.001 on the diagonal (mvdr.cpp:239-243)."""
    return (jnp.ones((m, m), dtype=rdtype)
            + 0.001 * jnp.eye(m, dtype=rdtype))


def batched_inv(a, polish: bool = True):
    """Batched complex matrix inverse (replaces Eigen .inverse()).

    The MVDR/LCMV matrices are Hermitian positive (semi)definite after the
    1.001 diagonal loading, so an unpivoted vectorized Gauss-Jordan
    (kernels/linalg.py) is safe. One Newton-Schulz step
    X <- X (2I - A X) polishes the float32 result to ~1e-6 relative;
    callers that apply the inverse to a right-hand side should instead pass
    ``polish=False`` and refine at the application site
    (x = X b; x += X (b - A x) — the identical value at M^2 instead of
    2 M^3 cost, since X(2I-AX) b = Xb + X(b - A(Xb))). Singular cold-start
    covariances yield inf/NaN, like the reference's Eigen garbage.
    """
    from beamform_tpu.kernels.linalg import gauss_jordan_inv
    inv = gauss_jordan_inv(a)
    if not polish:
        return inv
    hp = jax.lax.Precision.HIGHEST
    eye2 = 2.0 * jnp.eye(a.shape[-1], dtype=a.dtype)
    return jnp.matmul(inv, eye2 - jnp.matmul(a, inv, precision=hp),
                      precision=hp)


def mvdr_solve(r, d):
    """w = R^-1 d / (d^H R^-1 d) per bin; r (..., M, M), d (..., M).

    The unpolished Gauss-Jordan inverse is refined on the right-hand side:
    one residual step reproduces the Newton-polished solution exactly.
    """
    hp = jax.lax.Precision.HIGHEST   # a TF32 pass would lose the solve
    inv = batched_inv(r, polish=False)
    x0 = jnp.einsum("...mk,...k->...m", inv, d, precision=hp)
    resid = d - jnp.einsum("...mk,...k->...m", r, x0, precision=hp)
    num = x0 + jnp.einsum("...mk,...k->...m", inv, resid, precision=hp)
    den = jnp.einsum("...m,...m->...", jnp.conj(d), num, precision=hp)
    return num / den[..., None]


class MvdrModel(BatchableModel):
    name = "mvdr"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: MvdrParams = MvdrParams(), interference_angles=()):
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        import numpy as _np
        self.np_r = _np.float64 if engine.dtype == "float64" else _np.float32
        self.freqs = common.make_freqs_ext(engine)
        self.window = common.make_window(engine, self.rdtype)
        mask = common.band_mask(self.freqs, params.freq_min, params.freq_max)
        self.ib = np.nonzero(mask)[0].astype(np.int32)   # in-band bin indices
        self._jit = jax.jit(self._forward)

    def stream_init(self):
        return (common.wola_carry_init(self.engine, self.geom.num_mics,
                                       self.rdtype),
                common.device_zeros((self.params.past_windows,
                                     self.geom.num_mics, len(self.ib)),
                                    self.cdtype))

    def _block_frames(self, t: int) -> int:
        """Frames per covariance block: the per-frame solves batch over
        (CB * Nib) matrices, a few large launches instead of T small
        sequential ones; CB is capped so the outer-product workspace
        (CB+W, Nib, M, M) complex stays ~128 MB."""
        m = self.geom.num_mics
        w = self.params.past_windows
        budget = 128e6 / (len(self.ib) * m * m * 8)
        cb = max(8, min(128, int(budget) - w, t))
        return cb

    def _forward(self, x, thetas, w_idx, state):
        p = self.params
        m = self.geom.num_mics
        n = self.engine.fft_win
        w_hist = p.past_windows
        carry, hist0 = state
        x_spec, tail = common.stft_ext_carry(x, self.engine, self.window,
                                             self.cdtype, carry.tail)
        w_uniq = common.weights_for_thetas(self.geom, self.freqs, thetas,
                                           self.rdtype, self.cdtype)
        mag = common.mag_mean_over_mics(x_spec, n)         # (T, NB)
        ib = jnp.asarray(self.ib)
        x_ib = x_spec[:, :, ib]                            # (T, M, Nib)
        mag_ib = mag[:, ib]
        d_ib = w_uniq[:, :, ib]                            # (U, M, Nib)
        wr = white_r(m, self.rdtype).astype(self.cdtype)

        t = x_ib.shape[0]
        cb = self._block_frames(t)
        tpad = -(-t // cb) * cb
        x_blk = jnp.pad(x_ib, ((0, tpad - t), (0, 0), (0, 0)))
        mag_blk = jnp.pad(mag_ib, ((0, tpad - t), (0, 0)))
        u_blk = jnp.pad(w_idx, (0, tpad - t))
        x_blk = x_blk.reshape(tpad // cb, cb, m, -1)
        mag_blk = mag_blk.reshape(tpad // cb, cb, -1)
        u_blk = u_blk.reshape(tpad // cb, cb)

        # sliding-window selector: G[t] = sum of the W frames BEFORE frame t
        # (the reference updates history after solving, mvdr.cpp:87,100-101)
        # — as a banded 0/1 product over the frame axis (one pass instead
        # of a cumsum's many sweeps over the outer-product tensor)
        band = (jnp.tri(cb, cb + w_hist, w_hist - 1, dtype=self.rdtype)
                - jnp.tri(cb, cb + w_hist, -1, dtype=self.rdtype))

        hp = jax.lax.Precision.HIGHEST

        def block_step(hist, inp):
            xb, magb, ub = inp                    # (CB, M, Nib), (CB, Nib)
            ext = jnp.concatenate([hist, xb], axis=0)      # (W+CB, M, Nib)
            o = jnp.einsum("tmn,tkn->tnmk", ext, jnp.conj(ext), precision=hp)
            g = jnp.einsum("ct,tnmk->cnmk", band.astype(o.dtype), o,
                           precision=hp)
            r = g * wr[None, None, :, :]                   # (CB, Nib, M, M)
            d = jnp.moveaxis(d_ib[ub], 1, -1)              # (CB, Nib, M)
            w_opt = mvdr_solve(r, d)
            y_bf = jnp.einsum("tnm,tmn->tn", jnp.conj(w_opt), xb,
                              precision=hp)
            y_t = jnp.where(magb > p.freq_mag_threshold, y_bf,
                            xb[:, 0, :] * 0.01)
            return ext[cb:], y_t

        hist, y_blk = jax.lax.scan(block_step, hist0,
                                   (x_blk, mag_blk, u_blk))
        y_ib = y_blk.reshape(tpad, -1)[:t]
        # state continuity: the history is simply the last W frames seen
        hist = jnp.concatenate([hist0, x_ib], axis=0)[t:t + w_hist]

        y = jnp.zeros((x_spec.shape[0], x_spec.shape[2]),
                      dtype=self.cdtype)                      # (T, NB)
        y = y.at[:, ib].set(y_ib)
        y = y.at[:, 0].set(x_spec[:, 0, 0])                   # mvdr.cpp:76
        out, prev = common.istft_ext_carry(y, self.engine, self.window,
                                           carry.out_prev)
        return out * p.out_amp, (common.WolaCarry(tail, prev), hist)

    def process_chunk(self, x_chunk, theta, state):
        x = jnp.asarray(x_chunk, dtype=self.rdtype)
        t = x.shape[-1] // self.engine.hop
        uniq, w_idx = self._theta_ctrl(theta, t)
        return self._jit(x, uniq, w_idx, state)

    def process(self, x, theta=0.0):
        x = common.prepare_input(x, self.engine, self.rdtype)
        out, _ = self.process_chunk(x, theta, self.stream_init())
        return out
