"""MCRA noise estimation / spectral subtraction node (Cohen & Berdugo 2002).

Reference: mcra.cpp:64-155. Operates on mic0 only. Per window: frequency
smoothing of |X|^2 with kernel [0.25, 0.5, 0.25] skipping DC
(mcra.cpp:83-92), temporal smoothing S = aS*S_prev + (1-aS)*S_f, minima
tracking every L windows, gated recursive noise update with two rates, then
spectral subtraction |X| - sqrt(lambda) at the input phase.

Faithful quirks: S_f[0] = |X(0)| (an *amplitude*, mcra.cpp:83) and the DC
output bin is never written — the loop writes y_fft[j] with j == fft_win at
mcra.cpp:127 (out of bounds); on a fresh heap the real y_fft[0] stays 0
forever, so faithful DC output is 0 (EngineConfig.bug_dc_zero).

Design: the per-window recurrence is a ``lax.scan`` over frames with all
bins vectorized in the carry; the frequency smoothing is a static 3-tap
stencil (shifts + masked adds).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from beamform_tpu.config import EngineConfig, McraParams
from beamform_tpu.geometry import ArrayGeometry
from beamform_tpu.models import common
from beamform_tpu.models.batching import BatchableModel


class McraState(NamedTuple):
    s_prev: jnp.ndarray   # (N,)
    s_tmp: jnp.ndarray    # (N,)
    s_min: jnp.ndarray    # (N,)
    lam: jnp.ndarray      # (N,) noise estimate
    current_l: jnp.ndarray  # scalar int32
    first_l: jnp.ndarray    # scalar bool


def mcra_init_state(nfft: int, rdtype) -> McraState:
    z = jnp.zeros((nfft,), dtype=rdtype)
    return McraState(z, z, z, z, jnp.int32(0), jnp.bool_(True))


def freq_smooth(sq, dc_amp):
    """3-tap smoothing skipping DC (mcra.cpp:83-92), extended-bin layout.

    S_f[j] = 0.25*sq[j-1] (if j-1 >= 1) + 0.5*sq[j] + 0.25*sq[j+1]
    (if j+1 < N) for j >= 1; S_f[0] = dc_amp (an amplitude, not a power).

    In the extended layout (NB = N/2+2, shadow at NB-1 = mirror of N/2-1)
    the stencil is naturally correct through bin N/2 (its full-layout right
    neighbour N/2+1 has |X| equal to bin N/2-1, which is exactly what the
    shadow slot holds); the shadow's own smoothed value equals the mirror's
    by symmetry, set explicitly.
    """
    n = sq.shape[-1]
    left = jnp.concatenate([jnp.zeros_like(sq[..., :2]), sq[..., 1:n - 1]],
                           axis=-1)          # sq[j-1] valid for j >= 2
    right = jnp.concatenate([sq[..., 1:], jnp.zeros_like(sq[..., :1])],
                            axis=-1)         # sq[j+1] valid for j <= N-2
    s_f = 0.25 * left + 0.5 * sq + 0.25 * right
    s_f = s_f.at[..., n - 1].set(s_f[..., n - 3])  # shadow := mirror value
    return s_f.at[..., 0].set(dc_amp)


def mcra_update(state: McraState, s_f, sq, p: McraParams):
    """One MCRA recurrence step over all bins (mcra.cpp:95-124).
    Returns (new_state, lambda_after_update)."""
    s = p.alphaS * state.s_prev + (1.0 - p.alphaS) * s_f
    rollover = state.current_l > p.L
    s_min = jnp.where(rollover, jnp.minimum(state.s_tmp, s),
                      jnp.minimum(state.s_min, s))
    s_tmp = jnp.where(rollover, s, jnp.minimum(state.s_tmp, s))
    current_l = jnp.where(rollover, jnp.int32(1), state.current_l + 1)
    first_l = jnp.logical_and(state.first_l, jnp.logical_not(rollover))

    cond = first_l | (s < s_min * p.delta) | (state.lam > sq)
    inv_l = 1.0 / current_l.astype(sq.dtype)
    use_first = first_l & (inv_l > p.alphaD)
    lam_first = inv_l * state.lam + (1.0 - inv_l) * sq
    lam_norm = p.alphaD2 * state.lam + (1.0 - p.alphaD) * sq
    lam = jnp.where(cond, jnp.where(use_first, lam_first, lam_norm),
                    state.lam)
    return McraState(s, s_tmp, s_min, lam, current_l, first_l), lam


class McraModel(BatchableModel):
    name = "mcra"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: McraParams = McraParams(), interference_angles=()):
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        import numpy as _np
        self.np_r = _np.float64 if engine.dtype == "float64" else _np.float32
        self.window = common.make_window(engine, self.rdtype)
        self._jit = jax.jit(self._forward)

    def _forward(self, x, thetas, w_idx, state):
        del thetas, w_idx  # mcra has no steering (mcra.cpp)
        p = self.params
        carry, mstate = state
        spec, tail = common.stft_ext_carry(x[:1], self.engine, self.window,
                                           self.cdtype, carry.tail)
        x_spec = spec[:, 0, :]                          # (T, NB) mic0 only
        sq = jnp.abs(x_spec) ** 2
        s_f = freq_smooth(sq, jnp.abs(x_spec[..., 0]))

        def step(state, inp):
            s_f_t, sq_t, x_t = inp
            state, lam = mcra_update(state, s_f_t, sq_t, p)
            mag_x, pha = common.polar_mag_phase(x_t)
            if p.out_only_noise:
                mag = jnp.sqrt(lam) * p.out_amp
            else:
                mag = jnp.maximum(mag_x - jnp.sqrt(lam), 0.0) * p.out_amp
            y = common.from_mag_phase(mag, pha)
            dc = (jnp.zeros((), dtype=y.dtype) if self.engine.bug_dc_zero
                  else x_t[0])
            return state, y.at[0].set(dc)

        mstate, y = jax.lax.scan(step, mstate, (s_f, sq, x_spec),
                                unroll=8)
        out, prev = common.istft_ext_carry(y, self.engine, self.window,
                                           carry.out_prev)
        return out, (common.WolaCarry(tail, prev), mstate)

    def stream_init(self):
        return (common.wola_carry_init(self.engine, 1, self.rdtype),
                mcra_init_state(common.num_bins(self.engine),
                                self.rdtype))

    def process_chunk(self, x_chunk, theta, state):
        x = jnp.asarray(x_chunk, dtype=self.rdtype)
        t = x.shape[-1] // self.engine.hop
        uniq, w_idx = self._theta_ctrl(0.0, t)
        return self._jit(x, uniq, w_idx, state)

    def process(self, x, theta=0.0):
        x = common.prepare_input(x, self.engine, self.rdtype)
        out, _ = self.process_chunk(x, theta, self.stream_init())
        return out
