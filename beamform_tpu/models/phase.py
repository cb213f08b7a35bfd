"""Phase-difference masking beamformer.

Reference: phase.cpp — per bin, align each mic's phase with the steering
weights (phase.cpp:102-104), take the mean pairwise wrapped phase distance
over all mic pairs (recursive get_overall_phase_diff, phase.cpp:53-68), and
either keep the mean magnitude at the reference mic's phase or attenuate by
``mag_mult`` (phase.cpp:100-123). A low-magnitude gate
(``mag_mean/fft_win > mag_threshold``) short-circuits to attenuation.

Design: the recursion over mic pairs becomes a vectorized reduction over
the static upper-triangle pair list; everything is stateless per frame, so
the whole run is one batched elementwise map over (frames, bins) that XLA
fuses — no scan at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from beamform_tpu.config import EngineConfig, PhaseParams
from beamform_tpu.geometry import ArrayGeometry
from beamform_tpu.models import common
from beamform_tpu.models.batching import BatchableModel


def pair_indices(m: int):
    ia, ib = np.triu_indices(m, k=1)
    return ia.astype(np.int32), ib.astype(np.int32)


def mean_pairwise_phase_dist(aligned_phase, ia, ib):
    """aligned_phase (..., M, N) -> (..., N): mean over pairs of the wrapped
    absolute difference (d > pi -> 2*pi - d), phase.cpp:57-61."""
    d = jnp.abs(jnp.take(aligned_phase, ia, axis=-2)
                - jnp.take(aligned_phase, ib, axis=-2))
    d = jnp.where(d > jnp.pi, 2.0 * jnp.pi - d, d)
    return jnp.mean(d, axis=-2)


def phase_mask_spectral(x_spec, weights, params: PhaseParams, nfft: int,
                        ia, ib):
    """(T, M, N) spectra + (T, M, N)|(M, N) weights -> (T, N) output bins."""
    mag_mean = jnp.mean(jnp.abs(x_spec), axis=-2)        # (T, N)
    pha = jnp.arctan2(x_spec[..., 0, :].imag, x_spec[..., 0, :].real)
    aligned = jnp.conj(weights) * x_spec
    aligned_phase = jnp.arctan2(aligned.imag, aligned.real)
    diff_mean = mean_pairwise_phase_dist(aligned_phase, ia, ib)

    min_phase_rad = params.min_phase * jnp.pi / 180.0
    keep = ((mag_mean / nfft > params.mag_threshold)
            & (diff_mean < min_phase_rad))
    mag = jnp.where(keep, mag_mean, mag_mean * params.mag_mult)
    y = common.from_mag_phase(mag, pha)
    # DC bin: y[0] = X0[0] (phase.cpp:87)
    return y.at[..., 0].set(x_spec[..., 0, 0])


class PhaseModel(BatchableModel):
    name = "phase"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: PhaseParams = PhaseParams(), interference_angles=()):
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        self.np_r = np.float64 if engine.dtype == "float64" else np.float32
        self.freqs = common.make_freqs_ext(engine)
        self.window = common.make_window(engine, self.rdtype)
        self.ia, self.ib = pair_indices(geom.num_mics)
        self._jit = jax.jit(self._forward)

    def stream_init(self):
        return common.wola_carry_init(self.engine, self.geom.num_mics,
                                      self.rdtype)

    def _forward(self, x, thetas, w_idx, carry: common.WolaCarry):
        spec, tail = common.stft_ext_carry(x, self.engine, self.window,
                                           self.cdtype, carry.tail)
        w_uniq = common.weights_for_thetas(self.geom, self.freqs, thetas,
                                           self.rdtype, self.cdtype)

        # the pairwise tensor is (T, M(M-1)/2, NB) — chunk the stateless
        # mask over frame blocks so it never materializes whole
        def mask_fn(args):
            spec_b, idx_b = args
            return phase_mask_spectral(
                spec_b, w_uniq[idx_b], self.params, self.engine.fft_win,
                self.ia, self.ib)

        y = common.map_frame_blocks(mask_fn, spec, w_idx,
                                    pairs=len(self.ia))
        out, prev = common.istft_ext_carry(y, self.engine, self.window,
                                           carry.out_prev)
        return out, common.WolaCarry(tail, prev)

    def process_chunk(self, x_chunk, theta, state):
        x = jnp.asarray(x_chunk, dtype=self.rdtype)
        t = x.shape[-1] // self.engine.hop
        uniq, w_idx = self._theta_ctrl(theta, t)
        return self._jit(x, uniq, w_idx, state)

    def process(self, x, theta=0.0):
        x = common.prepare_input(x, self.engine, self.rdtype)
        out, _ = self.process_chunk(x, theta, self.stream_init())
        return out
