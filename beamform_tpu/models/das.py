"""Delay-and-sum beamformer (frequency domain).

Reference: das.cpp — per bin y(f) = w(f)^H x(f) / M (das.cpp:60-63) with
steering weights w_m(f) = exp(-i 2 pi f tau_m), mic0 = 1 (das.cpp:27-45).

Design: the whole run is one batched multiply-and-sum over (frames, mics,
bins) -- the per-bin C++ loop becomes a single reduction the compiler fuses
with the steering-weight gather; a theta timeline enters as per-frame
steering weights computed in-graph. Streaming state is just the WOLA
boundary carry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from beamform_tpu.config import DasParams, EngineConfig
from beamform_tpu.geometry import ArrayGeometry
from beamform_tpu.models import common
from beamform_tpu.models.batching import BatchableModel


def das_spectral(x_spec, weights):
    """y[t, j] = sum_m conj(w[m, j]) x[t, m, j] / M.

    ``x_spec``: (T, M, N); ``weights``: (M, N) or (T, M, N).
    """
    m = x_spec.shape[-2]
    # multiply-and-sum rather than a dot: XLA fuses it, and no TF32 pass
    # can enter a float32 contraction
    return jnp.sum(jnp.conj(weights) * x_spec, axis=-2) / m


class DasModel(BatchableModel):
    name = "das"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: DasParams = DasParams(), interference_angles=()):
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        self.np_r = np.float64 if engine.dtype == "float64" else np.float32
        self.freqs = common.make_freqs_ext(engine)
        self.window = common.make_window(engine, self.rdtype)
        self._jit = jax.jit(self._forward)

    def stream_init(self):
        return common.wola_carry_init(self.engine, self.geom.num_mics,
                                      self.rdtype)

    def _forward(self, x, thetas, w_idx, carry: common.WolaCarry):
        w_uniq = common.weights_for_thetas(self.geom, self.freqs, thetas,
                                           self.rdtype, self.cdtype)
        # (M, T, NB) layout straight from the rFFT: sum over mics without
        # transposing the spectra
        spec_mt, tail = common.stft_ext_carry_mt(
            x, self.engine, self.window, self.cdtype, carry.tail)
        w = jnp.moveaxis(w_uniq[w_idx], 1, 0)             # (M, T, NB)
        y = jnp.sum(jnp.conj(w) * spec_mt, axis=0) / spec_mt.shape[0]
        out, prev = common.istft_ext_carry(y, self.engine, self.window,
                                           carry.out_prev)
        return out, common.WolaCarry(tail, prev)

    def process_chunk(self, x_chunk, theta, state):
        """Streaming step: (M, C*hop) in, ((C*hop,) out, new state)."""
        x = jnp.asarray(x_chunk, dtype=self.rdtype)
        t = x.shape[-1] // self.engine.hop
        uniq, w_idx = self._theta_ctrl(theta, t)
        return self._jit(x, uniq, w_idx, state)

    def process(self, x, theta=0.0):
        """x: (M, S) -> (S',) with S' = S rounded up to a hop multiple."""
        x = common.prepare_input(x, self.engine, self.rdtype)
        out, _ = self.process_chunk(x, theta, self.stream_init())
        return out
