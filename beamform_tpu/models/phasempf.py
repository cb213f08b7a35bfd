"""Phase-masking beamformer with multi-channel post-filter (Valin 2007).

Reference: phasempf.cpp. Produces two beams per bin — SOI (mask) and
interference (complementary anti-mask) sharing the mean magnitude and the
reference mic's phase (phasempf.cpp:210-248) — then runs an embedded MCRA
noise estimate on the SOI power (phasempf.cpp:140-191) and a bi-channel
post-filter: leakage Z/lambda_leak (phasempf.cpp:255-261), reverberation
estimates for both channels (phasempf.cpp:263-266), total
lambda = sqrt(noise + leak + rev0 + rev1) (phasempf.cpp:268-270), spectral
subtraction with a noise floor (phasempf.cpp:273-295), and a time-domain
moving-average output smoother (phasempf.cpp:330-334).

Faithful quirks reproduced (all shape real output):
* the embedded MCRA's frequency smoothing reads ``out_soi_square[j]`` instead
  of ``[this_j]`` (phasempf.cpp:150) — each bin is scaled by the sum of
  in-range kernel coefficients (0.75 at the edges, 1.0 inside) instead of
  being smoothed;
* the reverberation update uses ``(1 - gamma/delta)`` (phasempf.cpp:265-266),
  not the paper's ``(1-gamma)/delta``;
* the DC output bin is never written (OOB write at phasempf.cpp:274) — with
  ``bug_dc_zero`` the DC output stays 0.

Design: the stateless dual-beam mask is fully batched over (frames, bins);
only the MCRA/MPF recurrences run in a ``lax.scan``; the output smoother is
a causal moving average over the whole stream.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from beamform_tpu.config import EngineConfig, PhasempfParams
from beamform_tpu.geometry import ArrayGeometry
from beamform_tpu.models import common
from beamform_tpu.models.batching import BatchableModel
from beamform_tpu.models.phase import mean_pairwise_phase_dist, pair_indices


class MpfState(NamedTuple):
    s_prev: jnp.ndarray
    s_tmp: jnp.ndarray
    s_min: jnp.ndarray
    lam_noise: jnp.ndarray
    z: jnp.ndarray
    lam_rev0: jnp.ndarray
    lam_rev1: jnp.ndarray
    current_l: jnp.ndarray
    first_l: jnp.ndarray


_MPF_INIT_MEMO = {}


def mpf_init_state(nfft: int, rdtype) -> MpfState:
    """Built on the device by a compiled program and memoized: serving
    re-inits state every process() call (see common.device_zeros)."""
    key = (nfft, jnp.dtype(rdtype).str, str(jax.config.jax_default_device))
    st = _MPF_INIT_MEMO.get(key)
    if st is None:
        def build():
            z = jnp.zeros((nfft,), dtype=rdtype)
            return MpfState(z, z, z, z, z, z, z, jnp.int32(0),
                            jnp.bool_(True))
        st = jax.jit(build)()
        if len(_MPF_INIT_MEMO) > 16:
            _MPF_INIT_MEMO.clear()
        _MPF_INIT_MEMO[key] = st
    return st


def dual_beam(x_spec, weights, min_phase_rad, min_mag, ia, ib):
    """(T, M, N) -> (soi, intf) both (T, N) complex (phasempf.cpp:210-248)."""
    aligned = jnp.conj(weights) * x_spec
    aligned_phase = jnp.arctan2(aligned.imag, aligned.real)
    diff_mean = mean_pairwise_phase_dist(aligned_phase, ia, ib)
    mag_mean = jnp.mean(jnp.abs(x_spec), axis=-2)
    pha = jnp.arctan2(x_spec[..., 0, :].imag, x_spec[..., 0, :].real)
    big = common.from_mag_phase(mag_mean, pha)
    small = common.from_mag_phase(mag_mean * min_mag, pha)
    is_soi = diff_mean < min_phase_rad
    soi = jnp.where(is_soi, big, small)
    intf = jnp.where(is_soi, small, big)
    dc = x_spec[..., 0, 0]
    return soi.at[..., 0].set(dc), intf.at[..., 0].set(dc)


def buggy_freq_smooth(soi_sq, dc_amp):
    """phasempf.cpp:144-153 — the [j]-instead-of-[this_j] variant: each bin
    scaled by the sum of in-range kernel coefficients.

    Extended-layout note: full-layout bin 1 and its mirror N-1 both get
    scale 0.75; here bin 1 carries both. The shadow bin (mirror of N/2-1)
    is interior in the full layout, so scale 1.0.
    """
    n = soi_sq.shape[-1]
    scale = jnp.ones((n,), dtype=soi_sq.dtype)
    scale = scale.at[1].set(0.75)       # left tap (this_j=0) out of range
    s_f = soi_sq * scale
    return s_f.at[..., 0].set(dc_amp)


def _ma_shifted_sum(yp, size: int, n: int):
    """sum of ``size`` shifted views — XLA fuses this into one elementwise
    pass, where jnp.convolve would lower to a general convolution."""
    acc = yp[size - 1:size - 1 + n]
    for k in range(1, size):
        acc = acc + yp[size - 1 - k:size - 1 - k + n]
    return acc / size


def moving_average_causal(y, size: int):
    """Causal length-``size`` moving average with zero history, matching the
    shift-register smoother at phasempf.cpp:330-334."""
    if size <= 1:
        return y
    pad = jnp.zeros((size - 1,), dtype=y.dtype)
    yp = jnp.concatenate([pad, y])
    return _ma_shifted_sum(yp, size, y.shape[0])


def moving_average_causal_carry(y, size: int, tail):
    """Streaming variant: ``tail`` is the previous (size-1,) samples.
    Returns (smoothed, new_tail)."""
    if size <= 1:
        return y, tail
    yp = jnp.concatenate([jnp.asarray(tail, dtype=y.dtype), y])
    return _ma_shifted_sum(yp, size, y.shape[0]), yp[-(size - 1):]


class PhasempfModel(BatchableModel):
    name = "phasempf"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: PhasempfParams = PhasempfParams(),
                 interference_angles=()):
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        self.np_r = np.float64 if engine.dtype == "float64" else np.float32
        self.freqs = common.make_freqs_ext(engine)
        self.window = common.make_window(engine, self.rdtype)
        self.ia, self.ib = pair_indices(geom.num_mics)
        self._jit = jax.jit(self._forward)

    def stream_init(self):
        smooth_tail = common.device_zeros(
            (max(self.params.smooth_size - 1, 0),), self.rdtype)
        return (common.wola_carry_init(self.engine, self.geom.num_mics,
                                       self.rdtype),
                mpf_init_state(common.num_bins(self.engine),
                               self.rdtype),
                smooth_tail)

    def _forward(self, x, thetas, w_idx, state):
        p = self.params
        carry, mstate, smooth_tail = state
        x_spec, tail = common.stft_ext_carry(x, self.engine, self.window,
                                             self.cdtype, carry.tail)
        w_uniq = common.weights_for_thetas(self.geom, self.freqs, thetas,
                                           self.rdtype, self.cdtype)
        min_phase_rad = p.min_phase * np.pi / 180.0

        # chunk the stateless dual-beam mask over frame blocks (the pairwise
        # tensor is (T, M(M-1)/2, NB) otherwise)
        def mask_fn(args):
            spec_b, idx_b = args
            return dual_beam(spec_b, w_uniq[idx_b], min_phase_rad, p.min_mag,
                             self.ia, self.ib)

        soi, intf = common.map_frame_blocks(mask_fn, x_spec, w_idx,
                                            pairs=len(self.ia))
        soi_sq = jnp.abs(soi) ** 2
        soi_sq = soi_sq.at[..., 0].set(0.0)   # set only for j >= 1
        int_sq = jnp.abs(intf) ** 2
        int_sq = int_sq.at[..., 0].set(0.0)
        s_f = buggy_freq_smooth(soi_sq, jnp.abs(soi[..., 0]))

        def step(st: MpfState, inp):
            s_f_t, soi_sq_t, int_sq_t, soi_t = inp
            # embedded MCRA on the SOI channel (phasempf.cpp:140-191)
            s = p.MCRA_alphaS * st.s_prev + (1 - p.MCRA_alphaS) * s_f_t
            rollover = st.current_l > p.MCRA_L
            s_min = jnp.where(rollover, jnp.minimum(st.s_tmp, s),
                              jnp.minimum(st.s_min, s))
            s_tmp = jnp.where(rollover, s, jnp.minimum(st.s_tmp, s))
            current_l = jnp.where(rollover, jnp.int32(1), st.current_l + 1)
            first_l = st.first_l & jnp.logical_not(rollover)
            cond = (first_l | (s < s_min * p.MCRA_delta)
                    | (st.lam_noise > soi_sq_t))
            inv_l = 1.0 / current_l.astype(s.dtype)
            use_first = first_l & (inv_l > p.MCRA_alphaD)
            lam_first = inv_l * st.lam_noise + (1 - inv_l) * soi_sq_t
            lam_norm = (p.MCRA_alphaD2 * st.lam_noise
                        + (1 - p.MCRA_alphaD) * soi_sq_t)
            lam_noise = jnp.where(
                cond, jnp.where(use_first, lam_first, lam_norm), st.lam_noise)

            # MPF leakage + reverberation (phasempf.cpp:255-270)
            z = p.MPF_alphaS * st.z + (1 - p.MPF_alphaS) * int_sq_t
            leak = p.MPF_eta * z
            rev_c = 1.0 - p.MPF_rev_gamma / p.MPF_rev_delta  # faithful quirk
            rev0 = p.MPF_rev_gamma * st.lam_rev0 + rev_c * soi_sq_t
            rev1 = p.MPF_rev_gamma * st.lam_rev1 + rev_c * int_sq_t
            lam = jnp.sqrt(lam_noise + leak + rev0 + rev1)

            mag_soi, pha = common.polar_mag_phase(soi_t)
            if p.out_only_noise:
                mag = lam * p.out_amp
            else:
                if p.out_only_mcra:
                    mag = (mag_soi - jnp.sqrt(lam_noise)) * p.out_amp
                else:
                    mag = (mag_soi - lam) * p.out_amp
                mag = jnp.where(mag < 0, p.noise_floor, mag)
            y = common.from_mag_phase(mag, pha)
            dc = (jnp.zeros((), dtype=y.dtype) if self.engine.bug_dc_zero
                  else soi_t[0])
            new = MpfState(s, s_tmp, s_min, lam_noise, z, rev0, rev1,
                           current_l, first_l)
            return new, y.at[0].set(dc)

        mstate, y = jax.lax.scan(step, mstate, (s_f, soi_sq, int_sq, soi),
                                unroll=8)
        out, prev = common.istft_ext_carry(y, self.engine, self.window,
                                           carry.out_prev)
        out, smooth_tail = moving_average_causal_carry(out, p.smooth_size,
                                                       smooth_tail)
        return out, (common.WolaCarry(tail, prev), mstate, smooth_tail)

    def process_chunk(self, x_chunk, theta, state):
        x = jnp.asarray(x_chunk, dtype=self.rdtype)
        t = x.shape[-1] // self.engine.hop
        uniq, w_idx = self._theta_ctrl(theta, t)
        return self._jit(x, uniq, w_idx, state)

    def process(self, x, theta=0.0):
        x = common.prepare_input(x, self.engine, self.rdtype)
        out, _ = self.process_chunk(x, theta, self.stream_init())
        return out
