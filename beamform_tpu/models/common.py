"""Shared building blocks for the beamformer models.

The reference's per-node ``apply_weights`` C++ loops become batched tensor
ops over ``(frames, mics, bins)`` here. Everything is a pure function of
``(static config, per-frame inputs)`` — no globals, no locks (SURVEY.md §7).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from beamform_tpu.config import EngineConfig
from beamform_tpu.dsp.wola import analyze, sqrt_hann, synthesize, pad_to_hop
from beamform_tpu.geometry import (
    ArrayGeometry,
    frequency_vector,
    steering_delays,
    steering_weights,
)


def dtypes_of(engine: EngineConfig):
    if engine.dtype == "float64":
        return jnp.float64, jnp.complex128
    return jnp.float32, jnp.complex64


def stft(x, engine: EngineConfig, window, cdtype):
    """(M, S) -> (T, M, nfft) complex spectra of windowed frames."""
    spec = analyze(x, engine.hop, window, cdtype=cdtype)  # (M, T, N)
    return jnp.moveaxis(spec, 0, 1)


def istft(y_spec, engine: EngineConfig, window):
    """(T, nfft) complex -> (T*hop,) real output stream."""
    return synthesize(y_spec, engine.hop, window)


# ---------------------------------------------------------------------------
# Extended rFFT ("shadow bin") layout.
#
# The reference's frequency vector is NOT mirror-symmetric: f[N/2-1] is
# overwritten to fs/2 while its mirror f[N/2+1] keeps -(N/2-1)fs/N, and
# f[N/2] reads 0 (util.h:190-199 + the uninitialised malloc slot). Steering
# weights built from it are therefore non-Hermitian at exactly one bin pair,
# and every other per-bin computation in every node is conjugation-
# equivariant (magnitudes, wrapped phase distances, MCRA power recursions,
# R-solves with conjugated history). So instead of the reference's full
# N-point complex FFT we run rFFT bins 0..N/2 PLUS one shadow bin — the
# mirror of bin N/2-1, fed conj(X[N/2-1]) and steered with f[N/2+1] — and
# fold at synthesis:  y_final[N/2-1] = (y[N/2-1] + conj(y_shadow))/2,
# Re() on bins 0 and N/2 (what real(ifft(.)) does to the Hermitian part).
# Half the FFT work and half the bin math, bit-equivalent output.
#
# Layout: NB = N/2 + 2 bins; index k <= N/2 is rFFT bin k; index N/2+1 is
# the shadow.
# ---------------------------------------------------------------------------


def ext_bins(nfft: int) -> int:
    return nfft // 2 + 2


def num_bins(engine: EngineConfig) -> int:
    """Width of the active bin layout (extended rFFT or full FFT)."""
    return engine.fft_win if engine.full_fft else ext_bins(engine.fft_win)


def make_freqs_ext(engine: EngineConfig) -> np.ndarray:
    """Frequency vector in the active bin layout (faithful quirks included):
    the extended-rFFT layout by default, or the reference's literal
    full-length vector under ``EngineConfig.full_fft`` (util.h:190-199)."""
    f = frequency_vector(engine.fft_win, engine.sample_rate,
                         exact=engine.exact_freqs)
    if engine.full_fft:
        return f
    n = engine.fft_win
    return np.concatenate([f[:n // 2 + 1], f[n // 2 + 1:n // 2 + 2]])


def _analysis_bins(frames, engine: EngineConfig, cdtype):
    """Windowed frames -> per-bin spectra in the active layout: extended
    rFFT (half the FFT work, bit-equivalent — see layout note above), or the
    reference's literal N-point complex FFT under ``EngineConfig.full_fft``
    (das.cpp:127-128) for on-device equivalence audits."""
    if engine.full_fft:
        return jnp.fft.fft(frames).astype(cdtype)         # (..., N)
    spec = jnp.fft.rfft(frames, axis=-1).astype(cdtype)   # (..., N/2+1)
    h = engine.fft_win // 2
    shadow = jnp.conj(spec[..., h - 1:h])
    return jnp.concatenate([spec, shadow], axis=-1)       # (..., NB)


def synth_frames_ext(y_ext, engine: EngineConfig):
    """Per-bin spectra in the active layout -> real time frames
    (pre-window): fold + irFFT, or real(ifft(.)) under full_fft — exactly
    what the reference's creal(ifft)/fft_win does (util.h:244-248)."""
    if engine.full_fft:
        return jnp.fft.ifft(y_ext).real
    return jnp.fft.irfft(fold_ext(y_ext, engine.fft_win), n=engine.fft_win,
                         axis=-1)


def stft_ext(x, engine: EngineConfig, window, cdtype):
    """(M, S) -> (T, M, NB) spectra in the active bin layout."""
    from beamform_tpu.dsp.wola import frame_signal
    frames = frame_signal(x, engine.hop) * jnp.asarray(window,
                                                       dtype=x.dtype)
    spec = _analysis_bins(frames, engine, cdtype)         # (M, T, NB)
    return jnp.moveaxis(spec, 0, 1)


def fold_ext(y_ext, nfft: int):
    """(..., NB) extended-layout bins -> (..., N/2+1) Hermitian rFFT bins."""
    h = nfft // 2
    y_r = y_ext[..., :h + 1]
    blend = 0.5 * (y_ext[..., h - 1] + jnp.conj(y_ext[..., h + 1]))
    y_r = y_r.at[..., h - 1].set(blend)
    # real(ifft(.)) keeps only Re of the self-conjugate bins
    y_r = y_r.at[..., 0].set(y_r[..., 0].real.astype(y_r.dtype))
    return y_r.at[..., h].set(y_r[..., h].real.astype(y_r.dtype))


def istft_ext(y_ext, engine: EngineConfig, window):
    """(T, NB) active-layout spectra -> (T*hop,) real output stream."""
    from beamform_tpu.dsp.wola import overlap_add
    p = synth_frames_ext(y_ext, engine)
    win = jnp.asarray(window, dtype=p.dtype)
    return overlap_add(p * win, engine.hop)


# ---------------------------------------------------------------------------
# Streaming carries: the WOLA boundary state between chunks — the functional
# replacement for the reference's persistent JACK ring buffers and
# double-buffered output windows (util.h:265-287). A whole-file run is just
# one chunk with a zero carry, so online == offline by construction.
# ---------------------------------------------------------------------------


_ZEROS_MEMO = {}


def device_zeros(shape, dtype):
    """Zeros made on the device by a compiled program and memoized (JAX
    arrays are immutable), so a fresh stream state costs no host-to-device
    copy per call. Kept until the served path is measured (ROADMAP D3).
    """
    key = (tuple(shape), jnp.dtype(dtype).str,
           str(jax.config.jax_default_device))
    out = _ZEROS_MEMO.get(key)
    if out is None:
        out = jax.jit(jnp.zeros, static_argnums=(0, 1))(tuple(shape), dtype)
        if len(_ZEROS_MEMO) > 64:
            _ZEROS_MEMO.clear()
        _ZEROS_MEMO[key] = out
    return out


class WolaCarry(NamedTuple):
    tail: jnp.ndarray       # (..., hop): last hop of input (ring content)
    out_prev: jnp.ndarray   # (..., hop): previous processed half-window


def wola_carry_init(engine: EngineConfig, num_mics: int, rdtype,
                    per_mic_out: bool = False) -> WolaCarry:
    h = engine.hop
    out_shape = (num_mics, h) if per_mic_out else (h,)
    return WolaCarry(device_zeros((num_mics, h), rdtype),
                     device_zeros(out_shape, rdtype))


def stft_ext_carry(x, engine: EngineConfig, window, cdtype, tail):
    """Streaming stft_ext: (M, C*hop) + tail (M, hop) ->
    ((T, M, NB) spectra, new_tail)."""
    from beamform_tpu.dsp.wola import frame_signal_carry
    frames, new_tail = frame_signal_carry(x, engine.hop, tail)
    frames = frames * jnp.asarray(window, dtype=x.dtype)
    spec = _analysis_bins(frames, engine, cdtype)
    return jnp.moveaxis(spec, 0, 1), new_tail


def stft_ext_carry_mt(x, engine: EngineConfig, window, cdtype, tail):
    """Like stft_ext_carry but keeps the natural (M, T, NB) layout —
    consumers that can contract over mics directly (das) skip a full-size
    transpose."""
    from beamform_tpu.dsp.wola import frame_signal_carry
    frames, new_tail = frame_signal_carry(x, engine.hop, tail)
    frames = frames * jnp.asarray(window, dtype=x.dtype)
    return _analysis_bins(frames, engine, cdtype), new_tail


def istft_ext_carry(y_ext, engine: EngineConfig, window, out_prev):
    """Streaming istft_ext: (T, NB) + out_prev (hop,) ->
    ((T*hop,) stream, new_out_prev)."""
    from beamform_tpu.dsp.wola import overlap_add_carry
    p = synth_frames_ext(y_ext, engine)
    win = jnp.asarray(window, dtype=p.dtype)
    return overlap_add_carry(p * win, engine.hop, out_prev)


def map_frame_blocks(fn, spec, w_idx, *, pairs: int = 1,
                     budget_bytes: float = 192e6):
    """Apply a stateless per-frame spectral function in frame blocks so its
    internal (T, pairs, NB) intermediates never materialize whole.

    ``fn((spec_block (F, M, NB), idx_block (F,))) -> (F, NB)``.
    """
    t, _, nb = spec.shape
    fb = max(8, int(budget_bytes / (max(pairs, 1) * nb * 4)))
    if t <= fb:
        return fn((spec, w_idx))
    tpad = -(-t // fb) * fb
    spec_p = jnp.pad(spec, ((0, tpad - t), (0, 0), (0, 0)))
    idx_p = jnp.pad(jnp.asarray(w_idx), (0, tpad - t))
    spec_b = spec_p.reshape(tpad // fb, fb, *spec.shape[1:])
    idx_b = idx_p.reshape(tpad // fb, fb)
    y = jax.lax.map(fn, (spec_b, idx_b))
    return jax.tree.map(
        lambda a: a.reshape((tpad,) + a.shape[2:])[:t], y)


def band_mask(freqs: np.ndarray, fmin: float, fmax: float) -> np.ndarray:
    """Static in-band bin mask: fmin <= |f| <= fmax over the (quirky)
    full-length frequency vector (mvdr.cpp:84,109). Bin 0 is handled
    separately by every node (y[0] = X0[0]) and is excluded here."""
    m = (np.abs(freqs) >= fmin) & (np.abs(freqs) <= fmax)
    m[0] = False
    return m


def mag_mean_over_mics(x_spec, nfft: int):
    """(..., M, NB) -> (..., NB): mean |X| over mics / nfft, the energy-gate
    statistic (mvdr.cpp:79-82: sum |X_i| / (M * fft_win)). ``nfft`` is the
    true FFT length, independent of the bin-layout width."""
    m = x_spec.shape[-2]
    return jnp.sum(jnp.abs(x_spec), axis=-2) / (m * nfft)


def frame_weights(geom: ArrayGeometry, freqs, theta_frames, rdtype,
                  row0_scale=1.0):
    """Steering weights per frame: theta (T,) -> (T, M, nfft) complex.

    vmapped over the theta timeline; replaces the reference's
    ``theta_roscallback -> update_weights`` mutation (das.cpp:94-99).
    """
    tau = steering_delays(geom, theta_frames, dtype=rdtype)  # (T, M)
    return steering_weights(jnp.asarray(freqs, dtype=rdtype), tau,
                            row0_scale=row0_scale)


def unique_thetas(theta_frames):
    """Host-side: (unique thetas (U,) rdtype-ready, per-frame index (T,))."""
    th = np.atleast_1d(np.asarray(theta_frames, dtype=np.float64))
    uniq, inv = np.unique(th, return_inverse=True)
    return uniq, np.asarray(inv, dtype=np.int32)


def weights_for_thetas(geom: ArrayGeometry, freqs, thetas, rdtype, cdtype,
                       row0_scale=1.0):
    """Traced steering weights for a (U,) theta array -> (U, M, NB).

    Meant to run INSIDE a jit: computing the weights in-graph lets XLA fuse
    them into the consumer instead of shipping a complex table per call.
    """
    tau = steering_delays(geom, jnp.asarray(thetas, dtype=rdtype),
                          dtype=rdtype)
    return steering_weights(jnp.asarray(freqs, dtype=rdtype), tau,
                            row0_scale=row0_scale).astype(cdtype)


def unique_theta_weights(geom, freqs, theta_frames, rdtype, row0_scale=1.0):
    """Memory-saving path: weights for the unique thetas only, plus an index
    per frame. Computed host-side in numpy — theta timelines are concrete
    control inputs, and one small host->device transfer beats a chain of
    un-jitted device ops."""
    from beamform_tpu.geometry import steering_delays_np, steering_weights_np
    th = np.atleast_1d(np.asarray(theta_frames, dtype=np.float64))
    uniq, inv = np.unique(th, return_inverse=True)
    tau = steering_delays_np(geom, uniq)                    # (U, M)
    w = steering_weights_np(freqs, tau, row0_scale=row0_scale)  # (U, M, N)
    np_c = np.complex128 if rdtype == jnp.float64 else np.complex64
    return w.astype(np_c), np.asarray(inv, dtype=np.int32)


def prepare_input(x, engine: EngineConfig, rdtype):
    """Pad (M, S) to a hop multiple and cast to the compute dtype."""
    x = jnp.asarray(x, dtype=rdtype)
    if x.ndim == 1:
        x = x[None, :]
    return pad_to_hop(x, engine.hop)


def theta_per_frame(theta, num_frames: int) -> np.ndarray:
    """Normalise a theta control input to a per-frame (T,) float array.

    Accepts a scalar (constant steering) or an array of per-frame angles —
    the timeline replacement for the ``/theta`` ROS topic (SURVEY.md §1 L4).
    """
    th = np.asarray(theta, dtype=np.float64)
    if th.ndim == 0:
        return np.full((num_frames,), float(th))
    if th.ndim != 1 or len(th) > num_frames or len(th) == 0:
        raise ValueError(
            f"theta timeline shape {th.shape} incompatible with "
            f"{num_frames} frames")
    if len(th) < num_frames:
        # input padding to a hop multiple can add a trailing frame; the last
        # angle holds (ROS 'latest message wins' semantics).
        th = np.concatenate([th, np.full(num_frames - len(th), th[-1])])
    return th


def make_window(engine: EngineConfig, rdtype) -> np.ndarray:
    """Host-side (numpy) window constant: model attributes are captured as
    jit constants, which lowering embeds without a device->host read."""
    np_r = np.float64 if rdtype == jnp.float64 else np.float32
    return sqrt_hann(engine.fft_win).astype(np_r)


def make_freqs(engine: EngineConfig) -> np.ndarray:
    return frequency_vector(engine.fft_win, engine.sample_rate,
                            exact=engine.exact_freqs)


def polar_mag_phase(z):
    """(|z|, atan2 phase) — the reference's mag/phase reconstruction
    (e.g. phase.cpp:115: mag*cos(pha) + i*mag*sin(pha))."""
    return jnp.abs(z), jnp.arctan2(z.imag, z.real)


def from_mag_phase(mag, pha):
    return jax.lax.complex(mag * jnp.cos(pha), mag * jnp.sin(pha))
