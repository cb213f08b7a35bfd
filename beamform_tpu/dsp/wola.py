"""Weighted overlap-add (WOLA) STFT engine.

Re-design of the reference's streaming engine (util.h:201-314): the JACK ring
buffers + double-buffered output windows become a *batched* framing/overlap
transform over a whole signal — frames become a tensor axis so the FFTs and
per-bin math run as one large batched device op instead of one window
at a time on a real-time thread.

Exact reference semantics reproduced:

* ``fft_win = 2 * hop`` with a 50% hop (util.h:261).
* *periodic* sqrt-Hann used for both analysis and synthesis
  (util.h:201-211, applied at util.h:235 and util.h:251).
* the input ring buffer is pre-filled with one hop of zeros
  (util.h:275-278), so frame ``t`` sees samples ``[(t-1)h, (t+1)h)`` and the
  pipeline has exactly one window of algorithmic latency.
* synthesis divides by ``fft_win`` — FFTW's unnormalised inverse
  (util.h:247-252); ``jnp.fft.ifft`` already applies 1/N so we take
  ``real(ifft(Y)) * win`` directly.
* output window t is ``second_half(processed[t-1]) + first_half(processed[t])``
  with ``processed[-1] = 0`` (util.h:284-286, 301-302).

So for an input of ``T`` hops the output has ``T`` hops and equals the
reference's callback outputs sample-for-sample; a pure passthrough
(the ``rosjack_ref`` path, jack_ref.cpp:19-30) reconstructs the input
delayed by one hop.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class WolaSpec:
    hop: int

    @property
    def nfft(self) -> int:
        return 2 * self.hop


def sqrt_hann(nfft: int, dtype=np.float64) -> np.ndarray:
    """Periodic sqrt-Hann window (util.h:201-211)."""
    i = np.arange(nfft, dtype=np.float64)
    return np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * i / nfft)).astype(dtype)


def frame_signal(x, hop: int):
    """Frame a signal into 50%-overlapped windows of length ``2*hop``.

    ``x``: (..., S) with S a multiple of ``hop`` (pad first if not).
    Returns (..., T, 2*hop) where T = S // hop and frame ``t`` holds samples
    ``[(t-1)*hop, (t+1)*hop)`` with one hop of leading zeros (the ring-buffer
    prefill, util.h:275-278).
    """
    x = jnp.asarray(x)
    s = x.shape[-1]
    assert s % hop == 0, f"signal length {s} not a multiple of hop {hop}"
    t = s // hop
    pad = [(0, 0)] * (x.ndim - 1) + [(hop, 0)]
    xp = jnp.pad(x, pad)
    prev = xp[..., :-hop].reshape(x.shape[:-1] + (t, hop))
    new = xp[..., hop:].reshape(x.shape[:-1] + (t, hop))
    return jnp.concatenate([prev, new], axis=-1)


def overlap_add(processed, hop: int):
    """50% overlap-add of processed windows back to a signal.

    ``processed``: (..., T, 2*hop). Output (..., T*hop):
    ``out[t] = processed[t-1][hop:] + processed[t][:hop]`` (util.h:301-302)
    with the t=0 previous window being the zero-initialised buffer
    (util.h:284-286).
    """
    processed = jnp.asarray(processed)
    first = processed[..., :, :hop]
    second = processed[..., :, hop:]
    prev_second = jnp.concatenate(
        [jnp.zeros_like(second[..., :1, :]), second[..., :-1, :]], axis=-2)
    out = first + prev_second
    return out.reshape(processed.shape[:-2] + (-1,))


def analyze(x, hop: int, window, *, cdtype=jnp.complex64):
    """Window + full complex FFT of every frame.

    The reference runs a full ``fftw_plan_dft_1d`` (complex-to-complex) of
    size ``fft_win`` on the real windowed signal (e.g. das.cpp:127). We keep
    the full-spectrum layout because the reference's frequency-vector quirk
    (see :func:`beamform_tpu.geometry.frequency_vector`) makes the steering
    weights non-Hermitian, so an rFFT would not be output-equivalent.

    ``x``: (..., S) -> spectra (..., T, nfft) complex.
    """
    frames = frame_signal(x, hop)
    win = jnp.asarray(window, dtype=frames.dtype)
    return jnp.fft.fft((frames * win).astype(cdtype), axis=-1)


def synthesize(spectra, hop: int, window):
    """Inverse FFT + synthesis window + overlap-add.

    ``spectra``: (..., T, nfft) -> signal (..., T*hop).
    Matches overlap_and_add_prepare_output (util.h:244-253): take the real
    part of the normalised inverse FFT and window again.
    """
    y = jnp.fft.ifft(spectra, axis=-1).real
    win = jnp.asarray(window, dtype=y.dtype)
    return overlap_add(y * win, hop)


def frame_signal_carry(x, hop: int, tail):
    """Streaming variant of :func:`frame_signal`: ``tail`` (..., hop) is the
    previous chunk's last hop (the ring-buffer content). Returns
    ((..., T, 2*hop) frames, new_tail)."""
    x = jnp.asarray(x)
    ext = jnp.concatenate([jnp.asarray(tail, dtype=x.dtype), x], axis=-1)
    s = x.shape[-1]
    assert s % hop == 0
    t = s // hop
    prev = ext[..., :-hop].reshape(x.shape[:-1] + (t, hop))
    new = ext[..., hop:].reshape(x.shape[:-1] + (t, hop))
    return jnp.concatenate([prev, new], axis=-1), x[..., -hop:]


def overlap_add_carry(processed, hop: int, prev_second):
    """Streaming variant of :func:`overlap_add`: ``prev_second`` (..., hop)
    is the previous chunk's final processed half-window. Returns
    ((..., T*hop) stream, new_prev_second)."""
    processed = jnp.asarray(processed)
    first = processed[..., :, :hop]
    second = processed[..., :, hop:]
    shifted = jnp.concatenate(
        [jnp.asarray(prev_second, dtype=processed.dtype)[..., None, :],
         second[..., :-1, :]], axis=-2)
    out = (first + shifted).reshape(processed.shape[:-2] + (-1,))
    return out, second[..., -1, :]


def pad_to_hop(x, hop: int):
    """Zero-pad the last axis up to the next multiple of ``hop``."""
    x = jnp.asarray(x)
    s = x.shape[-1]
    rem = (-s) % hop
    if rem == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, rem)]
    return jnp.pad(x, pad)
