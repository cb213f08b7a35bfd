"""The plain-XLA WOLA engine at the deployed hop (1024, nfft 2048).

Analysis and synthesis are framing, windowing and ``jnp.fft.rfft/irfft``
(cuFFT on a GPU) in the extended-rFFT layout with one shadow bin
(models/common.py). Checked here: perfect reconstruction, chunk carries,
the shadow-bin fold, and channel/stream batching.
"""

import numpy as np
import jax.numpy as jnp

from beamform_tpu.config import EngineConfig
from beamform_tpu.models import common

HOP = 1024


def engine(dtype="float64"):
    return EngineConfig(sample_rate=48000, window_size=HOP, dtype=dtype)


def window(eng):
    return common.make_window(eng, common.dtypes_of(eng)[0])


def test_reconstruction_hop1024():
    """analysis -> mic 0 -> synthesis returns the input delayed by one hop
    (the reference's ring-buffer latency, util.h:275-287)."""
    eng = engine()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 12 * HOP))
    spec = common.stft_ext(jnp.asarray(x), eng, window(eng), jnp.complex128)
    out = np.asarray(common.istft_ext(spec[:, 0, :], eng, window(eng)))
    np.testing.assert_allclose(out[HOP:], x[0, :-HOP], atol=1e-12)


def test_carry_continuity_hop1024():
    """Chunked analysis + synthesis with carries == one call, float32."""
    eng = engine("float32")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 10 * HOP)).astype(np.float32)
    win = window(eng)
    carry = common.wola_carry_init(eng, 3, jnp.float32)
    full_spec, _ = common.stft_ext_carry(jnp.asarray(x), eng, win,
                                         jnp.complex64, carry.tail)
    full, _ = common.istft_ext_carry(full_spec[:, 1, :], eng, win,
                                     carry.out_prev)
    tail, prev, outs = carry.tail, carry.out_prev, []
    for i in range(0, x.shape[1], 3 * HOP):
        spec, tail = common.stft_ext_carry(jnp.asarray(x[:, i:i + 3 * HOP]),
                                           eng, win, jnp.complex64, tail)
        y, prev = common.istft_ext_carry(spec[:, 1, :], eng, win, prev)
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(outs), np.asarray(full),
                               atol=1e-5)


def test_shadow_bin_fold():
    """The extended layout's shadow bin is conj(X[N/2-1]) of a real frame,
    and folding it back reproduces real(ifft) of the full spectrum."""
    eng = engine()
    n, h = eng.fft_win, eng.fft_win // 2
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((4, n))
    ext = np.array(common._analysis_bins(jnp.asarray(frames), eng,
                                           jnp.complex128))
    assert ext.shape == (4, common.ext_bins(n))
    np.testing.assert_allclose(ext[:, h + 1], np.conj(ext[:, h - 1]),
                               atol=1e-9)
    # a non-Hermitian edit of the bin pair (the reference's steering quirk)
    # folds to the mean of the pair, as real(ifft(.)) of the full spectrum
    full = np.fft.fft(frames)
    full[:, h - 1] *= 1.5
    full[:, h + 1] *= 0.5
    ext[:, h - 1] *= 1.5
    ext[:, h + 1] *= 0.5
    got = np.asarray(common.synth_frames_ext(jnp.asarray(ext), eng))
    np.testing.assert_allclose(got, np.fft.ifft(full).real, atol=1e-12)


def test_wide_channel_analysis_matches_per_channel():
    """40 channels (a batch of B x M flattened, as GSC's batched stage
    runs it) analyse exactly like one channel at a time."""
    eng = engine("float32")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 6 * HOP)).astype(np.float32)
    tail = rng.standard_normal((40, HOP)).astype(np.float32)
    win = window(eng)
    spec, new_tail = common.stft_ext_carry(jnp.asarray(x), eng, win,
                                           jnp.complex64, jnp.asarray(tail))
    for c in (0, 17, 39):
        one, _ = common.stft_ext_carry(jnp.asarray(x[c:c + 1]), eng, win,
                                       jnp.complex64, jnp.asarray(tail[c:c + 1]))
        np.testing.assert_allclose(np.asarray(spec[:, c]),
                                   np.asarray(one[:, 0]), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(new_tail), x[:, -HOP:])


def test_batched_synthesis_matches_per_stream():
    """(B, T, NB) synthesis with per-stream OLA carries == per stream."""
    eng = engine("float32")
    rng = np.random.default_rng(4)
    nb = common.ext_bins(eng.fft_win)
    y = (rng.standard_normal((5, 7, nb))
         + 1j * rng.standard_normal((5, 7, nb))).astype(np.complex64)
    prev = rng.standard_normal((5, HOP)).astype(np.float32)
    win = window(eng)
    outb, prevb = common.istft_ext_carry(jnp.asarray(y), eng, win,
                                         jnp.asarray(prev))
    for i in range(5):
        oi, pi = common.istft_ext_carry(jnp.asarray(y[i]), eng, win,
                                        jnp.asarray(prev[i]))
        np.testing.assert_allclose(np.asarray(outb[i]), np.asarray(oi),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(prevb[i]), np.asarray(pi),
                                   atol=1e-6)
