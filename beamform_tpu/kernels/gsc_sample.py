"""GSC per-sample adaptive stage as one persistent GPU program per stream.

The faithful GSC recurrence (gsc.cpp:120-179, ``models.gsc.gsc_sample_step``)
takes 48,000 dependent filter updates per audio-second: each output feeds
the next update through the dynamic step size. As a ``lax.scan`` every
sample is at least one device launch; here one program per stream (streams
on the grid) loops over all samples of the chunk with its state on chip:

* the (M-1) x K filter bank lives in registers for the whole loop;
* each sample's (M-1) x K blocking window is read at a moving offset from
  the blocking-matrix stream ``u = a[1:] - a[:-1]``, which XLA computes
  for the whole chunk before the kernel (consecutive windows overlap in all
  but one lane, so the reads hit the L1 cache);
* the last K outputs, which the step-size rule's output power needs, sit in
  a K-lane register ring.

Route: Pallas lowered through Triton (``backend="triton"``). Block sizes
must be powers of two, so channels are padded with zero rows and a filter
length that is not a power of two is left-padded with masked taps; padded
lanes stay exactly zero. The power sums are recomputed in full every
sample, as the reference and the scan do.

Tests run the kernel with ``interpret=True`` on the CPU; the model selects
it only when the program is lowered for CUDA (``GscModel``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from beamform_tpu.config import GscParams

#: warps per stream program: on an H100 (700 W), 1/2/4/8 warps ran the
#: 30 s, 16-mic stage at 15.3/11.7/27.8/29.8x real time single stream
NUM_WARPS = 8


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _kernel(u_ref, das_ref, filt_ref, ring_ref,
            out_ref, filt_out_ref, ring_out_ref, *, k: int, s: int,
            params: GscParams):
    cp, kp = filt_ref.shape
    lane = jax.lax.broadcasted_iota(jnp.int32, (cp, kp), 1)
    valid = lane >= kp - k                       # real taps (left padding)
    rlane = jax.lax.broadcasted_iota(jnp.int32, (kp,), 0)
    kinv = 1.0 / k
    c_b = params.mu0 * params.mu0
    c_o = params.mu_max * params.mu_max

    def step(t, carry):
        filt, ring, pos = carry                  # pos = t mod K
        win = u_ref[:, pl.ds(t + 1, kp)]         # (CP, KP) blocking window
        if kp != k:
            win = jnp.where(valid, win, 0.0)
        block_out = jnp.sum(filt * win, axis=1)  # (CP,)
        out = das_ref[t] - jnp.sum(block_out)
        ring = jnp.where(rlane == pos, out, ring)
        # dynamic mu in the squared domain, as gsc_sample_step
        osq = jnp.sum(ring * ring)
        bsq = jnp.sum(win * win, axis=1)
        cond = c_b * bsq < c_o * osq
        den = jnp.where(cond, osq, bsq) * kinv
        mu_raw = params.mu0 * jax.lax.rsqrt(den)
        mu = jnp.where(mu_raw < jnp.inf, mu_raw, 0.0)
        new = filt + mu[:, None] * out * win
        new = jnp.where(jnp.isnan(new), 0.0, new)   # gsc.cpp:158-168
        if params.use_vad:
            upd = jnp.sqrt(osq * kinv) < params.vad_threshold
            new = jnp.where(upd, new, filt)
        out_ref[t] = out
        return new, ring, jnp.where(pos + 1 == k, 0, pos + 1)

    filt, ring, _ = jax.lax.fori_loop(
        0, s, step, (filt_ref[...], ring_ref[...], jnp.int32(0)))
    filt_out_ref[...] = filt
    ring_out_ref[...] = ring


def gsc_sample_pallas(aligned, block, filt, last_out, params: GscParams, *,
                      interpret: bool = False):
    """Faithful adaptive stage for a batch of streams.

    aligned: (B, M, S) float32 phase-aligned mic streams; block/filt:
    (B, M-1, K) blocking registers and filters; last_out: (B, K) recent
    outputs, oldest first. Returns (out (B, S), block', filt', last_out').
    """
    b, m, s = aligned.shape
    c, k = filt.shape[-2:]
    cp, kp = _next_pow2(c), _next_pow2(k)
    f32 = jnp.float32
    aligned = aligned.astype(f32)
    u = aligned[:, 1:] - aligned[:, :-1]                    # (B, C, S)
    das = jnp.mean(aligned, axis=1)                         # (B, S)
    u_ext = jnp.concatenate([block.astype(f32), u], axis=-1)
    pad = ((0, 0), (0, cp - c), (kp - k, 0))
    u_pad = jnp.pad(u_ext, pad)                             # (B, CP, KP+S)
    filt_pad = jnp.pad(filt.astype(f32), pad)
    ring = jnp.pad(last_out.astype(f32), ((0, 0), (0, kp - k)))

    def per_stream(*shape):
        return pl.BlockSpec((None, *shape), lambda i: (i,) + (0,) * len(shape))

    out, filt_o, ring_o = pl.pallas_call(
        functools.partial(_kernel, k=k, s=s, params=params),
        grid=(b,),
        in_specs=[per_stream(cp, kp + s), per_stream(s), per_stream(cp, kp),
                  per_stream(kp)],
        out_specs=[per_stream(s), per_stream(cp, kp), per_stream(kp)],
        out_shape=[jax.ShapeDtypeStruct((b, s), f32),
                   jax.ShapeDtypeStruct((b, cp, kp), f32),
                   jax.ShapeDtypeStruct((b, kp), f32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="gsc_sample",
    )(u_pad, das, filt_pad, ring)
    # the ring holds output t at lane t % K: rotate it back to oldest-first
    last = jnp.roll(ring_o[:, :k], -(s % k), axis=-1)
    return out, u_ext[..., -k:], filt_o[:, :c, kp - k:], last
