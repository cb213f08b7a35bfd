"""Block-LMS GSC adaptive stage: delayed filter updates.

EXPLICITLY NON-FAITHFUL (``GscParams.solver="blocklms"``). The reference
updates the FIR bank after every sample (gsc.cpp:162-169, ``g += mu*e*u``),
which is irreducibly serial: 48,000 dependent steps per audio-second. This
route changes the update SEMANTICS instead of the schedule: the filter bank
is frozen for a block of ``block_samples`` samples, every per-sample
quantity of the reference (output, dynamic mu, VAD gate, NaN scrub) is
computed against the frozen filter, and the accumulated rank-1 updates land
at once at the block boundary -- classic block LMS with the reference's
per-sample step-size rule kept intact. Divergence from faithful output is
bounded by the up-to-(block-1)-sample filter staleness and measured as
SIR-gain parity in tests/test_gsc_blocklms.py (within 0.5 dB of the faithful
mode at 128, 1.0 dB at 256 and 512).

With the filter constant over a block, the forward pass is a plain FIR
convolution and the accumulated gradient a cross-correlation, so each block
step is a few batched products over (C, block, K) windows instead of a
serial chain of ``block`` updates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from beamform_tpu.config import GscParams

_HP = jax.lax.Precision.HIGHEST
K = 128          # filter taps (reference default, gsc.cpp:219)
L = 128          # default block length = taps (classic block-LMS choice)
VALID_BLOCKS = (128, 256, 512, 1024)   # GscParams.block_samples choices


def _block_len(params: GscParams) -> int:
    l = int(getattr(params, "block_samples", L) or L)
    if l not in VALID_BLOCKS:
        raise ValueError(
            f"block_samples={l} unsupported; choose one of {VALID_BLOCKS}")
    return l


def gsc_blocklms_scan(aligned, block, filt, last_out, params: GscParams):
    """Single-stream block-LMS: aligned (M, S) with S % block_samples == 0;
    block/filt (M-1, K); last_out (K,). Returns
    (out (S,), block', filt', last_out')."""
    m, s = aligned.shape
    c = m - 1
    k = filt.shape[-1]
    l = _block_len(params)
    if k != K or s % l:
        raise ValueError(
            f"block-LMS needs filter_size={K} and a chunk of whole blocks; "
            f"got filter_size={k}, {s} samples, block_samples={l}")
    rd = aligned.dtype
    u = aligned[1:] - aligned[:-1]                        # (C, S)
    das = jnp.mean(aligned, axis=0)                       # (S,)
    nb = s // l
    u_blocks = jnp.moveaxis(u.reshape(c, nb, l), 1, 0)    # (nb, C, l)
    das_blocks = das.reshape(nb, l)
    idx = np.arange(l)[:, None] + np.arange(K)[None, :] + 1   # (l, K)

    kinv = rd.type(1.0 / k)
    c_b = rd.type(params.mu0 * params.mu0)
    c_o = rd.type(params.mu_max * params.mu_max)
    mu0 = rd.type(params.mu0)

    def step(carry, inp):
        blk, flt_c, lo = carry
        u_t, das_t = inp
        ucat = jnp.concatenate([blk, u_t], axis=1)        # (C, K+l)
        u3 = ucat[:, idx]                                 # (C, l, K)
        fir = jnp.einsum("cjk,ck->j", u3, flt_c, precision=_HP)
        out = das_t - fir                                 # (l,)

        fo = jnp.concatenate([lo, out])
        posq = jnp.cumsum(fo * fo)
        osq = posq[K:] - posq[:l]                         # (l,)
        pbsq = jnp.cumsum(ucat * ucat, axis=1)
        bsq = pbsq[:, K:] - pbsq[:, :l]                   # (C, l)

        cond = c_b * bsq < c_o * osq[None, :]
        p_raw = mu0 * jax.lax.rsqrt(jnp.maximum(osq * kinv, 0.0))
        p = jnp.where(p_raw < jnp.inf, p_raw, 0.0)
        q_raw = mu0 * jax.lax.rsqrt(jnp.maximum(bsq * kinv, 0.0))
        q = jnp.where(q_raw < jnp.inf, q_raw, 0.0)
        mu = jnp.where(cond, p[None, :], q)               # (C, L)
        if params.use_vad:
            last_pow = jnp.sqrt(jnp.maximum(osq * kinv, 0.0))
            mu = jnp.where((last_pow < params.vad_threshold)[None, :],
                           mu, 0.0)

        w = mu * out[None, :]                             # (C, l)
        grad = jnp.einsum("cj,cjk->ck", w, u3, precision=_HP)
        fnew = flt_c + grad
        fnew = jnp.where(jnp.isnan(fnew), 0.0, fnew)
        return (u_t[:, l - K:] if l > K else u_t,
                fnew, out[l - K:] if l > K else out), out

    (blk, flt, lo), outs = jax.lax.scan(
        step, (block, filt, last_out), (u_blocks, das_blocks))
    return outs.reshape(-1), blk, flt, lo
