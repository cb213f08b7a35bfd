"""Generalized sidelobe canceller with dynamic adaptation rate.

Reference: gsc.cpp — two stages:

1. per-mic phase alignment in the frequency domain via the by-mic WOLA path
   (gsc.cpp:54-75, do_overlap_bymic at util.h:353-379): each mic's spectrum
   is multiplied by conj(w_mic) and resynthesised separately;
2. a per-*sample* time-domain adaptive stage (gsc.cpp:120-179): fixed beam =
   mic average, blocking matrix = adjacent-mic differences (M-1 channels),
   FIR filter bank (filter_size taps) with LMS-style updates
   g += mu * e * u, dynamic mu:
       mu = mu0/last_out_power  if mu0*block_power/last_out_power < mu_max
            mu0/block_power     otherwise
   with NaN/Inf scrubbing (gsc.cpp:158-168) and an optional VAD gate on the
   output power (gsc.cpp:146).

Design: stage 1 is fully batched (one product + batched iFFTs). Stage 2 is
irreducibly sample-serial (each output feeds the next update). Its float32
route on an NVIDIA GPU is one persistent kernel per stream
(kernels/gsc_sample.py); everywhere else, and for float64 and the mu trace,
it is a ``lax.scan`` over samples with the (M-1, K) filter bank vectorized
per step. ``solver="blocklms"`` selects the non-faithful block-LMS stage
(kernels/gsc_blocklms.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from beamform_tpu.config import EngineConfig, GscParams
from beamform_tpu.geometry import ArrayGeometry
from beamform_tpu.models import common
from beamform_tpu.models.batching import BatchableModel
from beamform_tpu.dsp.wola import overlap_add_carry


class GscState(NamedTuple):
    block: jnp.ndarray      # (M-1, K) blocking-matrix shift registers
    filt: jnp.ndarray       # (M-1, K) adaptive filters
    last_out: jnp.ndarray   # (K,) recent outputs, oldest first


def gsc_init_state(num_mics: int, filter_size: int, rdtype) -> GscState:
    return GscState(
        jnp.zeros((num_mics - 1, filter_size), dtype=rdtype),
        jnp.zeros((num_mics - 1, filter_size), dtype=rdtype),
        jnp.zeros((filter_size,), dtype=rdtype),
    )


def gsc_sample_step(state: GscState, a_t, p: GscParams,
                    with_mu: bool = False):
    """One sample of the adaptive stage. ``a_t``: (M,) aligned samples.
    With ``with_mu``, also emits (mu for the first blocking channel,
    update-ran flag) — the reference's mu trace (gsc.cpp:171-174)."""
    k = state.block.shape[-1]
    kinv = 1.0 / k
    das = jnp.mean(a_t)
    u_new = a_t[1:] - a_t[:-1]                          # blocking matrix
    block = jnp.concatenate([state.block[:, 1:], u_new[:, None]], axis=1)
    block_out = jnp.sum(state.filt * block, axis=1)     # (M-1,)
    out = das - jnp.sum(block_out)

    last_out = jnp.concatenate([state.last_out[1:], out[None]])
    # dynamic mu in the squared domain (gsc.cpp:146-157): the gate
    # mu0*block_pow/last_pow < mu_max is evaluated as
    # mu0^2*bsq < mu_max^2*osq (identical for non-negative power sums) and
    # mu = mu0*rsqrt(mean square) — one rsqrt instead of 2 sqrt + 3 div,
    # shared with kernels/gsc_sample.py so both agree to round-off
    osq = jnp.sum(last_out ** 2)
    bsq = jnp.sum(block ** 2, axis=1)                   # (M-1,)
    cond = (p.mu0 * p.mu0) * bsq < (p.mu_max * p.mu_max) * osq
    den = jnp.where(cond, osq, bsq) * kinv
    mu_raw = p.mu0 * jax.lax.rsqrt(den)
    mu = jnp.where(mu_raw < jnp.inf, mu_raw, 0.0)

    filt_new = state.filt + mu[:, None] * out * block
    filt_new = jnp.where(jnp.isnan(filt_new), 0.0, filt_new)
    upd = jnp.bool_(True)
    if p.use_vad:
        last_pow = jnp.sqrt(osq * kinv)
        upd = last_pow < p.vad_threshold
        filt_new = jnp.where(upd, filt_new, state.filt)
    st = GscState(block, filt_new, last_out)
    if with_mu:
        return st, (out, mu[0], upd)
    return st, out


def gsc_sample_scan(aligned, gstate: GscState, p: GscParams):
    """The faithful adaptive stage as a ``lax.scan`` over samples, vmapped
    over streams: aligned (B, M, S), state leaves with a leading B ->
    (out (B, S), new state). The reference route for
    kernels/gsc_sample.py and the route off the GPU."""
    def one(a_stream, gst):
        new, out = jax.lax.scan(
            lambda s_, a_t: gsc_sample_step(s_, a_t, p), gst,
            jnp.moveaxis(a_stream, 0, 1))
        return out, new
    return jax.vmap(one)(aligned, gstate)


class GscModel(BatchableModel):
    name = "gsc"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: GscParams = GscParams(), interference_angles=()):
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        self.np_r = np.float64 if engine.dtype == "float64" else np.float32
        self.freqs = common.make_freqs_ext(engine)
        self.window = common.make_window(engine, self.rdtype)
        self._jit = jax.jit(self._forward)

    def stream_init(self):
        return (common.wola_carry_init(self.engine, self.geom.num_mics,
                                       self.rdtype, per_mic_out=True),
                gsc_init_state(self.geom.num_mics, self.params.filter_size,
                               self.rdtype))

    def aligned_streams(self, x, thetas, w_idx, carry: common.WolaCarry):
        """Stage 1: per-mic phase-aligned, WOLA-resynthesised streams
        (the do_overlap_bymic path). x (M, C*hop) -> ((C*hop, M), carry)."""
        x_spec, tail = common.stft_ext_carry(x, self.engine, self.window,
                                             self.cdtype, carry.tail)
        w_uniq = common.weights_for_thetas(self.geom, self.freqs, thetas,
                                           self.rdtype, self.cdtype)
        w = w_uniq[w_idx]                       # (T, M, NB)
        aligned_spec = x_spec * jnp.conj(w)     # gsc.cpp:62-65
        y = common.synth_frames_ext(aligned_spec, self.engine)  # (T, M, N)
        y = y * self.window
        y = jnp.moveaxis(y, 1, 0)               # (M, T, N)
        streams, prev = overlap_add_carry(y, self.engine.hop, carry.out_prev)
        return streams, common.WolaCarry(tail, prev)   # (M, S)

    def _adaptive(self, aligned, gstate):
        """Stage 2 for B streams: aligned (B, M, S), state leaves with a
        leading B -> (out (B, S), new state)."""
        p = self.params
        if p.solver == "blocklms":
            from beamform_tpu.kernels.gsc_blocklms import gsc_blocklms_scan

            def one_blk(a_stream, gst):
                out, *new = gsc_blocklms_scan(a_stream, gst.block, gst.filt,
                                              gst.last_out, p)
                return out, GscState(*new)
            return jax.vmap(one_blk)(aligned, gstate)

        def scan_route(a, st):
            return gsc_sample_scan(a, st, p)

        if self.rdtype != jnp.float32:
            return scan_route(aligned, gstate)

        def kernel_route(a, st):
            from beamform_tpu.kernels.gsc_sample import gsc_sample_pallas
            out, *new = gsc_sample_pallas(a, st.block, st.filt, st.last_out,
                                          p)
            return out, GscState(*new)
        return jax.lax.platform_dependent(aligned, gstate, cuda=kernel_route,
                                          default=scan_route)

    def _forward(self, x, thetas, w_idx, state):
        carry, gstate = state
        aligned, carry = self.aligned_streams(x, thetas, w_idx, carry)

        # the mu trace needs the per-sample scan (write_mu, gsc.cpp:181-184)
        if self.params.write_mu:
            gstate, (out, mu0, upd) = jax.lax.scan(
                lambda st, a_t: gsc_sample_step(st, a_t, self.params,
                                                with_mu=True),
                gstate, jnp.moveaxis(aligned, 0, 1))
            return out, (carry, gstate), (mu0, upd)
        out, gb = self._adaptive(aligned[None],
                                 jax.tree.map(lambda a: a[None], gstate))
        return out[0], (carry, jax.tree.map(lambda a: a[0], gb))

    def batched_forward(self, x, ctrl, state):
        """Natively batched override of the BatchableModel default: the
        streams ride the adaptive kernel's grid instead of a vmap.
        Constant per-stream steering (detected host-side) collapses the
        per-frame weight gather to a broadcast."""
        uniq, idx = ctrl
        idx_np = np.asarray(idx)
        if idx_np.ndim == 2 and (idx_np == idx_np[:, :1]).all():
            idx = idx_np[:, 0]
            key = "_batched_fn_const"
        else:
            key = "_batched_fn"
        fn = self.__dict__.get(key)
        if fn is None:
            fn = jax.jit(self._forward_batched)
            self.__dict__[key] = fn
        return fn(x, uniq, idx, state)

    def _aligned_streams_batched(self, x, thetas, w_idx, carry):
        """Stage 1 for B streams: the (B, M) channels flatten into one
        channel axis through the WOLA analysis, then steer per
        (stream, frame) and resynthesize per channel."""
        b, m, s_len = x.shape
        hop = self.engine.hop
        t = s_len // hop
        xf = x.reshape(b * m, s_len)
        tailf = carry.tail.reshape(b * m, hop)
        x_spec, tailf2 = common.stft_ext_carry(
            xf, self.engine, self.window, self.cdtype, tailf)  # (T, BM, NB)
        new_tail = tailf2.reshape(b, m, hop)
        spec = jnp.moveaxis(x_spec.reshape(t, b, m, -1), 1, 0)  # (B,T,M,NB)
        w_uniq = common.weights_for_thetas(self.geom, self.freqs, thetas,
                                           self.rdtype, self.cdtype)
        # (B,) index = constant steering per stream: broadcast in-fusion
        w = w_uniq[w_idx][:, None] if w_idx.ndim == 1 else w_uniq[w_idx]
        aligned_spec = spec * jnp.conj(w)          # gsc.cpp:62-65
        y = common.synth_frames_ext(aligned_spec, self.engine)  # (B,T,M,N)
        y = y * self.window
        y = jnp.moveaxis(y, 2, 1)                  # (B, M, T, N)
        streams, prev = overlap_add_carry(y, hop, carry.out_prev)
        return streams, common.WolaCarry(new_tail, prev)   # (B, M, S)

    def _forward_batched(self, x, thetas, idx, state):
        """Multi-stream forward: x (B, M, S), idx (B,) or (B, T), state
        leaves with leading B."""
        carry, gstate = state
        aligned, carry = self._aligned_streams_batched(x, thetas, idx,
                                                       carry)
        out, gstate = self._adaptive(aligned, gstate)
        return out, (carry, gstate)

    def process_chunk(self, x_chunk, theta, state):
        x = jnp.asarray(x_chunk, dtype=self.rdtype)
        t = x.shape[-1] // self.engine.hop
        uniq, w_idx = self._theta_ctrl(theta, t)
        res = self._jit(x, uniq, w_idx, state)
        if self.params.write_mu:
            out, state, (mu0, upd) = res
            self._write_mu_trace(np.asarray(mu0), np.asarray(upd))
            return out, state
        return res

    def _write_mu_trace(self, mu0, upd):
        """Per-callback mean-mu log (gsc.cpp:146-184): accumulate mu of the
        first blocking channel over each hop's updated samples; a VAD-gated
        sample overwrites the running sum with the previous callback's value.
        Appends one line per hop to ``self.mu_file_path``
        (~/mu_behavior.txt in the reference)."""
        import os
        hop = self.engine.hop
        path = getattr(self, "mu_file_path", None) or os.path.expanduser(
            "~/mu_behavior.txt")
        last_avg = getattr(self, "_last_avg_mu", 0.0)
        lines = []
        for f in range(len(mu0) // hop):
            avg = 0.0
            for j in range(hop):
                if upd[f * hop + j]:
                    avg += float(mu0[f * hop + j])
                else:
                    avg = last_avg
            lines.append(f"{avg / hop:f}\n")
            last_avg = avg
        self._last_avg_mu = last_avg
        mode = "a" if getattr(self, "_mu_file_started", False) else "w"
        with open(path, mode) as fh:
            fh.writelines(lines)
        self._mu_file_started = True

    def process(self, x, theta=0.0):
        x = common.prepare_input(x, self.engine, self.rdtype)
        out, _ = self.process_chunk(x, theta, self.stream_init())
        return out
