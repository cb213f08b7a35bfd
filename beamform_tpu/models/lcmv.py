"""LCMV beamformer with dynamic interference constraints.

Reference: lcmv.cpp — per-bin constraint matrix C(f) = [d_doi, d_int1..K]
(lcmv.cpp:44-86), the MVDR covariance machinery (lcmv.cpp:112-113),
w = R^-1 C (C^H R^-1 C)^-1 with output column 0 (lcmv.cpp:116-119), the same
band/energy gates and out_amp as MVDR.

The reference mutates the interference set via the ``/theta_interference``
topic with proximity add/move/remove and a READY=false + 30 ms quiesce for
reallocation (lcmv.cpp:221-309). Here the interference set is a
fixed-capacity masked constraint timeline (see
beamform_tpu.runtime.timeline): constant-shape state, no reallocation, no
locks. Faithful detail: after the reference's first reallocation,
``update_weights(ini=false)`` leaves the mic0 constraint row zero
(allocate_interf_buffers zero-fills; row 0 only written when ini=true) —
exposed as ``row0_scale`` in the constraint builder.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from beamform_tpu.config import EngineConfig, LcmvParams
from beamform_tpu.geometry import (
    ArrayGeometry,
    steering_delays,
    steering_matrix,
)
from beamform_tpu.models import common
from beamform_tpu.models.batching import BatchableConstrainedModel
from beamform_tpu.models.mvdr import batched_inv, white_r


def lcmv_solve(r, c, inactive_diag=None):
    """w = R^-1 C (C^H R^-1 C)^-1, output column 0 (lcmv.cpp:116-119).
    r (..., M, M); c (..., M, S) -> (..., M).

    ``inactive_diag`` (S,): 1.0 for masked-out constraint slots. Their
    columns of C are zero, so the inner matrix has zero rows/cols; adding an
    identity on those slots makes it block-diagonal and the active block's
    inverse (hence column 0 of w) is exactly the smaller problem's solution
    — the fixed-capacity replacement for the reference's reallocation.
    """
    # HIGHEST: reduced-precision passes (bf16, TF32) turn the
    # ill-conditioned solve chain into ~1e-1 output deviations
    hp = jax.lax.Precision.HIGHEST
    inv = batched_inv(r, polish=False)
    ric0 = jnp.einsum("...mk,...ks->...ms", inv, c, precision=hp)
    # refinement on the S-column RHS == Newton polish of R^-1, at M^2 S
    resid = c - jnp.einsum("...mk,...ks->...ms", r, ric0, precision=hp)
    ric = ric0 + jnp.einsum("...mk,...ks->...ms", inv, resid, precision=hp)
    inner = jnp.einsum("...ms,...mk->...sk", jnp.conj(c), ric, precision=hp)
    if inactive_diag is not None:
        s = inner.shape[-1]
        eye = jnp.eye(s, dtype=inner.dtype)
        inner = inner + inactive_diag.astype(inner.dtype)[..., :, None] * eye
    w_all = jnp.einsum("...ms,...sk->...mk", ric, batched_inv(inner),
                       precision=hp)
    return w_all[..., 0]


def build_constraints(geom: ArrayGeometry, freqs, theta, interf_angles,
                      rdtype, *, row0_scale=1.0, active_mask=None):
    """C (K_bins, M, S) for one theta and a static interference set."""
    doi = steering_delays(geom, jnp.asarray(theta, dtype=rdtype),
                          dtype=rdtype)
    if len(interf_angles):
        taui = steering_delays(
            geom, jnp.asarray(np.asarray(interf_angles), dtype=rdtype),
            dtype=rdtype)
    else:
        taui = jnp.zeros((0, geom.num_mics), dtype=rdtype)
    return steering_matrix(jnp.asarray(freqs, dtype=rdtype), doi, taui,
                           row0_scale=row0_scale, active_mask=active_mask)


def build_constraints_masked(geom: ArrayGeometry, freqs, theta,
                             interf_angles, active, row0, rdtype, cdtype,
                             ib):
    """Traced masked constraint matrix for one control state.

    theta scalar; interf_angles (K,); active (K,) 0/1; row0 scalar. Returns
    (Nib, M, K+1) with inactive columns zeroed and the mic0 row scaled by
    ``row0`` (the post-realloc quirk, lcmv.cpp:243-252 + update_weights).
    """
    from beamform_tpu.geometry import steering_delays, steering_weights
    angles = jnp.concatenate([jnp.asarray(theta, dtype=rdtype)[None],
                              jnp.asarray(interf_angles, dtype=rdtype)])
    tau = steering_delays(geom, angles, dtype=rdtype)          # (K+1, M)
    w = steering_weights(jnp.asarray(freqs, dtype=rdtype), tau,
                         row0_scale=row0)                      # (K+1, M, NB)
    c = jnp.transpose(w, (2, 1, 0)).astype(cdtype)             # (NB, M, K+1)
    col_mask = jnp.concatenate(
        [jnp.ones((1,), dtype=rdtype), jnp.asarray(active, dtype=rdtype)])
    c = c * col_mask[None, None, :].astype(cdtype)
    return c[ib]


def build_constraints_np(geom: ArrayGeometry, freqs, theta, interf_angles,
                         *, row0_scale=1.0,
                         active_mask=None) -> np.ndarray:
    """Host-side constraint matrix C (K_bins, M, S): column 0 is the DOI,
    columns 1..K the interferences (lcmv.cpp:44-86)."""
    from beamform_tpu.geometry import steering_delays_np, steering_weights_np
    angles = np.concatenate([[float(theta)],
                             np.asarray(interf_angles, dtype=np.float64)])
    tau = steering_delays_np(geom, angles)                 # (S, M)
    w = steering_weights_np(freqs, tau, row0_scale=row0_scale)  # (S, M, K)
    c = np.transpose(w, (2, 1, 0))                          # (K_bins, M, S)
    if active_mask is not None:
        c = c * np.asarray(active_mask)[None, None, :]
    return c


class LcmvModel(BatchableConstrainedModel):
    name = "lcmv"
    batch_axes = (None, None, None, None, 0)   # control rows shared, idx/stream

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: LcmvParams = LcmvParams(), interference_angles=()):
        self.engine, self.geom, self.params = engine, geom, params
        self.interf = tuple(interference_angles)
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        import numpy as _np
        self.np_r = _np.float64 if engine.dtype == "float64" else _np.float32
        self.freqs = common.make_freqs_ext(engine)
        self.window = common.make_window(engine, self.rdtype)
        mask = common.band_mask(self.freqs, params.freq_min, params.freq_max)
        self.ib = np.nonzero(mask)[0].astype(np.int32)
        self._jit = jax.jit(self._forward)

    def _constraints_traced(self, u_theta, u_angles, u_active, u_row0):
        """C for each unique control row: (U, Nib, M, K+1), masked."""
        def one(th, ang, act, r0):
            return build_constraints_masked(
                self.geom, self.freqs, th, ang, act, r0,
                self.rdtype, self.cdtype, jnp.asarray(self.ib))
        return jax.vmap(one)(u_theta, u_angles, u_active, u_row0)

    def stream_init(self):
        return (common.wola_carry_init(self.engine, self.geom.num_mics,
                                       self.rdtype),
                common.device_zeros((self.params.past_windows,
                                     self.geom.num_mics, len(self.ib)),
                                    self.cdtype))

    def _forward(self, x, u_theta, u_angles, u_active, u_row0, idx, state):
        p = self.params
        carry, hist0 = state
        c_uniq = self._constraints_traced(u_theta, u_angles, u_active,
                                          u_row0)
        # masked-identity fix for inactive constraint slots (per unique row)
        ones1 = jnp.ones((u_active.shape[0], 1), dtype=self.rdtype)
        inact = 1.0 - jnp.concatenate(
            [ones1, jnp.asarray(u_active, dtype=self.rdtype)], axis=1)
        m = self.geom.num_mics
        w_hist = p.past_windows
        x_spec, tail = common.stft_ext_carry(x, self.engine, self.window,
                                             self.cdtype, carry.tail)
        mag = common.mag_mean_over_mics(x_spec, self.engine.fft_win)
        ib = jnp.asarray(self.ib)
        x_ib = x_spec[:, :, ib]
        mag_ib = mag[:, ib]
        wr = white_r(m, self.rdtype).astype(self.cdtype)

        # block-chunked sliding covariances (see MvdrModel._block_frames)
        from beamform_tpu.models.mvdr import MvdrModel
        t = x_ib.shape[0]
        cb = MvdrModel._block_frames(self, t)
        tpad = -(-t // cb) * cb
        x_blk = jnp.pad(x_ib, ((0, tpad - t), (0, 0), (0, 0)))
        mag_blk = jnp.pad(mag_ib, ((0, tpad - t), (0, 0)))
        u_blk = jnp.pad(idx, (0, tpad - t))
        x_blk = x_blk.reshape(tpad // cb, cb, m, -1)
        mag_blk = mag_blk.reshape(tpad // cb, cb, -1)
        u_blk = u_blk.reshape(tpad // cb, cb)

        # banded selector product; see MvdrModel._forward
        band = (jnp.tri(cb, cb + w_hist, w_hist - 1, dtype=self.rdtype)
                - jnp.tri(cb, cb + w_hist, -1, dtype=self.rdtype))
        hp = jax.lax.Precision.HIGHEST

        def block_step(hist, inp):
            xb, magb, ub = inp
            ext = jnp.concatenate([hist, xb], axis=0)
            o = jnp.einsum("tmn,tkn->tnmk", ext, jnp.conj(ext), precision=hp)
            g = jnp.einsum("ct,tnmk->cnmk", band.astype(o.dtype), o,
                           precision=hp)
            r = g * wr[None, None, :, :]
            c = c_uniq[ub]                                  # (CB, Nib, M, S)
            w0 = lcmv_solve(r, c, inact[ub][:, None, :])    # (CB, Nib, M)
            y_bf = jnp.einsum("tnm,tmn->tn", jnp.conj(w0), xb, precision=hp)
            y_t = jnp.where(magb > p.freq_mag_threshold, y_bf,
                            xb[:, 0, :] * 0.01)
            return ext[cb:], y_t

        hist, y_blk = jax.lax.scan(block_step, hist0,
                                   (x_blk, mag_blk, u_blk))
        y_ib = y_blk.reshape(tpad, -1)[:t]
        hist = jnp.concatenate([hist0, x_ib], axis=0)[t:t + w_hist]

        y = jnp.zeros((x_spec.shape[0], x_spec.shape[2]), dtype=self.cdtype)
        y = y.at[:, ib].set(y_ib)
        y = y.at[:, 0].set(x_spec[:, 0, 0])
        out, prev = common.istft_ext_carry(y, self.engine, self.window,
                                           carry.out_prev)
        return out * p.out_amp, (common.WolaCarry(tail, prev), hist)

    def _control_arrays(self, theta, t, interference):
        from beamform_tpu.runtime.timeline import (
            InterferenceTimeline, static_interference, unique_control_rows)
        th = common.theta_per_frame(theta, t)
        tl = interference
        if tl is None:
            tl = static_interference(t, self.interf)
        assert tl.angles.shape[0] >= t
        tl_t = InterferenceTimeline(tl.angles[:t], tl.active[:t],
                                    tl.row0[:t], tl.reset[:t])
        u_th, u_ang, u_act, u_r0, idx = unique_control_rows(th, tl_t)
        return (u_th.astype(self.np_r), u_ang.astype(self.np_r),
                u_act.astype(self.np_r), u_r0.astype(self.np_r), idx)

    def process_chunk(self, x_chunk, theta, state, interference=None):
        """``interference``: optional InterferenceTimeline rows for this
        chunk — the /theta_interference replacement (lcmv.cpp:258-309)."""
        x = jnp.asarray(x_chunk, dtype=self.rdtype)
        t = x.shape[-1] // self.engine.hop
        import numpy as _np
        tlkey = (None if interference is None else
                 (interference.angles.tobytes(),
                  interference.active.tobytes(),
                  interference.row0.tobytes(),
                  interference.reset.tobytes()))
        key = ("ctrl", _np.asarray(theta, _np.float64).tobytes(), t, tlkey)
        ctrl = self._cached(
            key, lambda: tuple(
                jax.device_put(a)
                for a in self._control_arrays(theta, t, interference)))
        return self._jit(x, *ctrl, state)

    def process(self, x, theta=0.0, interference=None):
        x = common.prepare_input(x, self.engine, self.rdtype)
        out, _ = self.process_chunk(x, theta, self.stream_init(),
                                    interference)
        return out
