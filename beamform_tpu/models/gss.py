"""Online Geometric Source Separation (Valin 2007, ODAS-style).

Reference: gss.cpp — steering matrix A(f) built like LCMV's constraints
(gss.cpp:51-94), demixing matrix W(f) initialised to A(f)^H (gss.cpp:92-93);
per gated bin: y = W x, output source 0 (gss.cpp:120-121); natural-gradient
update (gss.cpp:124-136):

    E   = y y^H with zeroed diagonal
    a   = ||x||^4
    dJ1 = 4 S (1/a) (E y) x^H
    dJ2 = 2 (1/S) ((W A) - I) A^H
    W  <- (1 - lambda mu) W - mu (dJ1 + dJ2)

Band gate zeroes the bin; energy-gate failure passes 0.01*X0 through and
skips the update. ``out_amp`` gain on the output stream.

Design: the per-bin demixing matrices over the static in-band subset are
the carry of a ``lax.scan`` over frames — (N_ib, S, M) — updated with masked
batched products (pinned to full precision); no per-bin loop, no
reallocation for interference changes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from beamform_tpu.config import EngineConfig, GssParams
from beamform_tpu.geometry import ArrayGeometry
from beamform_tpu.models import common
from beamform_tpu.models.batching import BatchableConstrainedModel


def gss_update(w_sep, a_mat, a_h, x, gate, mu, lam, active_ext=None):
    """One GSS step over all carried bins.

    w_sep (Nib, S, M); a_mat (Nib, M, S); a_h (Nib, S, M); x (M, Nib);
    gate (Nib,) bool. ``active_ext`` (S,) 0/1 masks source slots for the
    fixed-capacity dynamic-interference design: inactive slots have zero
    steering columns and zero demixing rows, the identity in dJ2 becomes
    diag(active_ext), and the source count S in the gradient constants is
    the ACTIVE count (gss.cpp:132-133 uses interference_angles.size()+1).
    Returns (new_w, y_first_source (Nib,)).
    """
    s_cap = w_sep.shape[-2]
    if active_ext is None:
        eye_s = jnp.eye(s_cap, dtype=w_sep.dtype)
        s_act = jnp.asarray(float(s_cap), dtype=x.real.dtype)
    else:
        eye_s = jnp.diag(active_ext).astype(w_sep.dtype)
        s_act = jnp.sum(active_ext).astype(x.real.dtype)
    hp = jax.lax.Precision.HIGHEST
    xt = jnp.moveaxis(x, 0, -1)                          # (Nib, M)
    yf = jnp.einsum("nsm,nm->ns", w_sep, xt, precision=hp)   # (Nib, S)
    e = jnp.einsum("ns,nk->nsk", yf, jnp.conj(yf), precision=hp)
    e = e * (1.0 - jnp.eye(s_cap, dtype=w_sep.dtype))    # zero diagonal
    alpha = jnp.sum(jnp.abs(xt) ** 2, axis=-1) ** 2      # (Nib,)
    ey = jnp.einsum("nsk,nk->ns", e, yf, precision=hp)
    dj1 = (4.0 * s_act) * jnp.einsum("ns,nm->nsm", ey, jnp.conj(xt),
                                     precision=hp)
    dj1 = dj1 / alpha[:, None, None].astype(w_sep.dtype)
    wa = jnp.einsum("nsm,nmk->nsk", w_sep, a_mat, precision=hp)
    dj2 = (2.0 / s_act) * jnp.einsum("nsk,nkm->nsm", wa - eye_s, a_h,
                                     precision=hp)
    w_new = (1.0 - lam * mu) * w_sep - mu * (dj1 + dj2)
    w_sep = jnp.where(gate[:, None, None], w_new, w_sep)
    return w_sep, yf[:, 0]


class GssModel(BatchableConstrainedModel):
    name = "gss"

    batch_axes = (None, None, None, None, 0, None)

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: GssParams = GssParams(), interference_angles=(),
                 capacity: int | None = None):
        """``capacity``: interference-slot capacity of the demixing state —
        the fixed-shape replacement for the reference's buffer reallocation
        (gss.cpp:241-286). Defaults to len(interference_angles); sessions
        replaying event timelines that ADD interferences must be built with
        the timeline's capacity."""
        self.engine, self.geom, self.params = engine, geom, params
        self.interf = tuple(interference_angles)
        self.capacity = (len(self.interf) if capacity is None
                         else int(capacity))
        assert self.capacity >= len(self.interf), (capacity, self.interf)
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        import numpy as _np
        self.np_r = _np.float64 if engine.dtype == "float64" else _np.float32
        self.freqs = common.make_freqs_ext(engine)
        self.window = common.make_window(engine, self.rdtype)
        # NB: unlike MVDR/LCMV, gss.cpp's bin loop starts at j=0 — no DC
        # special case (gss.cpp:110), so bin 0 obeys the band gate too.
        mask = ((np.abs(self.freqs) >= params.freq_min)
                & (np.abs(self.freqs) <= params.freq_max))
        self.ib = np.nonzero(mask)[0].astype(np.int32)
        self._jit = jax.jit(self._forward)

    def _steering_traced(self, u_theta, u_angles, u_active, u_row0):
        """A for each unique control row: (U, Nib, M, K+1), masked."""
        from beamform_tpu.models.lcmv import build_constraints_masked

        def one(th, ang, act, r0):
            return build_constraints_masked(
                self.geom, self.freqs, th, ang, act, r0,
                self.rdtype, self.cdtype, jnp.asarray(self.ib))
        return jax.vmap(one)(u_theta, u_angles, u_active, u_row0)

    def stream_init(self, capacity: int | None = None):
        """Zero demixing state + prev_control = NaN: the first frame always
        'resets' W to A^H (the reference's startup init, gss.cpp:92-93)."""
        s = (self.capacity if capacity is None else int(capacity)) + 1
        return (common.wola_carry_init(self.engine, self.geom.num_mics,
                                       self.rdtype),
                common.device_zeros((len(self.ib), s, self.geom.num_mics),
                                    self.cdtype),
                jnp.asarray(jnp.nan, dtype=self.rdtype))

    def _forward(self, x, u_theta, u_angles, u_active, u_row0, idx,
                 reset_extra, state):
        p = self.params
        carry, w0, prev_theta = state
        a_uniq = self._steering_traced(u_theta, u_angles, u_active, u_row0)
        ones1 = jnp.ones((u_active.shape[0], 1), dtype=self.rdtype)
        act_ext = jnp.concatenate(
            [ones1, jnp.asarray(u_active, dtype=self.rdtype)], axis=1)
        x_spec, tail = common.stft_ext_carry(x, self.engine, self.window,
                                             self.cdtype, carry.tail)
        mag = common.mag_mean_over_mics(x_spec, self.engine.fft_win)
        ib = jnp.asarray(self.ib)
        x_ib = x_spec[:, :, ib]
        mag_ib = mag[:, ib]
        a_h_uniq = jnp.conj(jnp.swapaxes(a_uniq, -1, -2))  # (U, Nib, S, M)

        # any theta change or interference event resets W to A^H
        # (update_weights, gss.cpp:90-93); carried across chunks.
        th_val = jnp.asarray(u_theta, dtype=self.rdtype)[idx]
        th_prev = jnp.concatenate([prev_theta[None], th_val[:-1]])
        reset = (th_val != th_prev) | reset_extra

        def step(w_sep, inp):
            x_t, mag_t, u_t, reset_t = inp
            w_sep = jnp.where(reset_t, a_h_uniq[u_t], w_sep)
            gate = mag_t > p.freq_mag_threshold
            w_new, y_sep = gss_update(w_sep, a_uniq[u_t], a_h_uniq[u_t],
                                      x_t, gate, p.mu, p.lam, act_ext[u_t])
            y_t = jnp.where(gate, y_sep, x_t[0, :] * 0.01)
            return w_new, y_t

        w_out, y_ib = jax.lax.scan(step, w0, (x_ib, mag_ib, idx, reset))

        y = jnp.zeros((x_spec.shape[0], x_spec.shape[2]), dtype=self.cdtype)
        y = y.at[:, ib].set(y_ib)
        out, prev = common.istft_ext_carry(y, self.engine, self.window,
                                           carry.out_prev)
        new_state = (common.WolaCarry(tail, prev), w_out, th_val[-1])
        return out * p.out_amp, new_state

    def _control_arrays(self, theta, t, interference):
        from beamform_tpu.runtime.timeline import (
            InterferenceTimeline, static_interference, unique_control_rows)
        th = common.theta_per_frame(theta, t)
        tl = interference
        if tl is None:
            tl = static_interference(t, self.interf, capacity=self.capacity)
        tl_t = InterferenceTimeline(tl.angles[:t], tl.active[:t],
                                    tl.row0[:t], tl.reset[:t])
        u_th, u_ang, u_act, u_r0, idx = unique_control_rows(th, tl_t)
        return (u_th.astype(self.np_r), u_ang.astype(self.np_r),
                u_act.astype(self.np_r), u_r0.astype(self.np_r), idx,
                np.asarray(tl.reset[:t]))

    def process_chunk(self, x_chunk, theta, state, interference=None):
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
        s_state = state[1].shape[-2]
        s_ctrl = ctrl[1].shape[-1] + 1
        assert s_state == s_ctrl, (
            f"demixing state holds {s_state} source slots but the "
            f"interference timeline has capacity {s_ctrl - 1}; build the "
            "model with capacity=timeline.capacity (or size stream_init "
            "with the same capacity)")
        return self._jit(x, *ctrl, state)

    def batch_controls(self, thetas_bt, interference=None):
        ctrl = super().batch_controls(thetas_bt, interference)
        reset_extra = np.zeros((np.asarray(thetas_bt).shape[-1],), dtype=bool)
        return ctrl + (reset_extra,)

    def process(self, x, theta=0.0, interference=None):
        x = common.prepare_input(x, self.engine, self.rdtype)
        cap = (interference.capacity if interference is not None
               else self.capacity)
        out, _ = self.process_chunk(x, theta, self.stream_init(capacity=cap),
                                    interference)
        return out
