"""Array geometry, steering delays, frequency vectors and steering weights.

Array-first re-design of the reference's geometry layer (util.h:136-199 and the
per-node ``update_weights`` functions, e.g. das.cpp:27-45): instead of mutating
a global weight matrix from a ROS callback, weights are a pure function of
``(geometry, angle, freqs)`` and can be evaluated batched over a per-frame
angle timeline with ``vmap``.

All angle parameters are in degrees, matching the reference convention
(0 = front, -90 = left, 90 = right, 180 = back; README.md:21).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from beamform_tpu.config import ArrayConfig

V_SOUND = 343.0  # m/s (util.h:25)


@dataclass(frozen=True)
class ArrayGeometry:
    """Static device-ready geometry: polar coordinates per mic.

    ``dist``/``angle_deg`` follow the reference semantics: computed from the
    YAML coordinates *before* mic0 re-referencing (util.h:83-84; see
    beamform_tpu.config).
    """

    dist: np.ndarray       # (M,) float64
    angle_deg: np.ndarray  # (M,) float64

    @property
    def num_mics(self) -> int:
        return int(self.dist.shape[0])

    @staticmethod
    def from_config(cfg: ArrayConfig) -> "ArrayGeometry":
        return ArrayGeometry(
            dist=np.array([m.dist for m in cfg.mics], dtype=np.float64),
            angle_deg=np.array([m.angle_deg for m in cfg.mics],
                               dtype=np.float64),
        )

    @staticmethod
    def from_xy(xy: Sequence) -> "ArrayGeometry":
        xy = np.asarray(xy, dtype=np.float64)
        return ArrayGeometry(
            dist=np.hypot(xy[:, 0], xy[:, 1]),
            angle_deg=np.degrees(np.arctan2(xy[:, 1], xy[:, 0])),
        )


def wrap_angle_deg(a):
    """Single-branch wrap to (-180, 180], as the reference does it
    (util.h:151-155): one conditional +-360, not a modulo."""
    a = jnp.where(a > 180.0, a - 360.0, a)
    return jnp.where(a < -180.0, a + 360.0, a)


def steering_delays(geom: ArrayGeometry, angle_deg, *, dtype=None):
    """Far-field steering delays tau_m (seconds), util.h:136-161.

    tau_0 = 0 (mic0 is the reference); tau_m = d_m cos(phi_m - theta)/(-c).
    ``angle_deg`` may be a scalar or an arbitrary batch; output shape is
    ``angle.shape + (M,)``.
    """
    if dtype is None:
        dtype = jnp.zeros(0).dtype  # default real dtype (f32, or f64 on x64)
    angle_deg = jnp.asarray(angle_deg, dtype=dtype)
    dist = jnp.asarray(geom.dist, dtype=dtype)
    mic_ang = jnp.asarray(geom.angle_deg, dtype=dtype)
    rel = wrap_angle_deg(mic_ang - angle_deg[..., None])
    tau = dist * jnp.cos(jnp.deg2rad(rel)) / (-V_SOUND)
    # mic0 is the reference: delay forced to exactly 0 (util.h:144-147).
    return tau.at[..., 0].set(0.0)


def frequency_vector(nfft: int, sample_rate: float, *, exact: bool = False,
                     dtype=np.float64) -> np.ndarray:
    """Full-length (positive and negative) frequency vector, util.h:190-199.

    The reference implementation has an off-by-one: after filling bins
    1..N/2-1 with k*fs/N and bins N/2+1..N-1 with the mirrored negatives, it
    overwrites ``f[N/2-1] = fs/2`` (util.h:198) and never writes ``f[N/2]``
    at all — on a freshly malloc'd (zero) page that bin reads 0.0. Every
    beamformer builds steering weights from this vector, so the quirk shapes
    real output: bins N/2-1 and N/2+1 are NOT complex conjugates. The
    faithful vector is the default; ``exact=True`` gives the standard DFT
    layout with ``f[N/2] = fs/2``.

    Host-side (numpy): this is static per engine config.
    """
    n = int(nfft)
    f = np.zeros(n, dtype=dtype)
    k = np.arange(1, n // 2, dtype=dtype)          # 1 .. N/2-1
    f[1:n // 2] = k / n * sample_rate
    f[n // 2 + 1:] = -f[1:n // 2][::-1]
    if exact:
        f[n // 2] = sample_rate / 2.0
    else:
        f[n // 2 - 1] = sample_rate / 2.0          # util.h:198 overwrite
        f[n // 2] = 0.0                            # never initialised
    return f


def steering_weights(freqs, delays, *, row0_scale=1.0):
    """Steering weight matrix w[m, k] = exp(-i 2 pi f_k tau_m).

    Matches the per-node ``update_weights`` loops (das.cpp:27-45 etc.):
    row 0 is the constant ``row0_scale`` (1.0 normally; the reference zeroes
    it after an interference reallocation because ``ini=false`` skips row 0
    on freshly zeroed buffers — lcmv.cpp:50-56 + allocate_interf_buffers).

    ``delays`` may be batched: shape ``(..., M)`` -> weights ``(..., M, K)``.
    """
    freqs = jnp.asarray(freqs)
    delays = jnp.asarray(delays)
    cdtype = jnp.complex128 if delays.dtype == jnp.float64 else jnp.complex64
    phase = -2.0 * jnp.pi * delays[..., :, None] * freqs[None, :]
    # cos/sin instead of complex exp: the same real arithmetic on every
    # backend, bit-for-bit with the float64 oracle
    w = jax.lax.complex(jnp.cos(phase), jnp.sin(phase)).astype(cdtype)
    row0 = jnp.full(w.shape[:-2] + (1, w.shape[-1]), row0_scale, dtype=cdtype)
    return jnp.concatenate([row0, w[..., 1:, :]], axis=-2)


def steering_delays_np(geom: ArrayGeometry, angle_deg) -> np.ndarray:
    """Host-side (pure numpy) steering delays; same math as
    :func:`steering_delays`, for control inputs built on the host."""
    angle_deg = np.asarray(angle_deg, dtype=np.float64)
    rel = geom.angle_deg - angle_deg[..., None]
    rel = np.where(rel > 180.0, rel - 360.0, rel)
    rel = np.where(rel < -180.0, rel + 360.0, rel)
    tau = geom.dist * np.cos(np.deg2rad(rel)) / (-V_SOUND)
    tau[..., 0] = 0.0
    return tau


def steering_weights_np(freqs, delays, *, row0_scale=1.0) -> np.ndarray:
    """Host-side (pure numpy) steering weights; same math as
    :func:`steering_weights`."""
    freqs = np.asarray(freqs, dtype=np.float64)
    delays = np.asarray(delays, dtype=np.float64)
    phase = -2.0 * np.pi * delays[..., :, None] * freqs[None, :]
    w = np.cos(phase) + 1j * np.sin(phase)
    w[..., 0, :] = row0_scale
    return w


def steering_matrix(freqs, doi_delays, interf_delays, *, row0_scale=1.0,
                    active_mask: Optional[jnp.ndarray] = None):
    """Constraint/steering matrix A[k][m, s] for LCMV/GSS.

    Column 0 is the direction of interest, columns 1..K the interferences
    (lcmv.cpp:44-86, gss.cpp:51-94). Returns shape ``(K_bins, M, S)`` given
    ``doi_delays (M,)`` and ``interf_delays (S-1, M)``.

    ``active_mask`` (S,) optionally zero-pads inactive interference slots for
    the fixed-capacity masked-constraint design (replaces the reference's
    realloc-under-READY=false protocol, lcmv.cpp:221-309).
    """
    all_delays = jnp.concatenate([doi_delays[None, :], interf_delays], axis=0)
    w = steering_weights(freqs, all_delays, row0_scale=row0_scale)  # (S, M, K)
    a = jnp.transpose(w, (2, 1, 0))  # (K_bins, M, S)
    if active_mask is not None:
        a = a * active_mask[None, None, :].astype(a.dtype)
    return a
