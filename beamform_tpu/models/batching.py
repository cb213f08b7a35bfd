"""Declared multi-stream batching protocol.

The reference serves exactly one stream per process (one JACK client each,
CMakeLists.txt:53-63); fleet-scale serving batches many streams per
device. Every model declares how its ``_forward`` batches instead of leaving
``runtime.batch.BatchRunner`` to reach into model privates:

* ``batch_axes`` — vmap ``in_axes`` for the control args between ``x`` and
  ``state`` (0 = stacked per stream, None = shared across the batch);
* ``batch_controls(thetas_bt, interference=None)`` — build those control
  args from per-stream ``(B, T)`` theta timelines;
* ``batched_forward(x, ctrl, state)`` — the compiled batched step. The
  default vmaps ``_forward`` with ``batch_axes``; models with a natively
  batched kernel (GSC's sample-serial stage) override it;
* ``batched_state_init(batch)`` — stacked carried state.
"""

from __future__ import annotations

import numpy as np


class BatchableModel:
    """Mixin: default batching behavior for carry-style models.

    Assumes the subclass provides ``_forward(x, thetas, w_idx, state)``,
    ``stream_init()``, ``np_r`` and ``rdtype``.
    """

    #: vmap in_axes for the _forward args between x and state.
    batch_axes = (None, 0)          # (unique thetas shared, w_idx per stream)

    def _cached(self, key, builder):
        """Small per-model memo for device-resident control arrays.

        Identical per-chunk control arrays (theta indices, steering
        uniques) are shipped to the device once instead of every call; JAX
        arrays are immutable, so reusing them is safe. Kept until the
        served path is measured (ROADMAP D3). LRU eviction: a steering sweep
        cycling through more than 16 control keys must not thrash the whole
        cache each revolution."""
        from collections import OrderedDict
        cache = self.__dict__.setdefault("_ctrl_cache", OrderedDict())
        if key in cache:
            cache.move_to_end(key)
        else:
            if len(cache) >= 16:
                cache.popitem(last=False)
            cache[key] = builder()
        return cache[key]

    def _theta_ctrl(self, theta, t: int):
        """Device-resident (unique thetas, per-frame index) for a chunk."""
        import jax
        from beamform_tpu.models import common
        key = ("th", np.asarray(theta, np.float64).tobytes(), t)

        def build():
            th = common.theta_per_frame(theta, t)
            uniq, w_idx = common.unique_thetas(th)
            return (jax.device_put(uniq.astype(self.np_r)),
                    jax.device_put(w_idx))

        return self._cached(key, build)

    def batch_controls(self, thetas_bt, interference=None):
        """(B, T) per-stream theta timelines -> _forward control args."""
        if interference is not None:
            raise ValueError(
                f"{type(self).__name__} takes no interference timeline")
        uniq, idx = _unique_thetas_bt(thetas_bt)
        return (uniq.astype(self.np_r), idx)

    def batched_forward(self, x, ctrl, state):
        """One batched step: x (B, M, S), ctrl from batch_controls, state
        from batched_state_init. Returns (out (B, S), new state)."""
        import jax
        fn = self.__dict__.get("_batched_fn")
        if fn is None:
            in_axes = (0,) + tuple(self.batch_axes) + (0,)
            fn = jax.jit(jax.vmap(self._forward, in_axes=in_axes))
            self._batched_fn = fn
        return fn(x, *ctrl, state)

    def batched_state_init(self, batch: int):
        import jax
        import jax.numpy as jnp
        single = self.stream_init()
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (batch,) + a.shape), single)


class BatchableConstrainedModel(BatchableModel):
    """Batching for the interference-constrained models (LCMV/GSS): unique
    (theta x interference) control rows are shared, the per-frame row index
    is per-stream. The batch shares one static interference set (one array
    design, many recordings)."""

    def _static_interf_rows(self, n_uniq: int):
        cap = getattr(self, "capacity", len(self.interf))
        ang = np.zeros((n_uniq, cap), dtype=self.np_r)
        act = np.zeros((n_uniq, cap), dtype=self.np_r)
        if len(self.interf):
            ang[:, :len(self.interf)] = np.asarray(self.interf,
                                                   dtype=self.np_r)
            act[:, :len(self.interf)] = 1.0
        r0 = np.ones((n_uniq,), dtype=self.np_r)
        return ang, act, r0

    def batch_controls(self, thetas_bt, interference=None):
        if interference is not None:
            raise ValueError(
                "batched serving shares one static interference set; replay "
                "per-stream event timelines through per-stream sessions")
        uniq, idx = _unique_thetas_bt(thetas_bt)
        ang, act, r0 = self._static_interf_rows(len(uniq))
        return (uniq.astype(self.np_r), ang, act, r0, idx)


def _unique_thetas_bt(thetas_bt):
    th = np.asarray(thetas_bt, dtype=np.float64)
    uniq, inv = np.unique(th.ravel(), return_inverse=True)
    return uniq, inv.reshape(th.shape).astype(np.int32)
