"""Batched multi-stream execution: the fleet-scale throughput path.

The reference processes exactly one stream per process; production
serving wants many recordings/arrays per device. Every model declares its own
batching (see beamform_tpu.models.batching): stacked carried state, vmapped
or natively batched forward, shared vs per-stream control axes. Combine
with ``parallel.sharded`` to spread the batch over a multi-chip mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax.numpy as jnp
import numpy as np

from beamform_tpu.config import ArrayConfig, EngineConfig
from beamform_tpu.models import get_model


class BatchRunner:
    """Run one model over a batch of streams with batched carried state.

    All streams share the model configuration and geometry (one array
    design, many recordings — the common fleet case); theta may differ per
    stream. Pure protocol consumer: everything model-specific lives behind
    ``batch_controls`` / ``batched_forward`` / ``batched_state_init``.
    """

    def __init__(self, model_name: str, engine: EngineConfig,
                 array_cfg: ArrayConfig,
                 params: Optional[Dict[str, Any]] = None,
                 batch: int = 8):
        self.model = get_model(model_name, engine, array_cfg, params)
        self.batch = batch
        self.hop = engine.hop
        self.state = self.model.batched_state_init(batch)

    def process(self, x_batch, theta=0.0):
        """x_batch: (B, M, k*hop) -> (B, k*hop) outputs.

        theta: scalar (shared) or (B,) per-stream constant angles, or
        (B, T) per-stream timelines.
        """
        x = jnp.asarray(x_batch, dtype=self.model.rdtype)
        b = x.shape[0]
        assert b == self.batch, (b, self.batch)
        t = x.shape[-1] // self.hop

        th = np.asarray(theta, dtype=np.float64)
        if th.ndim == 0:
            th = np.full((b, t), float(th))
        elif th.ndim == 1:
            th = np.repeat(th[:, None], t, axis=1)
        ctrl = self.model.batch_controls(th)
        out, self.state = self.model.batched_forward(x, ctrl, self.state)
        return out
