"""beamform_tpu — a multichannel acoustic beamforming framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
`balkce/beamform` ROS/JACK package:
seven frequency-domain beamformers (das, mvdr, gsc, lcmv, gss, phase,
phasempf), an MCRA noise estimator, utility passthrough nodes, a streaming
WOLA engine, a theta/interference control timeline, DOA refinement helpers,
WAV + sample-rate-conversion I/O, and multi-chip sharding over a
``jax.sharding.Mesh``.

Design: the reference's JACK-callback + mutable-globals architecture becomes
pure functions over ``(config, state, frames)`` with ``lax.scan`` across
frames; ROS topics become per-frame input timelines; per-bin C++ loops become
batched tensor ops over ``(frames, mics, bins)``.
"""

__version__ = "0.1.0"

# Library-standard logging posture: without this, Python's logging.lastResort
# handler prints config.make_params' per-parameter WARNINGs to stderr on every
# bare library call (run_offline, get_model, bench.py). The CLI attaches its
# own StreamHandler explicitly; applications opt in the usual way.
import logging as _logging

_logging.getLogger(__name__).addHandler(_logging.NullHandler())

from beamform_tpu.config import (  # noqa: F401
    ArrayConfig,
    RosjackConfig,
    load_array_config,
    load_rosjack_config,
)
from beamform_tpu.geometry import (  # noqa: F401
    ArrayGeometry,
    frequency_vector,
    steering_delays,
    steering_weights,
)
from beamform_tpu.runtime.offline import run_offline  # noqa: F401
from beamform_tpu.models import get_model, MODEL_REGISTRY  # noqa: F401
