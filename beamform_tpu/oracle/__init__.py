"""Float64 NumPy oracle: a literal per-window simulation of the C++ reference.

These implementations intentionally mirror the reference's control flow
(per-callback ring buffers, per-bin loops, quirks and all) rather than the
framework's batched design, so that parity tests compare two
*independently derived* implementations of the same math. They are the test
stand-in for running the actual C++ nodes (which need JACK + ROS).
"""

from beamform_tpu.oracle.engine import OracleWola, run_oracle  # noqa: F401
from beamform_tpu.oracle import nodes  # noqa: F401
