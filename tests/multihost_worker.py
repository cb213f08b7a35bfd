"""Worker for the two-process multi-host smoke test (not a pytest file).

Each process: jax.distributed.initialize against a localhost coordinator,
4 virtual CPU devices, a process-major (stream, bin) mesh, process-local
ingest via process_local_batch, one sharded GSS chunk, and a
per-local-shard allclose against the single-device run. Prints one MULTIHOST_OK json line on
success; any assertion kills the process (the parent checks rc).

Usage: python multihost_worker.py <process_id> <num_processes> <port>
"""

import json
import os
import sys

# self-sufficient even when beamform_tpu isn't pip-installed: the repo root
# is this file's parent's parent
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from conftest import AIRA3, make_scene  # noqa: E402

# the single-device reference runs below go to a device of this process
jax.config.update("jax_default_device", jax.local_devices()[0])

from beamform_tpu.config import EngineConfig, parse_array_config  # noqa: E402
from beamform_tpu.models import get_model  # noqa: E402
from beamform_tpu.parallel.multihost import (  # noqa: E402
    multihost_mesh, process_local_batch, process_span)
from beamform_tpu.parallel.sharded import (  # noqa: E402
    sharded_batched_step, sharded_state_init)

assert jax.process_count() == nproc, jax.process_count()
assert jax.process_index() == pid

# a 2-device bin group per process: bins must never span processes
mesh = multihost_mesh(bin_size=2)
assert mesh.axis_names == ("stream", "bin")
report = process_span(mesh)
# the module's invariant: only the stream axis may cross processes
assert report["stream"] == nproc, report
assert report["bin"] == 1, report

hop = 64
engine = EngineConfig(sample_rate=48000, window_size=hop, dtype="float64")
cfg = parse_array_config({f"mic{i}": {"id": i, "x": x, "y": y}
                          for i, (x, y) in enumerate(AIRA3)})
model = get_model("gss", engine, cfg,
                  dict(freq_mag_threshold=0.0008, freq_max=16500.0,
                       freq_min=100.0, mu=0.001))

b_global = mesh.devices.shape[0]
assert b_global % nproc == 0
b_local = b_global // nproc
# every process synthesizes only ITS streams (seeds disjoint by process)
xs_local = np.stack([
    make_scene(AIRA3, seconds=0.05, seed=100 + pid * b_local + j, hop=hop)
    for j in range(b_local)])
xg = process_local_batch(mesh, xs_local)
assert xg.shape == (b_global,) + xs_local.shape[1:]
# ingest stays local: every local shard lives on this process
assert all(s.device.process_index == pid for s in xg.addressable_shards)

state = sharded_state_init(mesh, model, b_global)
out, new_state = sharded_batched_step(mesh, model, xg, 10.0, state)

# local rows of the global output must match this process's single-device
# runs of its own streams
local_rows = {}
for s in out.addressable_shards:
    r0 = s.index[0].start or 0
    for k, row in enumerate(np.asarray(s.data)):
        local_rows[r0 + k] = row
for j in range(b_local):
    want = np.asarray(model.process(xs_local[j], 10.0))
    got = local_rows[pid * b_local + j]
    np.testing.assert_allclose(got, want, atol=1e-10)

print("MULTIHOST_OK " + json.dumps({
    "pid": pid, "procs": jax.process_count(),
    "mesh": list(mesh.devices.shape), "report": report,
    "rows_checked": b_local}))
