"""One route per real choice: removed solver names fail loudly, and the
dense MVDR/LCMV route holds the float32 budget where hand-written kernels
used to take over (streaming, interference timelines, wide arrays).

Reference semantics: mvdr.cpp:62-115, lcmv.cpp:108-138.
"""

import numpy as np
import pytest

from beamform_tpu.config import EngineConfig
from beamform_tpu.models import get_model
from beamform_tpu.oracle import nodes as on

from conftest import AIRA3, cfg3, make_scene

HOP = 128

BASE = dict(past_windows=6, freq_mag_threshold=0.0008, freq_max=16000.0,
            freq_min=100.0)

REMOVED = [("mvdr", "mega", "dense"), ("mvdr", "stream", "dense"),
           ("mvdr", "sparse", "dense"), ("lcmv", "mega", "dense"),
           ("lcmv", "stream", "dense"), ("lcmv", "sparse", "dense"),
           ("gss", "mega", "scan"), ("phase", "fused", "xla"),
           ("phasempf", "fused", "xla"), ("gsc", "block", "sample"),
           ("gsc", "xmu", "sample")]


def engine(dtype):
    return EngineConfig(sample_rate=48000, window_size=HOP, dtype=dtype)


@pytest.mark.parametrize("node,solver,remaining", REMOVED)
def test_removed_solver_raises(node, solver, remaining):
    """A kernel that no longer exists is never replaced silently: the
    model refuses the name and says which strategy remains."""
    with pytest.raises(ValueError, match=f"removed.*'{remaining}'"):
        get_model(node, engine("float32"), cfg3(), {"solver": solver})


def test_removed_solver_raises_through_cli(tmp_path):
    from beamform_tpu.runtime import wav as wav_io
    from beamform_tpu.runtime.cli import main
    x = make_scene(AIRA3, seconds=0.05, hop=HOP)
    wav_in = str(tmp_path / "in.wav")
    wav_io.write_wav(wav_in, x / np.abs(x).max(), 48000, fmt="float32")
    with pytest.raises(ValueError, match="removed"):
        main(["mvdr", "--in", wav_in, "--out", str(tmp_path / "o.wav"),
              "--window-size", str(HOP), "--param", "solver=mega"])


def test_unknown_solver_and_mu_trace_conflict_raise():
    with pytest.raises(ValueError, match="unknown.*'dense'"):
        get_model("mvdr", engine("float32"), cfg3(), {"solver": "auto"})
    with pytest.raises(ValueError, match="write_mu"):
        get_model("gsc", engine("float32"), cfg3(),
                  {"solver": "blocklms", "write_mu": True})


@pytest.mark.parametrize("name", ["mvdr", "lcmv"])
def test_dense_float32_matches_oracle(name):
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    interf = (60.0,) if name == "lcmv" else ()
    y = np.asarray(get_model(name, engine("float32"), cfg3(interf),
                             dict(BASE, out_amp=1.0)).process(x, 20.0))
    if name == "mvdr":
        o = on.MvdrOracle(AIRA3, HOP, 48000, 20.0, out_amp=1.0, **BASE)
    else:
        o = on.LcmvOracle(AIRA3, HOP, 48000, 20.0, interference_angles=interf,
                          out_amp=1.0, **BASE)
    from beamform_tpu.oracle.engine import run_oracle
    ref = run_oracle(o, x, HOP)
    assert np.isfinite(y).all()
    assert np.max(np.abs(y - ref)) < 1e-3


def test_dense_streaming_equals_offline():
    """Chunked output matches one-shot: the block scan carries the
    W-frame covariance history and the WOLA state across chunks."""
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    model = get_model("mvdr", engine("float32"), cfg3(), BASE)
    y_off = np.asarray(model.process(x, 20.0))
    n = x.shape[-1] // HOP * HOP
    state = model.stream_init()
    outs = []
    for i in range(0, n, 4 * HOP):
        y, state = model.process_chunk(x[:, i:i + 4 * HOP], 20.0, state)
        outs.append(np.asarray(y))
    y_chunks = np.concatenate(outs)
    scale = max(np.abs(y_off).max(), 1e-12)
    assert np.abs(y_chunks - y_off[:len(y_chunks)]).max() / scale < 2e-4


def _ring_cfg(m):
    from beamform_tpu.config import parse_array_config
    ang = np.linspace(0, 2 * np.pi, m, endpoint=False)
    return parse_array_config(
        {f"mic{i}": {"id": i, "x": 0.05 * np.cos(a), "y": 0.05 * np.sin(a)}
         for i, a in enumerate(ang)})


@pytest.mark.parametrize("name", ["mvdr", "lcmv"])
def test_wide_array_runs_dense(name):
    """40 mics: past every on-chip limit the removed kernels had. The dense
    route has none; float32 stays inside the budget of the float64 run."""
    rng = np.random.default_rng(4)
    x = 0.1 * rng.standard_normal((40, 40 * HOP))
    x[:, :8 * HOP] *= 1e-4
    params = dict(BASE, past_windows=48, freq_max=4000.0)
    y32 = np.asarray(get_model(name, engine("float32"), _ring_cfg(40),
                               params).process(x, 20.0))
    y64 = np.asarray(get_model(name, engine("float64"), _ring_cfg(40),
                               params).process(x, 20.0))
    assert np.isfinite(y32).all()
    assert np.max(np.abs(y32 - y64)) < 1e-3


def test_control_cache_is_lru():
    """Overflowing the control cache evicts only the least-recently-used
    entry — a 17th key must not wipe the 16 hot ones (the old clear()-at-
    capacity behavior re-uploaded every control array after overflow)."""
    model = get_model("mvdr", engine("float32"), cfg3(), BASE)
    builds = []
    for k in range(16):
        model._cached(("k", k), lambda k=k: builds.append(k) or k)
    model._cached(("k", 0), lambda: builds.append("rebuild-0"))  # refresh 0
    model._cached(("k", 16), lambda: builds.append(16) or 16)    # evicts 1
    for k in [0] + list(range(2, 17)):
        model._cached(("k", k), lambda k=k: builds.append(("miss", k)))
    assert builds == list(range(16)) + [16], builds


def test_lcmv_interference_timeline_float32_matches_float64():
    """Constraint slots added and moved by the masked timeline: the
    float32 route stays within the budget of the float64 route (which
    tests/test_interf_control.py ties to the event replay)."""
    from beamform_tpu.runtime.timeline import (
        InterfEvent, replay_interference_events)
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    t = x.shape[-1] // HOP + 1
    tl = replay_interference_events(
        t, [60.0], [InterfEvent(frame=6, id=1, angle=-45.0),
                    InterfEvent(frame=12, id=1, angle=-50.0)],
        capacity=3)
    y32 = np.asarray(get_model("lcmv", engine("float32"), cfg3(),
                               BASE).process(x, 20.0, interference=tl))
    y64 = np.asarray(get_model("lcmv", engine("float64"), cfg3(),
                               BASE).process(x, 20.0, interference=tl))
    # M=3 with up to 3 constraints is a fully determined, ill-conditioned
    # system: the float32 solve carries ~1e-4 of round-off here
    assert np.max(np.abs(y32 - y64)) < 1e-3
