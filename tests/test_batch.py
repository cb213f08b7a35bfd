"""Batched multi-stream execution equals per-stream execution."""

import numpy as np
import pytest

from beamform_tpu.config import EngineConfig, parse_array_config
from beamform_tpu.models import get_model
from beamform_tpu.runtime.batch import BatchRunner

from conftest import AIRA3, make_scene

HOP = 128


def cfg3():
    return parse_array_config({f"mic{i}": {"id": i, "x": x, "y": y}
                               for i, (x, y) in enumerate(AIRA3)})


@pytest.mark.parametrize("name,params", [
    ("das", {}),
    ("mcra", dict(L=10)),
    ("gss", dict(freq_mag_threshold=0.0008, freq_max=16000.0,
                 freq_min=100.0, mu=0.001)),
    ("gsc", dict(mu0=0.0001, mu_max=0.1, filter_size=16)),
    ("mvdr", dict(past_windows=6, freq_mag_threshold=0.0008,
                  freq_max=16000.0, freq_min=100.0)),
    ("lcmv", dict(past_windows=6, freq_mag_threshold=0.0008,
                  freq_max=16000.0, freq_min=100.0)),
])
def test_batch_matches_single(name, params):
    engine = EngineConfig(sample_rate=48000, window_size=HOP,
                          dtype="float64")
    b = 3
    # quiet lead-in keeps MVDR/LCMV cold covariances below the energy gate
    xs = np.stack([make_scene(AIRA3, seconds=0.1, theta_deg=10.0 + 7 * i,
                              seed=10 + i, hop=HOP, quiet_hops=8)
                   for i in range(b)])
    thetas = np.array([5.0, -20.0, 40.0])

    runner = BatchRunner(name, engine, cfg3(), params, batch=b)
    yb = np.asarray(runner.process(xs, thetas))

    model = get_model(name, engine, cfg3(), params)
    for i in range(b):
        yi = np.asarray(model.process(xs[i], float(thetas[i])))
        np.testing.assert_allclose(yb[i], yi, atol=1e-10)


def test_batch_runner_uses_only_the_declared_protocol():
    """BatchRunner must not reach into model privates (VERDICT round 1):
    everything model-specific rides batch_controls/batched_forward/
    batched_state_init."""
    import inspect
    from beamform_tpu.runtime import batch as batch_mod
    src = inspect.getsource(batch_mod)
    assert "._forward" not in src        # no private-forward dispatch
    assert "model.name" not in src       # no per-model name switch


def test_gss_model_is_reentrant_across_capacities():
    """One GssModel instance can serve sessions with different interference
    capacities concurrently: capacity is explicit state-shape input, not a
    mutated attribute."""
    from beamform_tpu.runtime.timeline import static_interference

    engine = EngineConfig(sample_rate=48000, window_size=HOP,
                          dtype="float64")
    params = dict(freq_mag_threshold=0.0008, freq_max=16000.0,
                  freq_min=100.0, mu=0.001)
    model = get_model("gss", engine, cfg3(), params)
    x = make_scene(AIRA3, seconds=0.1, hop=HOP)
    t = x.shape[-1] // HOP
    tl5 = static_interference(t, [], capacity=5)

    # interleave: plain run, capacity-5 run, plain run again — the second
    # plain run must match the first (no hidden capacity left behind)
    y_plain_1 = np.asarray(model.process(x, 10.0))
    y_cap5 = np.asarray(model.process(x, 10.0, interference=tl5))
    y_plain_2 = np.asarray(model.process(x, 10.0))
    np.testing.assert_array_equal(y_plain_1, y_plain_2)
    # the masked capacity-5 run solves the same active problem
    np.testing.assert_allclose(y_cap5, y_plain_1, atol=1e-10)

    # states of both shapes can be held and advanced side by side
    st_a = model.stream_init()
    st_b = model.stream_init(capacity=5)
    _, st_a = model.process_chunk(x, 10.0, st_a)
    _, st_b = model.process_chunk(x, 10.0, st_b, interference=tl5)
    assert st_a[1].shape[-2] == 1 and st_b[1].shape[-2] == 6


def test_batch_state_carries():
    engine = EngineConfig(sample_rate=48000, window_size=HOP,
                          dtype="float64")
    b = 2
    xs = np.stack([make_scene(AIRA3, seconds=0.1, seed=20 + i, hop=HOP)
                   for i in range(b)])
    runner = BatchRunner("mcra", engine, cfg3(), dict(L=5), batch=b)
    half = xs.shape[-1] // (2 * HOP) * HOP
    y1 = np.asarray(runner.process(xs[:, :, :half]))
    y2 = np.asarray(runner.process(xs[:, :, half:]))

    model = get_model("mcra", engine, cfg3(), dict(L=5))
    for i in range(b):
        full = np.asarray(model.process(xs[i]))
        np.testing.assert_allclose(np.concatenate([y1[i], y2[i]]), full,
                                   atol=1e-10)


@pytest.mark.parametrize("name", ["mvdr", "lcmv", "gsc"])
def test_batch_float32_matches_single(name):
    """BatchRunner on a float32 engine (the deployed dtype): mvdr/lcmv ride
    the default vmap over ``_forward``, gsc its natively batched stage;
    both equal the single-stream runs at float32 round-off."""
    engine = EngineConfig(sample_rate=48000, window_size=HOP,
                          dtype="float32")
    params = (dict(mu0=0.0001, mu_max=0.1, filter_size=32) if name == "gsc"
              else dict(past_windows=6, freq_mag_threshold=0.0008,
                        freq_max=16000.0, freq_min=100.0))
    b = 2
    xs = np.stack([make_scene(AIRA3, seconds=0.1, theta_deg=10.0 + 7 * i,
                              seed=30 + i, hop=HOP, quiet_hops=6)
                   for i in range(b)])
    thetas = np.array([5.0, -20.0])

    runner = BatchRunner(name, engine, cfg3(), params, batch=b)
    yb = np.asarray(runner.process(xs, thetas))

    model = get_model(name, engine, cfg3(), params)
    for i in range(b):
        yi = np.asarray(model.process(xs[i], float(thetas[i])))
        np.testing.assert_allclose(yb[i], yi, atol=1e-7)
