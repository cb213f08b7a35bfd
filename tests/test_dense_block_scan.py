"""The dense MVDR/LCMV block scan against the float64 oracle.

MVDR and LCMV solve every (frame, in-band bin) pair of a block of frames
at once: batched outer products, one banded product for the sliding
covariance, a batched Gauss-Jordan inverse (models/mvdr.py). Here the
float32 route is held to the float64 oracle's output within the repo's
1e-3 budget, and the float64 route to the oracle at round-off, on the
shapes that stress the block structure: several blocks per call, long
histories, bands up to the Nyquist bin, theta changes.

Reference semantics: mvdr.cpp:62-115, lcmv.cpp:108-138.
"""

import numpy as np
import pytest

from beamform_tpu.config import EngineConfig
from beamform_tpu.models import get_model
from beamform_tpu.models.mvdr import MvdrModel
from beamform_tpu.oracle import nodes as on

from conftest import AIRA3, cfg3, make_scene, oracle_callbacks

HOP = 128
FS = 48000

BASE = dict(past_windows=6, freq_mag_threshold=0.0008, freq_max=16000.0,
            freq_min=100.0, out_amp=1.0)


def engine(dtype):
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype)


def oracle(name, params, interf=(), theta=20.0):
    if name == "mvdr":
        return on.MvdrOracle(AIRA3, HOP, FS, theta, **params)
    return on.LcmvOracle(AIRA3, HOP, FS, theta, interference_angles=interf,
                         **params)


def run(name, dtype, params, x, theta=20.0, interf=()):
    model = get_model(name, engine(dtype), cfg3(interf), params)
    return np.asarray(model.process(x, theta))


@pytest.mark.parametrize("name", ["mvdr", "lcmv"])
def test_block_scan_float32_matches_oracle(name):
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    interf = (-50.0,) if name == "lcmv" else ()
    ref = oracle_callbacks(oracle(name, BASE, interf), x, HOP)
    y = run(name, "float32", BASE, x, interf=interf)
    assert np.isfinite(y).all()
    assert np.max(np.abs(y - ref)) < 1e-3


def test_block_scan_streaming_equals_offline():
    """Chunked == one-shot in float64 at round-off: the carried history is
    exactly the last W frames seen."""
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    model = get_model("lcmv", engine("float64"), cfg3((60.0,)), BASE)
    y_off = np.asarray(model.process(x, 20.0))
    n = x.shape[-1] // HOP * HOP
    state = model.stream_init()
    outs = []
    for i in range(0, n, 3 * HOP):
        y, state = model.process_chunk(x[:, i:i + 3 * HOP], 20.0, state)
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(outs), y_off[:n], atol=1e-10)


def test_several_blocks_match_oracle(monkeypatch):
    """Force 8-frame covariance blocks, so one call scans many blocks and
    every block boundary carries the history: float64 == oracle."""
    monkeypatch.setattr(MvdrModel, "_block_frames", lambda self, t: 8)
    x = make_scene(AIRA3, seconds=0.3, quiet_hops=8, hop=HOP)
    y = run("mvdr", "float64", BASE, x)
    ref = oracle_callbacks(oracle("mvdr", BASE), x, HOP)
    np.testing.assert_allclose(y, ref, atol=1e-7)


@pytest.mark.parametrize("frames", [8, 17])
def test_block_size_does_not_change_output(monkeypatch, frames):
    """The block length is a memory/parallelism trade only: any block
    size reproduces the default blocking at float64 round-off."""
    x = make_scene(AIRA3, seconds=0.3, quiet_hops=8, hop=HOP)
    y_default = run("lcmv", "float64", BASE, x, interf=(60.0,))
    monkeypatch.setattr(MvdrModel, "_block_frames", lambda self, t: frames)
    y_blocked = run("lcmv", "float64", BASE, x, interf=(60.0,))
    np.testing.assert_allclose(y_blocked, y_default, atol=1e-10)


def test_nyquist_band_matches_oracle():
    """A band reaching the Nyquist bin and its extended-layout shadow:
    the half-spectrum fold must not double-count them."""
    params = dict(BASE, freq_max=24000.0)
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    ref = oracle_callbacks(oracle("mvdr", params), x, HOP)
    np.testing.assert_allclose(run("mvdr", "float64", params, x), ref,
                               atol=1e-7)
    assert np.max(np.abs(run("mvdr", "float32", params, x) - ref)) < 1e-3


@pytest.mark.parametrize("name", ["mvdr", "lcmv"])
def test_long_past_windows_match_oracle(name):
    """past_windows = 48: the covariance block workspace grows with W."""
    params = dict(BASE, past_windows=48)
    interf = (60.0,) if name == "lcmv" else ()
    x = make_scene(AIRA3, seconds=0.4, quiet_hops=8, hop=HOP)
    ref = oracle_callbacks(oracle(name, params, interf), x, HOP)
    y = run(name, "float32", params, x, interf=interf)
    assert np.max(np.abs(y - ref)) < 1e-3


def test_theta_timeline_matches_oracle():
    """A mid-stream /theta message re-steers the distortionless
    constraint from the next frame on."""
    x = make_scene(AIRA3, seconds=0.3, quiet_hops=8, hop=HOP)
    t = x.shape[1] // HOP
    th = np.full(t, 20.0)
    th[t // 2:] = -35.0
    ref = oracle_callbacks(oracle("mvdr", BASE), x, HOP, th)
    np.testing.assert_allclose(run("mvdr", "float64", BASE, x, theta=th),
                               ref, atol=1e-7)
    assert np.max(np.abs(run("mvdr", "float32", BASE, x, theta=th)
                         - ref)) < 1e-3


def test_lcmv_event_timeline_float32_matches_float64():
    """Interference moves through the masked constraint slots (the
    /theta_interference protocol, lcmv.cpp:258-309); each move resets the
    row-0 quirk and the constraint matrix mid-stream."""
    from beamform_tpu.runtime.timeline import (
        InterfEvent, replay_interference_events)
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    t = x.shape[-1] // HOP
    tl = replay_interference_events(
        t, [-40.0], [InterfEvent(frame=t // 3, id=1, angle=-60.0),
                     InterfEvent(frame=2 * t // 3, id=1, angle=45.0)],
        capacity=2)
    models = [get_model("lcmv", engine(d), cfg3((-40.0,)), BASE)
              for d in ("float32", "float64")]
    y32, y64 = (np.asarray(m.process(x, 20.0, interference=tl))
                for m in models)
    assert np.max(np.abs(y32 - y64)) < 1e-3
