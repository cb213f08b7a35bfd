"""The GSS frame scan against the float64 oracle.

The per-bin demixing matrices are the carry of a ``lax.scan`` over frames
(models/gss.py, gss.cpp:96-156). The float32 route is held to the float64
oracle within the repo's 1e-3 budget on the shapes that stress the scan:
interference slots, theta resets, event timelines, chunked streaming, and
bands that touch the DC or the Nyquist bin.
"""

import numpy as np
import pytest

from beamform_tpu.config import EngineConfig
from beamform_tpu.models import get_model
from beamform_tpu.oracle import nodes as on

from conftest import AIRA3, cfg3, make_scene, oracle_callbacks

HOP = 128
FS = 48000

BASE = dict(freq_mag_threshold=0.0008, freq_max=16000.0, freq_min=100.0,
            mu=0.01, out_amp=1.0)


def engine(dtype):
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype)


def oracle(params, interf=(), theta=20.0):
    return on.GssOracle(AIRA3, HOP, FS, theta, interference_angles=interf,
                        **params)


def run(dtype, params, x, theta=20.0, interf=(), **kw):
    model = get_model("gss", engine(dtype), cfg3(interf), params)
    return np.asarray(model.process(x, theta, **kw))


def assert_budget(y, ref):
    assert np.isfinite(y).all()
    assert np.max(np.abs(y - ref)) < 1e-3, np.max(np.abs(y - ref))


def test_gss_float32_matches_oracle():
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    assert_budget(run("float32", BASE, x), oracle_callbacks(oracle(BASE), x,
                                                            HOP))


def test_gss_interference_slots_match_oracle():
    """Two interferences: three source slots, the active count drives the
    gradient constants (gss.cpp:132-133)."""
    interf = (-40.0, 60.0)
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    ref = oracle_callbacks(oracle(BASE, interf), x, HOP)
    assert_budget(run("float32", BASE, x, interf=interf), ref)


def test_gss_theta_change_resets_w():
    """A theta change resets W to A^H (update_weights, gss.cpp:90-93)."""
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    t = x.shape[-1] // HOP
    th = np.full(t, 20.0)
    th[t // 2:] = -35.0
    ref = oracle_callbacks(oracle(BASE), x, HOP, th)
    assert_budget(run("float32", BASE, x, theta=th), ref)


def test_gss_streaming_equals_offline():
    """Chunked == one-shot: the WOLA carry, the demixing matrices and
    prev_theta cross the chunk boundaries."""
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    model = get_model("gss", engine("float64"), cfg3(), BASE)
    y_off = np.asarray(model.process(x, 20.0))
    n = x.shape[-1] // HOP * HOP
    state = model.stream_init()
    outs = []
    for i in range(0, n, 4 * HOP):
        y, state = model.process_chunk(x[:, i:i + 4 * HOP], 20.0, state)
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(outs), y_off[:n], atol=1e-10)


def test_gss_one_hop_chunks_equal_offline():
    """The live shape: one hop per call, float32."""
    x = make_scene(AIRA3, seconds=0.1, quiet_hops=4, hop=HOP)
    model = get_model("gss", engine("float32"), cfg3(), BASE)
    y_off = np.asarray(model.process(x, 20.0))
    n = x.shape[-1] // HOP * HOP
    state = model.stream_init()
    outs = []
    for i in range(0, n, HOP):
        y, state = model.process_chunk(x[:, i:i + HOP], 20.0, state)
        outs.append(np.asarray(y))
    scale = max(np.abs(y_off).max(), 1e-12)
    assert np.abs(np.concatenate(outs) - y_off[:n]).max() / scale < 1e-5


def test_gss_event_timeline_float32_matches_float64():
    """Interference add/move events flow through the masked slots and the
    reset stream (interf_theta_roscallback, gss.cpp:288-339)."""
    from beamform_tpu.runtime.timeline import (
        InterfEvent, replay_interference_events)
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    t = x.shape[-1] // HOP
    tl = replay_interference_events(
        t, [-40.0], [InterfEvent(frame=t // 3, id=2, angle=55.0),
                     InterfEvent(frame=2 * t // 3, id=1, angle=54.0)],
        capacity=2)
    y32 = run("float32", BASE, x, interf=(-40.0,), interference=tl)
    y64 = run("float64", BASE, x, interf=(-40.0,), interference=tl)
    assert_budget(y32, y64)


@pytest.mark.parametrize("band", [dict(freq_min=0.0), dict(freq_max=24000.0)])
def test_gss_band_edges_match_oracle(band):
    """gss.cpp's bin loop starts at j=0 (no DC special case): a band from
    0 Hz gates bin 0 too; a band to 24 kHz includes the Nyquist bin and
    its shadow in the extended layout."""
    params = dict(BASE, **band)
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    ref = oracle_callbacks(oracle(params), x, HOP)
    np.testing.assert_allclose(run("float64", params, x), ref, atol=1e-8)
    assert_budget(run("float32", params, x), ref)
