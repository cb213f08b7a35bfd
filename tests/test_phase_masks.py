"""The phase-mask nodes (phase, phasempf) against the float64 oracle.

Both are batched elementwise maps over (frames, bins) that XLA fuses; only
PhaseMPF's MCRA/MPF recurrences run in a ``lax.scan``. The float32 route
is held to the float64 oracle within the repo's 1e-3 budget: a binary mask
can flip only where a bin's mean pair distance sits at float32 round-off
from ``min_phase``, which these scenes do not hit.

Reference semantics: phase.cpp:53-134, phasempf.cpp:140-334.
"""

import numpy as np
import pytest

from beamform_tpu.config import EngineConfig
from beamform_tpu.models import get_model
from beamform_tpu.oracle import nodes as on

from conftest import AIRA3, cfg3, make_scene, oracle_callbacks

HOP = 128
FS = 48000

PMPF = dict(min_phase=30.0, min_mag=0.05, smooth_size=3, MCRA_L=50,
            out_amp=2.5)


def engine(dtype, **kw):
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype, **kw)


def oracle(name, theta=20.0):
    if name == "phase":
        return on.PhaseOracle(AIRA3, HOP, FS, theta)
    return on.PhasempfOracle(AIRA3, HOP, FS, theta, **PMPF)


def params(name):
    return {} if name == "phase" else PMPF


@pytest.mark.parametrize("name", ["phase", "phasempf"])
def test_float32_matches_oracle(name):
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    y = np.asarray(get_model(name, engine("float32"), cfg3(),
                             params(name)).process(x, 20.0))
    ref = oracle_callbacks(oracle(name), x, HOP)
    assert np.isfinite(y).all()
    assert np.max(np.abs(y - ref)) < 1e-3


@pytest.mark.parametrize("name", ["phase", "phasempf"])
def test_theta_timeline_matches_oracle(name):
    """Per-frame steering rows: a mid-stream /theta message."""
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    t = x.shape[-1] // HOP
    th = np.full(t, 20.0)
    th[t // 2:] = -35.0
    y = np.asarray(get_model(name, engine("float32"), cfg3(),
                             params(name)).process(x, th))
    ref = oracle_callbacks(oracle(name), x, HOP, th)
    assert np.max(np.abs(y - ref)) < 1e-3


@pytest.mark.parametrize("chunks", [(4,), (1, 3, 5)])
def test_phasempf_streaming_equals_offline(chunks):
    """Chunked == one-shot at float64 round-off, for equal and uneven
    chunk sizes: the WOLA carries, the MCRA/MPF state and the smoother
    tail survive every boundary."""
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    model = get_model("phasempf", engine("float64"), cfg3(), PMPF)
    y_off = np.asarray(model.process(x, 20.0))
    n = x.shape[-1] // HOP * HOP
    state, outs, i, c = model.stream_init(), [], 0, 0
    while i < n:
        step = chunks[c % len(chunks)] * HOP
        y, state = model.process_chunk(x[:, i:i + step], 20.0, state)
        outs.append(np.asarray(y))
        i, c = i + step, c + 1
    np.testing.assert_allclose(np.concatenate(outs)[:n], y_off[:n],
                               atol=1e-10)


@pytest.mark.parametrize("bug_dc_zero", [True, False])
def test_phasempf_dc_flag_float32_matches_float64(bug_dc_zero):
    """The corrected-DC flag (phasempf.cpp:274 OOB write) reaches the
    output bin 0 on both routes."""
    x = make_scene(AIRA3, seconds=0.1, quiet_hops=2, hop=HOP)
    y32, y64 = (np.asarray(get_model(
        "phasempf", engine(d, bug_dc_zero=bug_dc_zero), cfg3(),
        PMPF).process(x, 20.0)) for d in ("float32", "float64"))
    assert np.max(np.abs(y32 - y64)) < 1e-3


def test_phase_sixteen_mics_matches_oracle():
    """120 mic pairs (the AIRA-16 width) in the pairwise phase distance,
    float64 against the oracle's recursive pair walk (phase.cpp:53-68)."""
    rng = np.random.default_rng(6)
    ang = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    xy = [(0.1 * np.cos(a), 0.1 * np.sin(a)) for a in ang]
    from beamform_tpu.config import parse_array_config
    cfg = parse_array_config({f"mic{i}": {"id": i, "x": a, "y": b}
                              for i, (a, b) in enumerate(xy)})
    x = 0.3 * rng.standard_normal((16, 12 * HOP))
    y = np.asarray(get_model("phase", engine("float64"), cfg,
                             {}).process(x, 20.0))
    ref = oracle_callbacks(on.PhaseOracle(xy, HOP, FS, 20.0), x, HOP)
    np.testing.assert_allclose(y, ref, atol=1e-9)
