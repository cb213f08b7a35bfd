"""End-to-end parity: every node vs its float64 oracle transliteration.

The oracle simulates the C++ reference callback-for-callback (ring buffers,
per-bin loops, quirks); the framework runs its batched/scanned design.
Outputs must agree to float64 round-off — far tighter than the 1e-3
float32 budget.
"""

import numpy as np
import pytest

from beamform_tpu.config import EngineConfig
from beamform_tpu.geometry import ArrayGeometry
from beamform_tpu.models import get_model, MODEL_REGISTRY
from beamform_tpu.models.das import DasModel
from beamform_tpu.models.phase import PhaseModel
from beamform_tpu.models.mcra import McraModel
from beamform_tpu.models.phasempf import PhasempfModel
from beamform_tpu.models.mvdr import MvdrModel
from beamform_tpu.models.lcmv import LcmvModel
from beamform_tpu.models.gss import GssModel
from beamform_tpu.models.gsc import GscModel
from beamform_tpu.models.refmic import RefModel, ReadModel
from beamform_tpu.oracle.engine import run_oracle
from beamform_tpu.oracle import nodes as on

from conftest import AIRA3, make_scene

HOP = 128
FS = 48000
THETA = 25.0


def engine(**kw):
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype="float64",
                        **kw)


def geom():
    return ArrayGeometry.from_xy(AIRA3)


def scene(**kw):
    kw.setdefault("hop", HOP)
    kw.setdefault("seconds", 0.2)
    kw.setdefault("theta_deg", THETA)
    return make_scene(AIRA3, fs=FS, **kw)


def assert_close(y_jax, y_oracle, atol=1e-9):
    y_jax = np.asarray(y_jax)
    assert y_jax.shape == y_oracle.shape
    assert np.isfinite(y_jax).all()
    np.testing.assert_allclose(y_jax, y_oracle, atol=atol, rtol=0)


def test_das_parity():
    x = scene()
    model = DasModel(engine(), geom())
    y = model.process(x, THETA)
    o = on.DasOracle(AIRA3, HOP, FS, THETA)
    assert_close(y, run_oracle(o, x, HOP))


def test_das_theta_timeline_parity():
    x = scene(seconds=0.3)
    t = x.shape[1] // HOP
    th = np.full(t, 10.0)
    th[t // 2:] = -40.0  # mid-stream /theta message
    model = DasModel(engine(), geom())
    y = model.process(x, th)
    o = on.DasOracle(AIRA3, HOP, FS, 10.0)
    outs = []
    for k in range(t):
        if k == t // 2:
            o.set_theta(-40.0)
        outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
    assert_close(y, np.concatenate(outs))


def test_phase_parity():
    x = scene()
    params = dict(min_phase=10.0, mag_mult=0.1, mag_threshold=0.05)
    from beamform_tpu.config import PhaseParams
    model = PhaseModel(engine(), geom(), PhaseParams(**params))
    y = model.process(x, THETA)
    o = on.PhaseOracle(AIRA3, HOP, FS, THETA, **params)
    assert_close(y, run_oracle(o, x, HOP))


def test_mcra_parity():
    from beamform_tpu.config import McraParams
    x = scene(seconds=0.4)
    params = dict(alphaS=0.95, alphaD=0.95, alphaD2=0.98, delta=0.001,
                  L=20, out_amp=3.5, out_only_noise=False)
    model = McraModel(engine(), geom(), McraParams(**params))
    y = model.process(x)
    o = on.McraOracle(AIRA3, HOP, FS, **params)
    assert_close(y, run_oracle(o, x, HOP))


def test_mcra_only_noise_parity():
    from beamform_tpu.config import McraParams
    x = scene(seconds=0.25)
    params = dict(L=10, out_only_noise=True)
    model = McraModel(engine(), geom(), McraParams(**params))
    y = model.process(x)
    o = on.McraOracle(AIRA3, HOP, FS, **params)
    assert_close(y, run_oracle(o, x, HOP))


def test_phasempf_parity():
    from beamform_tpu.config import PhasempfParams
    x = scene(seconds=0.4)
    params = dict(min_phase=30.0, min_mag=0.05, smooth_size=3,
                  MCRA_alphaS=0.95, MCRA_alphaD=0.95, MCRA_alphaD2=0.98,
                  MCRA_delta=0.001, MCRA_L=15, MPF_alphaS=0.7, MPF_eta=0.3,
                  MPF_rev_gamma=0.9, MPF_rev_delta=1.0, out_amp=2.5,
                  noise_floor=0.001, out_only_noise=False,
                  out_only_mcra=False)
    model = PhasempfModel(engine(), geom(), PhasempfParams(**params))
    y = model.process(x, THETA)
    o = on.PhasempfOracle(AIRA3, HOP, FS, THETA, **params)
    assert_close(y, run_oracle(o, x, HOP))


MVDR_PARAMS = dict(past_windows=6, freq_mag_threshold=0.0008,
                   freq_max=16000.0, freq_min=100.0, out_amp=1.0)


def test_mvdr_parity():
    from beamform_tpu.config import MvdrParams
    x = scene(seconds=0.35, quiet_hops=8)
    model = MvdrModel(engine(), geom(), MvdrParams(**MVDR_PARAMS))
    y = model.process(x, THETA)
    o = on.MvdrOracle(AIRA3, HOP, FS, THETA, **MVDR_PARAMS)
    assert_close(y, run_oracle(o, x, HOP), atol=1e-7)


def test_lcmv_parity():
    from beamform_tpu.config import LcmvParams
    x = scene(seconds=0.35, quiet_hops=8)
    params = dict(past_windows=6, freq_mag_threshold=0.0008,
                  freq_max=16000.0, freq_min=100.0, out_amp=1.0)
    interf = (60.0, -75.0)
    model = LcmvModel(engine(), geom(), LcmvParams(**params),
                      interference_angles=interf)
    y = model.process(x, THETA)
    o = on.LcmvOracle(AIRA3, HOP, FS, THETA, interference_angles=interf,
                      **params)
    assert_close(y, run_oracle(o, x, HOP), atol=1e-7)


def test_gss_parity():
    from beamform_tpu.config import GssParams
    x = scene(seconds=0.35)
    params = dict(freq_mag_threshold=0.0008, freq_max=16000.0,
                  freq_min=100.0, out_amp=0.1, mu=0.001, lam=0.0)
    interf = (60.0,)
    model = GssModel(engine(), geom(), GssParams(**params),
                     interference_angles=interf)
    y = model.process(x, THETA)
    o = on.GssOracle(AIRA3, HOP, FS, THETA, interference_angles=interf,
                     freq_mag_threshold=params["freq_mag_threshold"],
                     freq_max=params["freq_max"], freq_min=params["freq_min"],
                     out_amp=params["out_amp"], mu=params["mu"],
                     lam=params["lam"])
    assert_close(y, run_oracle(o, x, HOP), atol=1e-8)


def test_gsc_parity():
    from beamform_tpu.config import GscParams
    x = scene(seconds=0.3)
    params = dict(use_vad=False, vad_threshold=0.1, mu0=0.0001, mu_max=0.1,
                  filter_size=32)
    model = GscModel(engine(), geom(), GscParams(**params))
    y = model.process(x, THETA)
    o = on.GscOracle(AIRA3, HOP, FS, THETA, **params)
    outs = [o.callback(x[:, k * HOP:(k + 1) * HOP])
            for k in range(x.shape[1] // HOP)]
    assert_close(y, np.concatenate(outs), atol=1e-9)


def test_ref_parity():
    x = scene()
    model = RefModel(engine(), geom())
    y = model.process(x)
    o = on.RefOracle(HOP)
    outs = [o.callback(x[:, k * HOP:(k + 1) * HOP])
            for k in range(x.shape[1] // HOP)]
    assert_close(y, np.concatenate(outs), atol=1e-12)
    # and it is the input delayed one hop
    np.testing.assert_allclose(np.asarray(y)[HOP:], x[0, :-HOP], atol=1e-9)


def test_read_parity():
    x = scene()
    x[:, 5 * HOP:6 * HOP] = 0.0  # an all-zero window exercises the carry
    model = ReadModel(engine(), geom())
    y = model.process(x)
    o = on.ReadOracle()
    outs = [o.callback(x[:, k * HOP:(k + 1) * HOP])
            for k in range(x.shape[1] // HOP)]
    assert_close(y, np.concatenate(outs), atol=1e-12)


def test_float32_within_baseline_tolerance():
    """The float32 compute path stays within the 1e-3 budget vs the f64
    oracle for the stateless models."""
    x = scene()
    e32 = EngineConfig(sample_rate=FS, window_size=HOP, dtype="float32")
    y = DasModel(e32, geom()).process(x, THETA)
    o = on.DasOracle(AIRA3, HOP, FS, THETA)
    ref = run_oracle(o, x, HOP)
    assert np.max(np.abs(np.asarray(y) - ref)) < 1e-3


def test_gsc_write_mu_trace(tmp_path):
    """The reference's ~/mu_behavior.txt trace: one mean-mu line per hop
    (gsc.cpp:181-184), faithful accumulate-or-overwrite fold."""
    from beamform_tpu.config import GscParams
    x = scene(seconds=0.1)
    params = dict(mu0=0.0001, mu_max=0.1, filter_size=16, write_mu=True)
    model = GscModel(engine(), geom(), GscParams(**params))
    model.mu_file_path = str(tmp_path / "mu.txt")
    y = model.process(x, THETA)
    lines = open(model.mu_file_path).read().strip().splitlines()
    assert len(lines) == x.shape[1] // HOP
    vals = [float(v) for v in lines]
    assert all(np.isfinite(v) for v in vals)
    assert any(v != 0 for v in vals)


def test_quirk_flags_change_output():
    """The corrected-behavior switches are live: exact freqs and a real DC
    bin produce different (finite) output from the faithful defaults."""
    x = scene(seconds=0.1)
    e_faithful = engine()
    e_exact = EngineConfig(sample_rate=FS, window_size=HOP, dtype="float64",
                           exact_freqs=True, bug_dc_zero=False)
    y0 = np.asarray(DasModel(e_faithful, geom()).process(x, THETA))
    y1 = np.asarray(DasModel(e_exact, geom()).process(x, THETA))
    assert np.isfinite(y1).all()
    assert np.max(np.abs(y0 - y1)) > 1e-9  # freq quirk affects DAS weights

    from beamform_tpu.config import McraParams
    m0 = McraModel(e_faithful, geom(), McraParams(L=10))
    m1 = McraModel(e_exact, geom(), McraParams(L=10))
    z0 = np.asarray(m0.process(x))
    z1 = np.asarray(m1.process(x))
    assert np.isfinite(z1).all()
    assert np.max(np.abs(z0 - z1)) > 1e-12  # DC bin now passes through


@pytest.mark.parametrize("name", ["das", "phase", "mcra", "phasempf",
                                  "mvdr", "lcmv", "gss", "gsc"])
def test_float32_deviation_budget(name):
    """<= 1e-3 max sample deviation vs the (f64) reference math for every
    beamformer on the float32 compute path."""
    x = scene(seconds=0.25, quiet_hops=8)
    e32 = EngineConfig(sample_rate=FS, window_size=HOP, dtype="float32")
    e64 = engine()
    params = {
        "das": {}, "phase": {},
        "mcra": dict(L=10, out_only_noise=False),
        "phasempf": dict(min_phase=30.0, min_mag=0.05, smooth_size=3,
                         MCRA_L=10),
        "mvdr": MVDR_PARAMS,
        "lcmv": dict(past_windows=6, freq_mag_threshold=0.0008,
                     freq_max=16000.0, freq_min=100.0, out_amp=1.0),
        "gss": dict(freq_mag_threshold=0.0008, freq_max=16000.0,
                    freq_min=100.0, out_amp=0.1, mu=0.001),
        "gsc": dict(mu0=0.0001, mu_max=0.1, filter_size=16),
    }[name]
    from beamform_tpu.config import parse_array_config
    doc = {f"mic{i}": {"id": i, "x": xx, "y": yy}
           for i, (xx, yy) in enumerate(AIRA3)}
    if name in ("lcmv", "gss"):
        doc["angle_interf1"] = 70.0
    cfg = parse_array_config(doc)
    y32 = np.asarray(get_model(name, e32, cfg, params).process(x, THETA))
    y64 = np.asarray(get_model(name, e64, cfg, params).process(x, THETA))
    dev = np.max(np.abs(y32 - y64))
    assert np.isfinite(y32).all()
    assert dev < 1e-3, dev


def test_gss_theta_timeline_parity():
    """Mid-stream /theta message: GSS resets its demixing matrices to A^H
    via update_weights (gss.cpp:90-93) — validated against the oracle."""
    from beamform_tpu.config import GssParams
    x = scene(seconds=0.3)
    t = x.shape[1] // HOP
    th = np.full(t, 10.0)
    th[t // 2:] = -50.0
    params = dict(freq_mag_threshold=0.0008, freq_max=16000.0,
                  freq_min=100.0, out_amp=0.1, mu=0.001, lam=0.0)
    interf = (70.0,)
    model = GssModel(engine(), geom(), GssParams(**params),
                     interference_angles=interf)
    y = model.process(x, th)

    o = on.GssOracle(AIRA3, HOP, FS, 10.0, interference_angles=interf,
                     freq_mag_threshold=params["freq_mag_threshold"],
                     freq_max=params["freq_max"], freq_min=params["freq_min"],
                     out_amp=params["out_amp"], mu=params["mu"],
                     lam=params["lam"])
    outs = []
    for k in range(t):
        if k == t // 2:
            o.set_theta(-50.0)
        outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
    assert_close(y, np.concatenate(outs), atol=1e-8)


def test_non_power_of_two_hop():
    """Arbitrary JACK buffer sizes: a non-power-of-two, non-128-multiple
    hop still matches the oracle."""
    hop = 120
    x = make_scene(AIRA3, seconds=0.1, theta_deg=THETA, hop=hop)
    e = EngineConfig(sample_rate=FS, window_size=hop, dtype="float64")
    y = DasModel(e, geom()).process(x, THETA)
    o = on.DasOracle(AIRA3, hop, FS, THETA)
    assert_close(y, run_oracle(o, x, hop))


def test_phasempf_theta_timeline_parity():
    """Mid-stream /theta through PhaseMPF: stateless weight change on top of
    the stateful MCRA/MPF recursions, vs the oracle."""
    from beamform_tpu.config import PhasempfParams
    x = scene(seconds=0.3)
    t = x.shape[1] // HOP
    th = np.full(t, 15.0)
    th[t // 2:] = -35.0
    params = dict(min_phase=30.0, min_mag=0.05, smooth_size=3, MCRA_L=10)
    model = PhasempfModel(engine(), geom(), PhasempfParams(**params))
    y = model.process(x, th)
    o = on.PhasempfOracle(AIRA3, HOP, FS, 15.0, **params)
    outs = []
    for k in range(t):
        if k == t // 2:
            o.set_theta(-35.0)
        outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
    assert_close(y, np.concatenate(outs))
