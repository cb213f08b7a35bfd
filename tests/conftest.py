"""Test configuration: CPU backend with a virtual 8-device mesh and x64.

Set before any jax import so the sharding tests can build a real
``jax.sharding.Mesh`` without accelerator hardware, and parity tests can
run the float64 path against the float64 NumPy oracle. Tests that need an
NVIDIA GPU carry the ``gpu`` marker and skip here; ``python chip_smoke.py``
runs what they cover on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from beamform_tpu.config import EngineConfig  # noqa: E402


# ---------------------------------------------------------------- quick tier
# `pytest -m quick` is the edit-loop tier: float64 oracle parity,
# WOLA/geometry/config/eval/DOA correctness — everything that adjudicates
# "is the math right" without the subprocess and multi-device tests. The
# full unmarked run stays the gate.
QUICK_MODULES = {
    "test_parity.py", "test_wola.py", "test_geometry.py", "test_doa.py",
    "test_evaluation.py", "test_timeline.py", "test_cli_config.py",
    "test_native.py", "test_profiling.py", "test_full_fft.py",
    "test_jack.py",
}
# slow individual tests inside otherwise-quick modules
SLOW_NAMES = {"test_float32_deviation_budget"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "quick: fast correctness tier (pytest -m quick)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (the "
                   "gpu_device fixture decides), chip_smoke.py runs it")


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = os.path.basename(item.nodeid.split("::")[0])
        name = item.nodeid.split("::")[-1].split("[")[0]
        if mod in QUICK_MODULES and name not in SLOW_NAMES:
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def gpu_device():
    """The first CUDA device, or a skip. Decided here, at run time, so
    every worker collects the same tests."""
    try:
        return jax.devices("cuda")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU; `python chip_smoke.py` runs this "
                    "check on the card")


@pytest.fixture
def engine64():
    """Small, fast engine config in float64 for oracle parity."""
    return EngineConfig(sample_rate=48000, window_size=128, dtype="float64")


@pytest.fixture
def engine32():
    return EngineConfig(sample_rate=48000, window_size=128, dtype="float32")


AIRA3 = [(0.0, 0.0), (0.0, -0.18), (-0.156, -0.09)]


@pytest.fixture
def aira3_xy():
    """The reference's active 3-mic geometry (beamform_config.yaml)."""
    return AIRA3


def make_scene(xy, fs=48000, seconds=0.5, theta_deg=20.0, seed=0,
               noise=0.01, quiet_hops=0, hop=128):
    """Synthesize a multichannel far-field scene: one wideband source at
    ``theta_deg`` hitting each mic with its geometric delay, plus noise.
    ``quiet_hops`` initial hops are attenuated (keeps MVDR/LCMV early
    covariances gated off, like a real fade-in)."""
    from beamform_tpu.geometry import ArrayGeometry, steering_delays
    rng = np.random.default_rng(seed)
    s = int(fs * seconds)
    src = rng.standard_normal(s + 256) * 0.3
    # mild lowpass so fractional delays interpolate cleanly
    k = np.hanning(9)
    k /= k.sum()
    src = np.convolve(src, k, mode="same")
    geom = ArrayGeometry.from_xy(xy)
    tau = np.asarray(steering_delays(geom, theta_deg))
    m = len(xy)
    out = np.zeros((m, s))
    t = np.arange(s)
    for i in range(m):
        d = tau[i] * fs
        i0 = int(np.floor(d))
        frac = d - i0
        idx = t + i0
        a = src[np.clip(idx, 0, len(src) - 1)]
        b = src[np.clip(idx + 1, 0, len(src) - 1)]
        out[i] = (1 - frac) * a + frac * b
    out += noise * rng.standard_normal(out.shape)
    if quiet_hops:
        out[:, :quiet_hops * hop] *= 1e-4
    # pad to hop multiple
    rem = (-s) % hop
    if rem:
        out = np.pad(out, ((0, 0), (0, rem)))
    return out


def cfg3(interf=()):
    """ArrayConfig of the 3-mic geometry, with optional interference
    angles (angle_interf1..)."""
    from beamform_tpu.config import parse_array_config
    doc = {f"mic{i}": {"id": i, "x": x, "y": y}
           for i, (x, y) in enumerate(AIRA3)}
    for k, a in enumerate(interf):
        doc[f"angle_interf{k + 1}"] = a
    return parse_array_config(doc)


def oracle_callbacks(oracle, x, hop, theta_frames=None):
    """Drive an oracle node callback by callback, delivering a /theta
    message whenever the per-frame angle changes."""
    outs = []
    for k in range(x.shape[1] // hop):
        if (theta_frames is not None and k
                and theta_frames[k] != theta_frames[k - 1]):
            oracle.set_theta(float(theta_frames[k]))
        outs.append(oracle.callback(x[:, k * hop:(k + 1) * hop]))
    return np.concatenate(outs)


@pytest.fixture
def scene3(aira3_xy):
    return make_scene(aira3_xy, seconds=0.25, theta_deg=25.0)
