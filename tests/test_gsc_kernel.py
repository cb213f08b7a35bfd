"""The GSC per-sample kernel (kernels/gsc_sample.py) against the scan.

The kernel runs here in Pallas interpret mode on the CPU; the model picks
it only when a program is lowered for CUDA, so on the CPU the model runs
the ``lax.scan`` route that the parity suite ties to the oracle. Agreement
is at float32 round-off: per sample only the order of the tap/channel sums
and of the output-power sum differs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from beamform_tpu.config import EngineConfig, GscParams
from beamform_tpu.kernels.gsc_sample import gsc_sample_pallas
from beamform_tpu.models import get_model
from beamform_tpu.models.gsc import (
    GscState, gsc_init_state, gsc_sample_scan)
from beamform_tpu.oracle import nodes as on

from conftest import AIRA3, cfg3, make_scene, oracle_callbacks

kernel = functools.partial(gsc_sample_pallas, interpret=True)


def streams(b, m, s, seed=0, scale=0.2):
    rng = np.random.default_rng(seed)
    return jnp.asarray((scale * rng.standard_normal((b, m, s)))
                       .astype(np.float32))


def state(b, m, k, seed=None):
    st = gsc_init_state(m, k, jnp.float32)
    st = jax.tree.map(lambda v: jnp.broadcast_to(v, (b,) + v.shape), st)
    if seed is None:
        return st
    rng = np.random.default_rng(seed)
    return GscState(*(jnp.asarray((0.05 * rng.standard_normal(v.shape))
                                  .astype(np.float32)) for v in st))


def assert_matches(res_k, res_s, atol=2e-6):
    out_k, blk, flt, lo = res_k
    out_s, st_s = res_s
    np.testing.assert_allclose(np.asarray(out_k), np.asarray(out_s),
                               atol=atol)
    np.testing.assert_allclose(np.asarray(flt), np.asarray(st_s.filt),
                               atol=atol)
    np.testing.assert_array_equal(np.asarray(blk), np.asarray(st_s.block))
    np.testing.assert_allclose(np.asarray(lo), np.asarray(st_s.last_out),
                               atol=atol)


@pytest.mark.parametrize("use_vad", [False, True])
def test_kernel_matches_scan(use_vad):
    p = GscParams(mu0=0.0005, mu_max=0.05, filter_size=128,
                  use_vad=use_vad, vad_threshold=0.15)
    a, st = streams(1, 4, 512), state(1, 4, 128, seed=1)
    assert_matches(kernel(a, *st, p), gsc_sample_scan(a, st, p))


def test_kernel_state_continuity():
    """Two calls chain the state exactly like one long call: the blocking
    registers, the filters and the output ring (rotated to oldest-first
    between calls, here after 300 samples, not a multiple of K)."""
    p = GscParams(mu0=0.001, mu_max=0.05, filter_size=128)
    a, st = streams(1, 3, 700, seed=2), state(1, 3, 128)
    full = kernel(a, *st, p)
    y1, *st1 = kernel(a[..., :300], *st, p)
    y2, *st2 = kernel(a[..., 300:], *st1, p)
    np.testing.assert_allclose(np.concatenate([y1, y2], axis=1),
                               np.asarray(full[0]), atol=1e-6)
    for got, want in zip(st2, full[1:]):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-6)


def test_kernel_batch_matches_single_streams():
    """Streams ride the grid: each program sees only its own stream."""
    p = GscParams(mu0=0.0005, mu_max=0.05, filter_size=64)
    a, st = streams(3, 5, 256, seed=3), state(3, 5, 64, seed=4)
    out = kernel(a, *st, p)
    for i in range(3):
        one = kernel(a[i:i + 1], *(v[i:i + 1] for v in st), p)
        np.testing.assert_allclose(np.asarray(out[0][i]),
                                   np.asarray(one[0][0]), atol=1e-7)


@pytest.mark.parametrize("m,k", [(3, 24), (6, 128), (17, 32)])
def test_kernel_pads_channels_and_taps(m, k):
    """Channel counts and filter lengths that are not powers of two are
    padded to Triton block sizes; the padded lanes must not leak into the
    sums (24 taps ride a 32-lane block, 16 channels a 16-row block)."""
    p = GscParams(mu0=0.001, mu_max=0.05, filter_size=k)
    a, st = streams(2, m, 200, seed=m), state(2, m, k, seed=k)
    assert_matches(kernel(a, *st, p), gsc_sample_scan(a, st, p))


def test_kernel_cold_start_scrubs_inf():
    """All-zero lead-in: the power sums are 0, mu hits the inf-scrub path
    (gsc.cpp:158-168) and the output stays finite, as on the scan."""
    p = GscParams(mu0=0.001, mu_max=0.05, filter_size=128)
    a = np.zeros((1, 3, 384), np.float32)
    a[..., 256:] = 0.2 * np.random.default_rng(5).standard_normal((1, 3, 128))
    a, st = jnp.asarray(a), state(1, 3, 128)
    res = kernel(a, *st, p)
    assert np.isfinite(np.asarray(res[0])).all()
    assert_matches(res, gsc_sample_scan(a, st, p))


def test_model_off_gpu_runs_the_scan():
    """On the CPU the float32 model's adaptive stage is the scan route."""
    engine = EngineConfig(sample_rate=48000, window_size=128,
                          dtype="float32")
    params = dict(mu0=0.0001, mu_max=0.1, filter_size=32)
    model = get_model("gsc", engine, cfg3(), params)
    x = make_scene(AIRA3, seconds=0.05, hop=128)
    out, (_, gst) = model.process_chunk(x, 20.0, model.stream_init())
    carry, g0 = model.stream_init()
    uniq, idx = model._theta_ctrl(20.0, x.shape[1] // 128)
    aligned, _ = model.aligned_streams(jnp.asarray(x, jnp.float32), uniq,
                                       idx, carry)
    want, st = gsc_sample_scan(aligned[None],
                               jax.tree.map(lambda v: v[None], g0),
                               model.params)
    # one jitted program vs stage 1 and the scan jitted apart: the same
    # arithmetic, fused differently
    np.testing.assert_allclose(np.asarray(out), np.asarray(want[0]),
                               atol=1e-6)


def test_gsc_float32_matches_oracle_at_128_taps():
    """The deployed filter length, float32 against the float64 oracle."""
    engine = EngineConfig(sample_rate=48000, window_size=128,
                          dtype="float32")
    params = dict(mu0=0.0001, mu_max=0.1, filter_size=128)
    x = make_scene(AIRA3, seconds=0.2, hop=128)
    y = np.asarray(get_model("gsc", engine, cfg3(), params).process(x, 20.0))
    ref = oracle_callbacks(on.GscOracle(AIRA3, 128, 48000, 20.0, **params),
                           x, 128)
    assert np.max(np.abs(y - ref)) < 1e-3


@pytest.mark.gpu
def test_kernel_on_gpu_matches_scan(gpu_device):
    """The Triton-compiled kernel on the card against the scan on the
    card (chip_smoke.py phase 5 runs this at 16 mics and 30 s)."""
    p = GscParams(mu0=0.0001, mu_max=0.1, filter_size=128)
    a = jax.device_put(streams(2, 16, 4096, seed=7), gpu_device)
    st = jax.device_put(state(2, 16, 128), gpu_device)
    assert_matches(jax.jit(functools.partial(gsc_sample_pallas, params=p))(
        a, *st), jax.jit(functools.partial(gsc_sample_scan, p=p))(a, st),
        atol=1e-5)
