"""Smoke test of the main path on an NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py            # one card: phases 1-5 below
    python chip_smoke.py --four     # four cards: the multi-card path only

Phases (one card):

1. Device: JAX's first device must be a GPU; the card's name and power
   limit as nvidia-smi reports them.
2. The ten nodes at full width: the 16-mic AIRA array
   (configs/aira16.yaml), 48 kHz, hop 1024, float32, the launch presets
   (configs/launch_params.yaml; GSC without the host-side mu trace file),
   through ``get_model(...).process``. Per node: output shape, finite
   values, the max absolute sample deviation from the float64 oracle
   (beamform_tpu/oracle) on the first 48 hops and from the node's own
   float64 run on the CPU over the whole timed length (budget 1e-3 each,
   the repo's float32 budget), the compile seconds and the xRT (audio
   seconds per wall second) of one timed run after compile.
3. The CLI: a 16-channel WAV through ``beamform-tpu das`` and back.
4. ``BatchRunner`` at batch 8 for das and mvdr against single streams.
5. The GSC per-sample kernel (kernels/gsc_sample.py) against the
   ``lax.scan`` route on the card: outputs and xRT, single stream and
   batch 32, for the adaptive stage alone and for the whole node.

With ``--four``: ``sharded_batched_step`` for das, mvdr and gsc over a
(stream, bin) = (4, 1) mesh of four cards against the single-card run.

Any failure exits non-zero; without a GPU nothing is measured. The last
line of standard output is one JSON object with the device JAX reports.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import tempfile
import time

import numpy as np

FS = 48000
HOP = 1024
THETA = 20.0            # steering angle = the target's DOA
INTERFERER = 70.0       # second source; LCMV and GSS constrain it
ORACLE_HOPS = 48        # 1.024 s compared with the float64 oracle
BUDGET = 1e-3           # max |float32 - float64| per sample
NODES = ("das", "mvdr", "lcmv", "gsc", "gss", "phase", "phasempf", "mcra",
         "ref", "read")
# Both GSC routes run in float32 on the same card and see the same inputs;
# per step they differ only in the order of the tap/channel sums and of
# the K-sample output power (a register ring instead of a shifted window),
# i.e. in float32 round-off, which the step-size-normalised LMS update does
# not amplify. 1e-5 is ~100x that round-off at the output's scale.
KERNEL_VS_SCAN = 1e-5

FAILURES: list = []


def check(label: str, ok: bool, detail: str = "") -> None:
    print(f"  {label}: {'ok' if ok else 'FAIL'} {detail}".rstrip(),
          flush=True)
    if not ok:
        FAILURES.append(label)


def within(label: str, dev: float, budget: float) -> None:
    check(label, bool(np.isfinite(dev) and dev <= budget),
          f"max|dev| {dev:.3e} (budget {budget:.0e})")


def timed(fn, *args):
    """(result, seconds) of one call, waited for on the device."""
    import jax
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def array_config(interferences=()):
    import dataclasses
    import beamform_tpu
    from beamform_tpu.config import load_array_config
    cfg = load_array_config(os.path.join(
        beamform_tpu.__path__[0], "configs", "aira16.yaml"))
    return dataclasses.replace(cfg, interference_angles=tuple(interferences))


def node_params(node: str) -> dict:
    from beamform_tpu.config import load_launch_params
    params = load_launch_params(node)
    if node == "gsc":
        params["write_mu"] = False       # the trace is a host-side file log
    return params


def make_scene(seconds: float, seed: int) -> np.ndarray:
    """(16, S) float32: a band-limited source at THETA and one at
    INTERFERER with exact far-field delays, sensor noise, and 12 quiet hops
    first (a cold covariance is singular; MVDR/LCMV gate it off)."""
    from beamform_tpu.evaluation import synth_scene
    from beamform_tpu.geometry import ArrayGeometry
    geom = ArrayGeometry.from_config(array_config())
    rng = np.random.default_rng(seed)
    n = int(seconds * FS) // HOP * HOP
    f = np.fft.rfftfreq(n, 1.0 / FS)
    srcs = []
    for level in (0.1, 0.05):
        spec = np.fft.rfft(rng.standard_normal(n)) * ((f > 200) & (f < 8000))
        s = np.fft.irfft(spec, n=n)
        srcs.append(level * s / np.std(s))
    scene = synth_scene(geom, srcs, [THETA, INTERFERER], FS,
                        noise_std=0.01, seed=seed, delay="spectral")
    x = scene.mixture
    x[:, :12 * HOP] *= 1e-4
    return x.astype(np.float32)


def oracle_for(node: str, cfg, params: dict):
    from beamform_tpu.oracle import nodes as on
    xy = [(m.x, m.y) for m in cfg.mics]
    cls = {"das": on.DasOracle, "mvdr": on.MvdrOracle,
           "lcmv": on.LcmvOracle, "gsc": on.GscOracle, "gss": on.GssOracle,
           "phase": on.PhaseOracle, "phasempf": on.PhasempfOracle,
           "mcra": on.McraOracle, "ref": on.RefOracle,
           "read": on.ReadOracle}[node]
    params = dict(params)
    if "lambda" in params:
        params["lam"] = params.pop("lambda")
    sig = inspect.signature(cls.__init__).parameters
    kw = {k: v for k, v in params.items() if k in sig}
    if "interference_angles" in sig:
        kw["interference_angles"] = cfg.interference_angles
    if node == "ref":
        return cls(HOP)
    if node == "read":
        return cls()
    if "theta" in sig:
        return cls(xy, HOP, FS, THETA, **kw)
    return cls(xy, HOP, FS, **kw)


def run_oracle(oracle, x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    return np.concatenate([oracle.callback(x[:, i * HOP:(i + 1) * HOP])
                           for i in range(x.shape[1] // HOP)])


def cpu_float64(node: str, cfg, params: dict, x: np.ndarray) -> np.ndarray:
    """The node's own float64 run on the CPU (tests/test_parity.py ties
    this route to the oracle at <= 1e-9)."""
    import jax
    from beamform_tpu.config import EngineConfig
    from beamform_tpu.models import get_model
    engine = EngineConfig(sample_rate=FS, window_size=HOP, dtype="float64")
    with jax.default_device(jax.devices("cpu")[0]), jax.enable_x64(True):
        model = get_model(node, engine, cfg, params)
        return np.asarray(model.process(x.astype(np.float64), THETA))


def phase_nodes(seconds: float, seed: int) -> None:
    import jax
    from beamform_tpu.config import EngineConfig
    from beamform_tpu.models import get_model
    print(f"phase 2: ten nodes, 16 mics, {FS} Hz, hop {HOP}, float32, "
          f"{seconds:g} s", flush=True)
    engine = EngineConfig(sample_rate=FS, window_size=HOP, dtype="float32")
    x = make_scene(seconds, seed)
    audio_s = x.shape[1] / FS
    xd = jax.device_put(x)
    n_or = ORACLE_HOPS * HOP
    for node in NODES:
        cfg = array_config((INTERFERER,) if node in ("lcmv", "gss") else ())
        params = node_params(node)
        model = get_model(node, engine, cfg, params)
        try:
            y, compile_s = timed(model.process, xd, THETA)
            y, run_s = timed(model.process, xd, THETA)
            y = np.asarray(y)
            check(f"{node} shape", y.shape == (x.shape[1],), str(y.shape))
            check(f"{node} finite", bool(np.isfinite(y).all()))
            ref = run_oracle(oracle_for(node, cfg, params), x[:, :n_or])
            within(f"{node} vs float64 oracle ({n_or / FS:.3f} s)",
                   float(np.max(np.abs(y[:n_or] - ref))), BUDGET)
            y64 = cpu_float64(node, cfg, params, x)
            within(f"{node} vs own float64 CPU run ({audio_s:g} s)",
                   float(np.max(np.abs(y - y64))), BUDGET)
            print(f"  {node}: compile+first run {compile_s:.2f} s, timed run "
                  f"{run_s:.4f} s, xRT {audio_s / run_s:.2f}", flush=True)
        except Exception as e:  # recorded; the run exits non-zero
            check(f"{node} ran", False, f"{type(e).__name__}: {e}")


def phase_cli(seed: int) -> None:
    from beamform_tpu.runtime import wav as wav_io
    from beamform_tpu.runtime.cli import main as cli_main
    from beamform_tpu.config import EngineConfig
    from beamform_tpu.models import get_model
    print("phase 3: CLI WAV round trip (das)", flush=True)
    x = make_scene(2.0, seed + 1)
    import beamform_tpu
    cfg_path = os.path.join(beamform_tpu.__path__[0], "configs",
                            "aira16.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        wav_in = os.path.join(tmp, "mics.wav")
        wav_out = os.path.join(tmp, "out.wav")
        wav_io.write_wav(wav_in, x, FS, fmt="float32")
        rc = cli_main(["das", "--in", wav_in, "--out", wav_out,
                       "--array-config", cfg_path, "--theta", str(THETA),
                       "--log-level", "error"])
        check("cli exit code", rc == 0, f"rc={rc}")
        y, fs = wav_io.read_wav(wav_out)
    engine = EngineConfig(sample_rate=FS, window_size=HOP, dtype="float32")
    want = np.asarray(get_model("das", engine, array_config(), {}).process(
        x, THETA))
    got = y[0]
    check("cli output shape", got.shape == want.shape and fs == FS,
          f"{got.shape} at {fs} Hz")
    # the output is 16-bit PCM: one quantisation step of headroom
    within("cli output vs das.process", float(np.max(np.abs(got - want))),
           2.0 / 32767)


def phase_batch(seed: int) -> None:
    import jax
    from beamform_tpu.config import EngineConfig
    from beamform_tpu.models import get_model
    from beamform_tpu.runtime.batch import BatchRunner
    print("phase 4: BatchRunner, batch 8", flush=True)
    engine = EngineConfig(sample_rate=FS, window_size=HOP, dtype="float32")
    b, chunk = 8, 2 * FS // HOP * HOP
    xs = np.stack([make_scene(4.0, seed + 10 + i) for i in range(b)])
    n = xs.shape[-1] // chunk * chunk
    thetas = np.linspace(-60.0, 60.0, b)
    for node in ("das", "mvdr"):
        params = node_params(node)
        runner = BatchRunner(node, engine, array_config(), params, batch=b)
        outs = [runner.process(xs[..., i:i + chunk], thetas)
                for i in range(0, n, chunk)]
        yb = np.concatenate([np.asarray(o) for o in outs], axis=1)
        model = get_model(node, engine, array_config(), params)
        dev = max(float(np.max(np.abs(
            yb[i] - np.asarray(model.process(xs[i, :, :n], thetas[i])))))
            for i in range(b))
        # both float32 on the card; the batched program may fuse and
        # reduce in another order
        within(f"{node} batch 8 vs single streams", dev, 1e-4)
        runner = BatchRunner(node, engine, array_config(), params, batch=b)
        xd = jax.device_put(xs[..., :chunk])
        runner.process(xd, thetas).block_until_ready()
        _, dt = timed(runner.process, xd, thetas)
        print(f"  {node} batch 8: aggregate xRT {b * chunk / FS / dt:.2f}",
              flush=True)


def phase_gsc_kernel(seconds: float, seed: int) -> None:
    import jax
    import jax.numpy as jnp
    from beamform_tpu.config import EngineConfig, make_params
    from beamform_tpu.kernels.gsc_sample import gsc_sample_pallas
    from beamform_tpu.models import common, get_model
    from beamform_tpu.models.gsc import GscState, gsc_sample_scan
    print(f"phase 5: GSC kernel vs scan, 16 mics, {seconds:g} s", flush=True)
    engine = EngineConfig(sample_rate=FS, window_size=HOP, dtype="float32")
    params = node_params("gsc")
    p = make_params("gsc", params)
    model = get_model("gsc", engine, array_config(), params)
    x = jax.device_put(make_scene(seconds, seed + 2))
    t = x.shape[1] // HOP
    uniq, idx = common.unique_thetas(common.theta_per_frame(THETA, t))
    carry, g0 = model.stream_init()
    aligned, _ = jax.jit(model.aligned_streams)(x, uniq, idx, carry)

    def kernel(a, st):
        out, *new = gsc_sample_pallas(a, st.block, st.filt, st.last_out, p)
        return out, GscState(*new)

    def scan(a, st):
        return gsc_sample_scan(a, st, p)

    def whole(stage2):
        def fn(xx):
            al, _ = model.aligned_streams(xx, uniq, idx, carry)
            return stage2(al[None], jax.tree.map(lambda v: v[None], g0))[0]
        return jax.jit(fn)

    audio_s = x.shape[1] / FS
    for b in (1, 32):
        # batch 32: the same aligned streams, each circularly shifted and
        # scaled, so every stream adapts on its own input
        ab = jnp.stack([jnp.roll(aligned, 997 * i, axis=-1) * (1 + 0.01 * i)
                        for i in range(b)])
        st = jax.tree.map(lambda v: jnp.broadcast_to(v, (b,) + v.shape), g0)
        res = {}
        for name, fn in (("kernel", kernel), ("scan", scan)):
            jf = jax.jit(fn)
            (out, _), compile_s = timed(jf, ab, st)
            (out, _), run_s = timed(jf, ab, st)
            res[name] = np.asarray(out)
            print(f"  adaptive stage, batch {b}, {name}: compile+first run "
                  f"{compile_s:.2f} s, timed {run_s:.4f} s, aggregate xRT "
                  f"{b * audio_s / run_s:.2f}", flush=True)
        within(f"gsc kernel vs scan, batch {b}",
               float(np.max(np.abs(res["kernel"] - res["scan"]))),
               KERNEL_VS_SCAN)
    for name, fn in (("kernel", kernel), ("scan", scan)):
        jf = whole(fn)
        _, compile_s = timed(jf, x)
        _, run_s = timed(jf, x)
        print(f"  whole gsc node, single stream, {name}: xRT "
              f"{audio_s / run_s:.2f} (compile+first run {compile_s:.2f} s)",
              flush=True)


def phase_four(seconds: float, seed: int) -> None:
    import jax
    from beamform_tpu.config import EngineConfig
    from beamform_tpu.models import get_model
    from beamform_tpu.parallel.mesh import make_mesh
    from beamform_tpu.parallel.sharded import (sharded_batched_step,
                                               sharded_state_init)
    n_dev = len(jax.devices())
    check("four cards", n_dev == 4, f"{n_dev} devices")
    if n_dev != 4:
        return
    mesh = make_mesh(4)
    print(f"four cards: mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}"
          f", {seconds:g} s per stream", flush=True)
    engine = EngineConfig(sample_rate=FS, window_size=HOP, dtype="float32")
    b = 8
    xs = np.stack([make_scene(seconds, seed + 20 + i) for i in range(b)])
    thetas = np.linspace(-60.0, 60.0, b)
    for node in ("das", "mvdr", "gsc"):
        params = node_params(node)
        model = get_model(node, engine, array_config(), params)
        state = sharded_state_init(mesh, model, b)
        out, _ = sharded_batched_step(mesh, model, xs, thetas, state)
        out = np.asarray(out)
        one = np.stack([np.asarray(model.process(xs[i], thetas[i]))
                        for i in range(b)])
        # float32 on both sides; the sharded program may fuse and reduce
        # in another order (the same bound as phase 4's batch check)
        within(f"{node} on 4 cards vs 1 card",
               float(np.max(np.abs(out - one))), 1e-4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-card path (needs 4 cards)")
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="timed audio length per node")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    from beamform_tpu.utils.compile_cache import enable_compile_cache
    from beamform_tpu.utils.profiling import (card_name_and_power_limit,
                                              require_gpu)
    dev = require_gpu()                  # exits non-zero without a GPU
    enable_compile_cache()
    card = card_name_and_power_limit()
    print(f"phase 1: {dev.platform} {dev.device_kind} x{len(jax.devices())};"
          f" card: {card}", flush=True)

    t0 = time.perf_counter()
    if args.four:
        phase_four(min(args.seconds, 4.0), args.seed)
    else:
        phase_nodes(args.seconds, args.seed)
        phase_cli(args.seed)
        phase_batch(args.seed)
        phase_gsc_kernel(args.seconds, args.seed)
    print(f"wall {time.perf_counter() - t0:.1f} s", flush=True)
    if FAILURES:
        print(f"FAILED: {', '.join(FAILURES)}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
