"""Command-line interface: the launch-file equivalent.

One subcommand per reference node (das, mvdr, gsc, lcmv, gss, phase,
phasempf, mcra, ref, read — CMakeLists.txt:53-63), reading the same two YAML
config schemas the reference loads via roslaunch plus per-node parameter
overrides (the inline <rosparam> blocks in launch/*.launch).

Offline semantics: input WAV in, processed WAV out, with the rosjack output
policy applied (16-bit PCM writer, optional output resampling —
rosjack.cpp:159-210), and an xRT (audio-seconds per wall-second) report, the
framework's replacement for the reference's per-callback latency printouts
(util.h:13-17).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from beamform_tpu.config import (
    EngineConfig,
    PARAM_CLASSES,
    load_array_config,
    load_rosjack_config,
    parse_array_config,
)
from beamform_tpu.models import get_model
from beamform_tpu.runtime import wav as wav_io
from beamform_tpu.runtime.resample import resample

NODES = tuple(PARAM_CLASSES.keys()) + ("write",)


def _parse_value(v: str):
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def build_parser():
    p = argparse.ArgumentParser(
        prog="beamform-tpu",
        description="Multichannel beamforming in JAX (capabilities of "
                    "balkce/beamform, re-designed for JAX/XLA)")
    p.add_argument("node", choices=NODES, help="beamformer / node to run")
    p.add_argument("--in", dest="input", default=None,
                   help="multichannel input WAV (one channel per mic); "
                        "omit with --live")
    p.add_argument("--live", action="store_true",
                   help="live pipe mode (the JACK-client role): read raw "
                        "interleaved float32 PCM from stdin, write processed "
                        "float32 PCM to stdout, e.g. "
                        "arecord -f FLOAT_LE -c3 | beamform-tpu das --live "
                        "--live-channels 3 | aplay -f FLOAT_LE")
    p.add_argument("--live-channels", type=int, default=None,
                   help="input channel count for --live (default: mic count "
                        "from the array config)")
    p.add_argument("--live-rate", type=int, default=48000,
                   help="sample rate for --live")
    p.add_argument("--live-overrun", choices=("block", "drop"),
                   default="block",
                   help="live-input overload policy: 'block' applies "
                        "backpressure through the pipe; 'drop' sheds "
                        "backlogged chunks like a JACK xrun (silence out, "
                        "counted in the report) and only processes the "
                        "freshest audio")
    p.add_argument("--live-chunk", type=int, default=4,
                   help="hops per processing chunk in --live mode (latency "
                        "vs throughput)")
    p.add_argument("--device", default=None,
                   help="with --live: capture/play through this ALSA PCM "
                        "(e.g. 'default', 'hw:0') in-process instead of "
                        "stdin/stdout pipes — the reference's JACK-client "
                        "role (rosjack.cpp:102-157,234-270). Degrades with "
                        "a clear error when no sound stack exists.")
    p.add_argument("--device-out", default=None,
                   help="separate ALSA PCM for playback (default: same as "
                        "--device)")
    p.add_argument("--jack", nargs="?", const="beamform_tpu", default=None,
                   metavar="CLIENT_NAME",
                   help="with --live: join an existing JACK graph as a "
                        "client under this name (default 'beamform_tpu') — "
                        "the literal rosjack role: input_N/output ports, "
                        "physical-port auto-connect, engine at the server "
                        "rate (rosjack.cpp:98-157,234-270). Binds libjack "
                        "at runtime; degrades with a clear error when no "
                        "JACK server exists.")
    p.add_argument("--jack-no-autoconnect", action="store_true",
                   help="register JACK ports but do not auto-connect to the "
                        "physical capture/playback ports (the reference's "
                        "auto_connect:=false launch arg)")
    p.add_argument("--max-chunks", type=int, default=0, metavar="N",
                   help="stop the --live loop after N chunks (0 = run until "
                        "EOF/Ctrl-C); bounds device/JACK sessions")
    p.add_argument("--out", dest="output", default=None,
                   help="output WAV path (default: rosjack write_file_path "
                        "or <in>.<node>.wav)")
    p.add_argument("--array-config", default=None,
                   help="beamform_config.yaml (mic geometry, initial angle, "
                        "interferences)")
    p.add_argument("--rosjack-config", default=None,
                   help="rosjack_config.yaml (output policy, sample rate)")
    p.add_argument("--theta", type=float, default=None,
                   help="steering angle in degrees (default: config "
                        "initial_angle)")
    p.add_argument("--theta-timeline", default=None,
                   help="CSV/JSON file of per-frame angles, or "
                        "'t0:a0,t1:a1,...' second:angle change points")
    p.add_argument("--window-size", type=int, default=1024,
                   help="hop size in samples (JACK buffer size equivalent)")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32")
    p.add_argument("--log-level", choices=("debug", "info", "warning",
                                           "error"), default="warning",
                   help="console log level; 'warning' (default) prints the "
                        "reference-style warn-and-default line for every "
                        "parameter not supplied (mvdr.cpp:150-186 pattern), "
                        "'info' also echoes supplied parameters")
    p.add_argument("--param", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="node hyperparameter override (repeatable), e.g. "
                        "--param freq_max=16000")
    p.add_argument("--launch-preset", choices=("on", "off"), default="on",
                   help="start from the reference's launch/*.launch "
                        "per-node parameters (configs/launch_params.yaml), "
                        "then apply --param overrides; 'off' starts from "
                        "the in-code node defaults instead (default: on)")
    p.add_argument("--out-format", choices=("pcm16", "pcm24", "pcm32",
                                            "float32"), default="pcm16")
    p.add_argument("--report-json", action="store_true",
                   help="print a one-line JSON run report to stdout")
    p.add_argument("--interference-events", default=None,
                   metavar="SPEC",
                   help="lcmv/gss: 'sec:id:angle,...' interference messages "
                        "(the /theta_interference protocol); initial set "
                        "comes from angle_interfN in the array config")
    p.add_argument("--theta-control", default=None, metavar="PATH",
                   help="live steering side channel (the /theta topic, "
                        "das.cpp:94-99): a file polled at every chunk "
                        "boundary whose last line is the new angle in "
                        "degrees; works in --live and --stream modes. "
                        "Takes precedence over --theta-timeline from the "
                        "first chunk where the file provides an angle")
    p.add_argument("--interf-control", default=None, metavar="PATH",
                   help="lcmv/gss live interference side channel (the "
                        "/theta_interference topic, lcmv.cpp:258-309): a "
                        "file polled at every chunk boundary; each appended "
                        "'id:angle' line is one InterfTheta message "
                        "(add/move/remove semantics); works in --live and "
                        "--stream modes")
    p.add_argument("--consumer-lead", type=int, default=0, metavar="N",
                   help="write node: audio callbacks that fire before the "
                        "first message arrives (each plays one window of "
                        "silence — the decoupling lag, jack_write.cpp:7-10)")
    p.add_argument("--stream", type=int, default=None, metavar="FRAMES",
                   help="process in streaming chunks of FRAMES hops "
                        "(fixed-shape compiled step, O(1) memory) instead "
                        "of one batch call; reports xruns")
    p.add_argument("--save-state", default=None,
                   help="checkpoint the streaming state to this .npz at end")
    p.add_argument("--load-state", default=None,
                   help="resume streaming state from a .npz checkpoint")
    return p


def theta_from_spec(spec: str, num_frames: int, hop: int, fs: int,
                    initial: float) -> np.ndarray:
    """Change-point spec 'sec:angle,...' -> per-frame timeline."""
    th = np.full(num_frames, initial, dtype=np.float64)
    if spec.endswith((".json", ".csv")):
        if spec.endswith(".json"):
            with open(spec) as f:
                vals = np.asarray(json.load(f), dtype=np.float64).ravel()
        else:
            vals = np.loadtxt(spec, delimiter=",", dtype=np.float64).ravel()
        if len(vals) == 0:
            return th
        if len(vals) > num_frames:   # longer file: extra angles are unused
            print(f"note: theta timeline has {len(vals)} frames, stream has "
                  f"{num_frames}; ignoring the tail", file=sys.stderr)
            return vals[:num_frames]
        if len(vals) < num_frames:   # shorter file: last angle holds
            vals = np.concatenate(
                [vals, np.full(num_frames - len(vals), vals[-1])])
        return vals
    for item in spec.split(","):
        t_s, a = item.split(":")
        frame = int(float(t_s) * fs / hop)
        th[min(frame, num_frames - 1):] = float(a)
    return th


def _node_params(args) -> dict:
    """Launch preset (the reference's launch/*.launch values, on by
    default) overlaid with --param KEY=VALUE overrides."""
    params = {}
    if args.launch_preset == "on":
        from beamform_tpu.config import load_launch_params
        params = load_launch_params(args.node)
    for kv in args.param:
        k, v = kv.split("=", 1)
        params[k] = _parse_value(v)
    return params


def _read_theta(path: str):
    """Live /theta side channel: the last non-empty line of ``path`` is the
    steering angle in degrees (theta_roscallback, das.cpp:94-99). Returns
    None when the file is absent, empty or unparsable — callers keep their
    current angle (and --theta-timeline keeps driving until the control
    file first provides a value)."""
    try:
        with open(path) as f:
            lines = [ln.strip() for ln in f.read().splitlines() if ln.strip()]
        if lines:
            return float(lines[-1])
    except (OSError, ValueError):
        pass
    return None


def _poll_theta(path: str, current: float) -> float:
    v = _read_theta(path)
    return current if v is None else v


class _InterfControlFile:
    """Live /theta_interference side channel: a file where each appended
    ``id:angle`` line is one InterfTheta message. Polled at chunk
    boundaries; lines already consumed are skipped (the file is
    append-only, like a topic log). Malformed lines are ignored with a
    warning, consuming them."""

    def __init__(self, path: str, machine):
        self.path = path
        self.machine = machine            # runtime.timeline.InterferenceMachine
        self._consumed = 0

    def poll(self) -> bool:
        """Apply newly appended messages; True when any triggered
        update_weights (the GSS demix-reset signal)."""
        try:
            with open(self.path) as f:
                lines = [ln.strip() for ln in f.read().splitlines()
                         if ln.strip()]
        except OSError:
            return False
        new, self._consumed = lines[self._consumed:], len(lines)
        any_reset = False
        for ln in new:
            try:
                iid, ang = ln.split(":")
                any_reset |= self.machine.apply(int(iid), float(ang))
            except ValueError:
                print(f"warning: ignoring malformed interference-control "
                      f"line {ln!r} (want 'id:angle')", file=sys.stderr)
        return any_reset


def run_write(args) -> int:
    """The rosjack_write playback node: play a processed stream through the
    reference's 50-window decoupling buffer (jack_write.cpp:7-10,
    rosjack.cpp:549-577). File mode replays message/callback pairs; --live
    decouples a stdin producer from a wall-clock-paced stdout consumer."""
    from beamform_tpu.runtime.playback import Ros2JackBuffer, play_stream

    hop = args.window_size
    if args.live:
        import threading
        import time as _time

        fs = args.live_rate
        buf = Ros2JackBuffer(hop)
        lock = threading.Lock()
        eof = threading.Event()

        def producer():
            stdin = sys.stdin.buffer
            while True:
                raw = stdin.read(4 * hop)
                if not raw:
                    break
                msg = np.frombuffer(raw, dtype="<f4")
                with lock:
                    buf.push(msg)
            eof.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        stdout = sys.stdout.buffer
        period = hop / fs
        next_t = _time.perf_counter()
        while not (eof.is_set() and buf.popped >= buf.pushed):
            next_t += period
            delay = next_t - _time.perf_counter()
            if delay > 0:
                _time.sleep(delay)
            with lock:
                out = buf.pop(hop)
            stdout.write(out.astype("<f4").tobytes())
            stdout.flush()
        report = {"underruns": getattr(buf, "underruns", 0),
                  "overwrites": getattr(buf, "overwrites", 0)}
        print(json.dumps({"write": report}), file=sys.stderr)
        return 0

    if args.input is None:
        print("error: write needs --in (or --live)", file=sys.stderr)
        return 2
    x, fs = wav_io.read_wav(args.input)
    mono = x[0] if x.ndim == 2 else x    # the jackaudio topic is mono
    pad = (-len(mono)) % hop
    mono = np.pad(mono, (0, pad))
    windows = mono.reshape(-1, hop)
    y = play_stream(windows, hop, consumer_lead=args.consumer_lead)
    out_path = args.output or (args.input + ".write.wav")
    try:
        wav_io.write_wav(out_path, y[None, :], fs, fmt=args.out_format)
    except OSError as e:
        print(f"warning: could not open '{out_path}' ({e}); continuing "
              "without file output", file=sys.stderr)
    if args.report_json:
        print(json.dumps({"node": "write", "samples_in": int(x.shape[-1]),
                          "samples_out": int(len(y)),
                          "consumer_lead": args.consumer_lead}))
    return 0


def run_live(args) -> int:
    """Live pipe mode: the framework's stand-in for the reference's JACK
    client loop (rosjack_create + jack_callback). Raw interleaved float32
    PCM flows stdin -> beamformer -> stdout in fixed hop-chunks; per-chunk
    deadline misses are counted like JACK xruns (rosjack.cpp:78-82)."""
    import numpy as np

    from beamform_tpu.runtime.streaming import StreamingSession

    if args.array_config:
        array_cfg = load_array_config(args.array_config)
    else:
        ch = args.live_channels or 1
        array_cfg = parse_array_config(
            {f"mic{i}": {"id": i, "x": 0.0, "y": 0.0} for i in range(ch)})
    channels = args.live_channels or array_cfg.num_mics

    # JACK-graph mode: join the existing graph FIRST — the engine must run
    # at the server's rate, exactly rosjack.cpp:141-145 (rosjack_sample_rate
    # = jack_get_sample_rate drives everything downstream).
    jack = None
    if args.jack:
        if args.device:
            print("error: --jack and --device are mutually exclusive",
                  file=sys.stderr)
            return 2
        from beamform_tpu.runtime.native import JackClient
        try:
            jack = JackClient(args.jack, channels=channels,
                              auto_connect=not args.jack_no_autoconnect,
                              connect_out=not args.jack_no_autoconnect)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            print("hint: no JACK server on this host; use --device for "
                  "ALSA or pipe mode (--live alone)", file=sys.stderr)
            return 2
        if not args.jack_no_autoconnect and jack.connected_in < channels:
            import logging
            logging.getLogger("beamform_tpu.runtime.cli").warning(
                "connected %d/%d JACK input ports; sticking with the ones "
                "that were connected (rosjack.cpp:245-249)",
                jack.connected_in, channels)

    fs = jack.sample_rate if jack is not None else args.live_rate
    engine = EngineConfig(sample_rate=fs, window_size=args.window_size,
                          dtype=args.dtype)
    overrides = _node_params(args)
    model = get_model(args.node, engine, array_cfg, overrides)
    interf_ctrl = None
    if args.interf_control:
        if args.node not in ("lcmv", "gss"):
            print("error: --interf-control only applies to lcmv/gss",
                  file=sys.stderr)
            return 2
        from beamform_tpu.runtime.timeline import (
            InterferenceMachine, MAX_INTERFERENCES)
        thresh = overrides.get("interf_angle_threshold", 5.0)
        interf_ctrl = _InterfControlFile(
            args.interf_control,
            InterferenceMachine(list(array_cfg.interference_angles),
                                threshold=float(thresh),
                                capacity=MAX_INTERFERENCES))
        if hasattr(model, "capacity"):
            model.capacity = MAX_INTERFERENCES    # gss demix slots
    sess = StreamingSession(model, monitor=True)
    if args.load_state:
        sess.load(args.load_state)

    # In-process audio device (the reference's JACK-client role): open
    # before the expensive warm-up compile so a missing sound stack fails
    # fast with the reason, not after minutes of XLA work.
    alsa_in = alsa_out = None
    if args.device:
        from beamform_tpu.runtime.native import AlsaPcm
        try:
            alsa_in = AlsaPcm(args.device, capture=True,
                              channels=channels, rate=fs)
            alsa_out = AlsaPcm(args.device_out or args.device,
                               capture=False, channels=1, rate=fs)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            print("hint: no usable ALSA runtime/device on this host; use "
                  "pipe mode (--live without --device, e.g. through "
                  "arecord/aplay on a machine that has them)",
                  file=sys.stderr)
            return 2

    theta = args.theta if args.theta is not None else array_cfg.initial_angle
    hop = engine.hop
    chunk = args.live_chunk * hop
    frame_bytes = 4 * channels
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer

    # raw-fd input with an explicit backlog buffer so the 'drop' overrun
    # policy can shed load: JACK's real-time contract is "miss the deadline,
    # lose the period" (rosjack.cpp:78-82) — a pipe blocks instead, so when
    # the consumer falls behind we skip every backlogged chunk but the
    # newest, emit silence in their place and count them like xruns.
    import os as _os
    import select as _select
    # device/graph modes never touch the stdio pipe (and under test
    # harnesses stdin may not expose a real fd at all)
    raw_fd = (stdin.fileno()
              if jack is None and alsa_in is None else None)
    chunk_bytes = chunk * frame_bytes
    pending = b""
    eof = False

    def read_chunk_blocking():
        nonlocal pending, eof
        while len(pending) < chunk_bytes and not eof:
            d = _os.read(raw_fd, chunk_bytes)
            if not d:
                eof = True
                break
            pending += d
        out = pending[:chunk_bytes]
        pending = pending[len(out):]
        return out

    def drain_backlog():
        """Pull everything already queued in the pipe; drop all complete
        backlogged chunks except the newest. Returns the drop count."""
        nonlocal pending, eof
        while not eof:
            r, _, _ = _select.select([raw_fd], [], [], 0)
            if not r:
                break
            d = _os.read(raw_fd, 1 << 20)
            if not d:
                eof = True
                break
            pending += d
        dropped = 0
        while len(pending) >= 2 * chunk_bytes:
            pending = pending[chunk_bytes:]
            dropped += 1
        return dropped

    # warm up the compiled step before real audio arrives; don't let the
    # compile count as an xrun (with the interference control arrays in the
    # signature when the side channel is on, so the first message doesn't
    # trigger a mid-stream recompile)
    warm_kw = {}
    if interf_ctrl is not None:
        warm_kw["interference"] = interf_ctrl.machine.rows(args.live_chunk)
    sess.process(np.zeros((channels, chunk), dtype=np.float32), theta,
                 **warm_kw)
    sess.state = sess.model.stream_init()
    sess.frames_done = 0
    from beamform_tpu.utils.profiling import RealTimeMonitor
    sess.monitor = RealTimeMonitor(fs)

    if jack is not None:
        # Graph-paced loop: the JACK server's RT callback fills/drains the
        # SPSC rings on its own clock; this loop blocks on ring occupancy.
        # Capture overruns are dropped periods counted by the callback
        # (rosjack.cpp:78-82); playback underruns play silence (the
        # jack_write.cpp:7-10 decoupling-lag semantics).
        chunks_done = 0
        try:
            while args.max_chunks <= 0 or chunks_done < args.max_chunks:
                block = jack.read(chunk)
                if args.theta_control:
                    theta = _poll_theta(args.theta_control, theta)
                chunk_kw = {}
                if interf_ctrl is not None:
                    reset = interf_ctrl.poll()
                    chunk_kw["interference"] = interf_ctrl.machine.rows(
                        args.live_chunk, reset_first=reset)
                y = np.asarray(sess.process(block, theta, **chunk_kw),
                               dtype=np.float32)
                jack.write(y)
                chunks_done += 1
        except KeyboardInterrupt:
            pass
        except RuntimeError as e:     # server shutdown / stalled graph
            print(f"error: {e}", file=sys.stderr)
        report = sess.monitor.report()
        report["jack_xruns"] = jack.xruns
        report["jack_connected_in"] = jack.connected_in
        jack.close()
        print(json.dumps({"live": report}), file=sys.stderr)
        return 0

    if alsa_in is not None:
        # Device-paced loop: the hardware clock provides the real-time
        # contract (blocking readi), so there is no backlog to shed —
        # overruns surface as ALSA xruns, recovered and counted in
        # bio_alsa_read/write like jack_xrun_callback (rosjack.cpp:78-82).
        chunks_done = 0
        try:
            while args.max_chunks <= 0 or chunks_done < args.max_chunks:
                chunks_done += 1
                block = alsa_in.read(chunk)
                if args.theta_control:
                    theta = _poll_theta(args.theta_control, theta)
                chunk_kw = {}
                if interf_ctrl is not None:
                    reset = interf_ctrl.poll()
                    chunk_kw["interference"] = interf_ctrl.machine.rows(
                        args.live_chunk, reset_first=reset)
                y = np.asarray(sess.process(block, theta, **chunk_kw),
                               dtype=np.float32)
                alsa_out.write(y)
        except KeyboardInterrupt:
            pass
        report = sess.monitor.report()
        report["alsa_xruns"] = alsa_in.xruns + alsa_out.xruns
        alsa_in.close()
        alsa_out.close()
        print(json.dumps({"live": report}), file=sys.stderr)
        return 0

    total_dropped = 0
    silence = np.zeros(chunk, dtype="<f4").tobytes()
    while True:
        raw = read_chunk_blocking()
        if not raw:
            break
        if args.theta_control:    # the /theta topic, polled per chunk
            theta = _poll_theta(args.theta_control, theta)
        chunk_kw = {}
        if interf_ctrl is not None:   # the /theta_interference topic
            reset = interf_ctrl.poll()
            chunk_kw["interference"] = interf_ctrl.machine.rows(
                args.live_chunk, reset_first=reset)
        n = len(raw) // frame_bytes
        block = np.frombuffer(raw[:n * frame_bytes], dtype="<f4")
        block = block.reshape(n, channels).T
        if n < chunk:
            block = np.pad(block, ((0, 0), (0, chunk - n)))
        y = np.asarray(sess.process(block, theta, **chunk_kw),
                       dtype=np.float32)[:n]
        stdout.write(y.astype("<f4").tobytes())
        if args.live_overrun == "drop":
            dropped = drain_backlog()
            if dropped:
                total_dropped += dropped
                sess.monitor.xruns += dropped
                stdout.write(silence * dropped)
        stdout.flush()
    report = sess.monitor.report()
    report["dropped_chunks"] = total_dropped
    print(json.dumps({"live": report}), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # Reference-style console logging: every node prints an INFO/WARN line
    # per parameter as it resolves them (mvdr.cpp:150-186 and the same
    # pattern in every *_handle_params). config.make_params emits those on
    # the "beamform_tpu.config" logger; surface them on stderr here.
    import logging
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("[%(levelname)s] [%(name)s]: %(message)s"))
    pkg_log = logging.getLogger("beamform_tpu")
    # idempotent across repeated in-process main() calls (tests, embedding):
    # drop any StreamHandler a previous invocation attached, keep the
    # package's NullHandler
    for h in [h for h in pkg_log.handlers
              if isinstance(h, logging.StreamHandler)
              and not isinstance(h, logging.NullHandler)]:
        pkg_log.removeHandler(h)
    pkg_log.addHandler(handler)     # scoped: don't duplicate jax's handlers
    pkg_log.setLevel(getattr(logging, args.log_level.upper()))

    from beamform_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    if args.node == "write":
        return run_write(args)

    if args.live or args.jack:   # --jack implies live mode (a JACK client
        return run_live(args)    # has no offline file path)

    if args.input is None:
        print("error: --in is required (or use --live)", file=sys.stderr)
        return 2
    x, fs = wav_io.read_wav(args.input)
    if args.array_config:
        array_cfg = load_array_config(args.array_config)
    else:
        # no geometry given: co-located mics, one per input channel
        # (zero delays -> plain averaging); pass --array-config for steering
        array_cfg = parse_array_config(
            {f"mic{i}": {"id": i, "x": 0.0, "y": 0.0}
             for i in range(x.shape[0])})
        print(f"note: no --array-config; assuming {x.shape[0]} co-located "
              "mics (no steering)", file=sys.stderr)
    rosjack = (load_rosjack_config(args.rosjack_config)
               if args.rosjack_config else None)
    engine = EngineConfig(sample_rate=fs, window_size=args.window_size,
                          dtype=args.dtype)
    if array_cfg.num_mics not in (0, x.shape[0]):
        print(f"note: config has {array_cfg.num_mics} mics, input has "
              f"{x.shape[0]} channels; using the first "
              f"{min(array_cfg.num_mics, x.shape[0])}", file=sys.stderr)
        x = x[:array_cfg.num_mics]

    theta = args.theta if args.theta is not None else array_cfg.initial_angle
    num_frames = -(-x.shape[1] // engine.hop)
    if args.theta_timeline:
        theta = theta_from_spec(args.theta_timeline, num_frames, engine.hop,
                                fs, float(theta))

    overrides = _node_params(args)
    model = get_model(args.node, engine, array_cfg, overrides)

    interference = None
    if args.interference_events:
        from beamform_tpu.runtime.timeline import (
            InterfEvent, replay_interference_events, MAX_INTERFERENCES)
        events = []
        for item in args.interference_events.split(","):
            t_s, iid, a = item.split(":")
            events.append(InterfEvent(frame=int(float(t_s) * fs / engine.hop),
                                      id=int(iid), angle=float(a)))
        thresh = overrides.get("interf_angle_threshold", 5.0)
        interference = replay_interference_events(
            num_frames, list(array_cfg.interference_angles), events,
            threshold=float(thresh), capacity=MAX_INTERFERENCES)

    kw = {}
    if interference is not None:
        if args.node not in ("lcmv", "gss"):
            print("error: --interference-events only applies to lcmv/gss",
                  file=sys.stderr)
            return 2
        kw["interference"] = interference

    if args.interf_control:
        if args.node not in ("lcmv", "gss"):
            print("error: --interf-control only applies to lcmv/gss",
                  file=sys.stderr)
            return 2
        if args.interference_events:
            print("error: --interf-control and --interference-events are "
                  "mutually exclusive (one live channel, one offline "
                  "replay)", file=sys.stderr)
            return 2
        if not args.stream:
            print("error: --interf-control needs --stream or --live "
                  "(chunk boundaries are the polling points)",
                  file=sys.stderr)
            return 2

    t0 = time.perf_counter()
    monitor = None
    if args.stream:
        from beamform_tpu.runtime.streaming import StreamingSession
        from beamform_tpu.runtime.timeline import InterferenceTimeline
        interf_ctrl = None
        if args.interf_control:
            from beamform_tpu.runtime.timeline import (
                InterferenceMachine, MAX_INTERFERENCES)
            thresh = overrides.get("interf_angle_threshold", 5.0)
            interf_ctrl = _InterfControlFile(
                args.interf_control,
                InterferenceMachine(list(array_cfg.interference_angles),
                                    threshold=float(thresh),
                                    capacity=MAX_INTERFERENCES))
            if hasattr(model, "capacity"):
                model.capacity = MAX_INTERFERENCES    # gss demix slots
        if interference is not None and hasattr(model, "capacity"):
            # size the demixing state for the timeline's slot capacity
            # BEFORE stream_init runs (gss)
            model.capacity = interference.capacity
        sess = StreamingSession(model, monitor=True)
        if args.load_state:
            sess.load(args.load_state)
        chunk = args.stream * engine.hop
        pad = (-x.shape[1]) % chunk
        xp = np.pad(x, ((0, 0), (0, pad)))
        outs = []
        if args.theta_control and isinstance(theta, np.ndarray):
            print("note: --theta-control overrides --theta-timeline from "
                  "the first chunk where the control file provides an "
                  "angle", file=sys.stderr)
        live_theta = None
        for i in range(0, xp.shape[1], chunk):
            if args.theta_control:   # the /theta topic, polled per chunk
                v = _read_theta(args.theta_control)
                if v is not None:
                    live_theta = v
            f0 = i // engine.hop
            f1 = f0 + args.stream
            if live_theta is not None:
                th = live_theta
            elif isinstance(theta, np.ndarray):
                th = theta[f0:min(f1, len(theta))]
                if len(th) == 0:     # trailing padded chunk: theta holds
                    th = float(theta[-1])
            else:
                th = theta
            tl_c = None
            if interf_ctrl is not None:
                reset = interf_ctrl.poll()
                tl_c = interf_ctrl.machine.rows(args.stream,
                                                reset_first=reset)
            elif interference is not None:
                tl = interference

                def rows(a):
                    r = a[f0:f1]
                    if len(r) < args.stream:   # padded tail: last row holds
                        pad = np.repeat(r[-1:], args.stream - len(r), axis=0)
                        r = np.concatenate([r, pad], axis=0)
                    return r

                tl_c = InterferenceTimeline(rows(tl.angles), rows(tl.active),
                                            rows(tl.row0), rows(tl.reset))
            outs.append(np.asarray(sess.process(xp[:, i:i + chunk], th,
                                                interference=tl_c)))
        y = np.concatenate(outs)[:x.shape[1] + (-x.shape[1]) % engine.hop]
        monitor = sess.monitor
        if args.save_state:
            sess.save(args.save_state)
    else:
        y = np.asarray(model.process(x, theta, **kw))
    wall = time.perf_counter() - t0
    audio_sec = x.shape[1] / fs
    xrt = audio_sec / wall if wall > 0 else float("inf")

    out_fs = fs
    if rosjack and rosjack.ros_output_sample_rate not in (None, fs):
        out_fs = rosjack.ros_output_sample_rate
        y = np.asarray(resample(y, fs, out_fs))

    nonfinite = int(np.sum(~np.isfinite(y)))
    if nonfinite:
        # The reference writes whatever Eigen produced on singular
        # covariances (garbage on a cold MVDR/LCMV history with a permissive
        # energy gate); we zero it at the file boundary and say so.
        print(f"warning: {nonfinite} non-finite output samples zeroed "
              "(singular covariance history? raise freq_mag_threshold or "
              "start with a quieter lead-in)", file=sys.stderr)
        y = np.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0)

    out_path = args.output
    if out_path is None and rosjack and rosjack.write_file_path:
        out_path = rosjack.write_file_path
    if out_path is None:
        out_path = args.input + f".{args.node}.wav"
    try:
        wav_io.write_wav(out_path, y, out_fs, fmt=args.out_format)
    except OSError as e:
        # degrade like the reference: warn and continue without file output
        # (rosjack.cpp:199-203)
        print(f"warning: could not open {out_path} for writing ({e}); "
              "continuing without file output", file=sys.stderr)
        out_path = None

    clip = int(np.sum(np.abs(y) >= 1.0))
    if clip:
        # rosjack.cpp:372-374 warns per out-of-range sample
        print(f"warning: {clip} output samples out of [-1,1] range",
              file=sys.stderr)

    report = {
        "node": args.node, "input": args.input, "output": out_path,
        "mics": int(x.shape[0]), "samples": int(x.shape[1]),
        "sample_rate": fs, "out_sample_rate": out_fs,
        "wall_s": round(wall, 4), "xrt": round(xrt, 2),
        "clipped_samples": clip,
    }
    if monitor is not None:
        report["streaming"] = monitor.report()
    if args.report_json:
        print(json.dumps(report))
    else:
        print(f"{args.node}: {audio_sec:.2f}s audio in {wall:.3f}s "
              f"({xrt:.1f}x real-time) -> {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
