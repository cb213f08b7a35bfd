"""Configuration layer.

Reads the exact YAML schemas of the reference package
(``beamform/beamform_config.yaml`` and ``beamform/rosjack_config.yaml``) and
the per-node hyperparameters that the reference supplies inline in its
``launch/*.launch`` files.

Reference semantics reproduced here:

* mic geometry is given as ``micN: {id, x, y[, z]}`` keys, parsed for
  consecutive N starting at 0 (``util.h:75-92``); ``z`` is ignored.
* polar coordinates (``dist``, ``angle``) are computed from the RAW x/y
  *before* re-referencing to mic0 (``util.h:83-84`` runs inside the parse
  loop; re-referencing happens afterwards at ``util.h:116-119`` and is never
  reflected in dist/angle).  ``rereference_polar=True`` opts into the
  arguably-intended behavior of recomputing polar coords after
  re-referencing.
* interference slots ``angle_interf1..`` are parsed for consecutive N
  starting at 1 until a value with ``abs(angle) > 180`` is found
  (``util.h:94-113``, sentinel 181.0 in ``beamform_config.yaml:44-57``).
* missing parameters fall back to the reference's documented defaults (the
  reference logs a ROS_WARN and continues; we record the same defaults).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

# Parameter-resolution log, mirroring the reference's per-parameter
# ROS_INFO/ROS_WARN lines (mvdr.cpp:150-186 pattern repeated in every node's
# *_handle_params). Silent unless the application configures logging — the
# CLI does (runtime/cli.py), so `beamform-tpu mvdr ...` prints the same
# warn-and-default trail `roslaunch beamform mvdr.launch` would.
log = logging.getLogger("beamform_tpu.config")

# Output-type policy (rosjack.h:28-31).
ROSJACK_OUT_BOTH = 0
ROSJACK_OUT_JACK = 1
ROSJACK_OUT_ROS = 2


def _yaml_scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("", "~", "null"):
        return None
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def _yaml_flow_map(text: str) -> Dict[str, Any]:
    """``{k: v, k2: v2}`` with scalar values (one line, no nesting)."""
    body = text.strip()[1:-1].strip()
    out: Dict[str, Any] = {}
    for item in filter(None, (i.strip() for i in body.split(","))):
        key, sep, val = item.partition(":")
        if not sep:
            raise ValueError(f"malformed flow-map entry {item!r}")
        out[key.strip()] = _yaml_scalar(val)
    return out


def load_yaml(text: str) -> Dict[str, Any]:
    """Parse the YAML subset the configs use: top-level ``key: scalar``,
    ``key: {flow: map}`` and ``key:`` followed by an indented block of
    ``sub: scalar`` lines; ``#`` comments. Anything else raises."""
    doc: Dict[str, Any] = {}
    block: Optional[Dict[str, Any]] = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = re.sub(r"\s+#.*$", "", raw)
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        key, sep, val = line.strip().partition(":")
        if not sep:
            raise ValueError(f"line {n}: not a 'key: value' line: {raw!r}")
        key, val = key.strip(), val.strip()
        if line[0] in " \t":
            if block is None:
                raise ValueError(f"line {n}: unexpected indentation")
            block[key] = _yaml_scalar(val)
            continue
        block = None
        if val.startswith("{"):
            if not val.endswith("}"):
                raise ValueError(f"line {n}: unterminated flow map")
            doc[key] = _yaml_flow_map(val)
        elif val:
            doc[key] = _yaml_scalar(val)
        else:
            doc[key] = block = {}
    return doc


def _load_yaml_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return load_yaml(f.read())


@dataclass(frozen=True)
class MicSpec:
    """One microphone entry from the config (util.h:75-92)."""

    id: int
    x: float
    y: float
    # Polar coordinates as the reference computes them: from the coordinates
    # as written in the YAML, before mic0 re-referencing (util.h:83-84).
    dist: float = 0.0
    angle_deg: float = 0.0


@dataclass(frozen=True)
class ArrayConfig:
    """Parsed ``beamform_config.yaml`` (+ per-node geometry knobs)."""

    verbose: bool = False
    initial_angle: float = 0.0
    mics: tuple = ()
    interference_angles: tuple = ()
    # Bug-compat switch: the reference keeps polar coords computed from raw
    # x/y even though it shifts cartesian coords to mic0 (util.h:83-119).
    rereference_polar: bool = False

    @property
    def num_mics(self) -> int:
        return len(self.mics)


@dataclass(frozen=True)
class RosjackConfig:
    """Parsed ``rosjack_config.yaml`` (rosjack.cpp:6-72)."""

    output_type: int = ROSJACK_OUT_BOTH
    auto_connect: bool = True
    write_file: bool = False
    write_file_path: str = ""
    write_xrun: bool = False
    ros_output_sample_rate: Optional[int] = None  # None => use engine rate


def _mic_from_mapping(idx: int, m: Dict[str, Any], rereference_polar: bool,
                      ref_xy=(0.0, 0.0)) -> MicSpec:
    x = float(m.get("x", 0.0))
    y = float(m.get("y", 0.0))
    if rereference_polar:
        px, py = x - ref_xy[0], y - ref_xy[1]
    else:
        px, py = x, y
    return MicSpec(
        id=int(m.get("id", idx)),
        x=x,
        y=y,
        dist=math.hypot(px, py),
        angle_deg=math.degrees(math.atan2(py, px)),
    )


def parse_array_config(doc: Dict[str, Any], *,
                       rereference_polar: bool = False) -> ArrayConfig:
    """Build an :class:`ArrayConfig` from a loaded YAML mapping.

    Mirrors ``handle_params`` (util.h:52-134): consecutive ``micN`` keys from
    0, consecutive ``angle_interfN`` keys from 1 with the ``abs(a) > 180``
    sentinel terminating the scan.
    """
    doc = doc or {}
    mics: List[MicSpec] = []
    i = 0
    ref_xy = (0.0, 0.0)
    while f"mic{i}" in doc:
        m = doc[f"mic{i}"]
        if i == 0:
            ref_xy = (float(m.get("x", 0.0)), float(m.get("y", 0.0)))
        mics.append(_mic_from_mapping(i, m, rereference_polar, ref_xy))
        i += 1

    interf: List[float] = []
    k = 1
    while f"angle_interf{k}" in doc:
        a = float(doc[f"angle_interf{k}"])
        if abs(a) <= 180.0:
            interf.append(a)
            k += 1
        else:
            break

    return ArrayConfig(
        verbose=bool(doc.get("verbose", False)),
        initial_angle=float(doc.get("initial_angle", 0.0)),
        mics=tuple(mics),
        interference_angles=tuple(interf),
        rereference_polar=rereference_polar,
    )


def load_array_config(path: str, **kw) -> ArrayConfig:
    return parse_array_config(_load_yaml_file(path), **kw)


def parse_rosjack_config(doc: Dict[str, Any]) -> RosjackConfig:
    doc = doc or {}
    out_type = int(doc.get("output_type", ROSJACK_OUT_BOTH))
    if out_type not in (ROSJACK_OUT_BOTH, ROSJACK_OUT_JACK, ROSJACK_OUT_ROS):
        out_type = ROSJACK_OUT_BOTH  # rosjack.cpp:17-19 warn-and-default
    sr = doc.get("ros_output_sample_rate", None)
    return RosjackConfig(
        output_type=out_type,
        auto_connect=bool(doc.get("auto_connect", True)),
        write_file=bool(doc.get("write_file", False)),
        write_file_path=str(doc.get("write_file_path", "") or ""),
        write_xrun=bool(doc.get("write_xrun", False)),
        ros_output_sample_rate=int(sr) if sr is not None else None,
    )


def load_rosjack_config(path: str) -> RosjackConfig:
    return parse_rosjack_config(_load_yaml_file(path))


# ---------------------------------------------------------------------------
# Per-node hyperparameters.
#
# Defaults are the in-code defaults of each reference node (the values used
# when a parameter is missing from the ROS param server). The values the
# reference ships in its launch files live in beamform_tpu/configs/*.yaml.
# ---------------------------------------------------------------------------

#: solver names of hand-written kernels this package no longer has
_REMOVED_SOLVERS = {"mega", "stream", "sparse", "fused", "block", "xmu"}


def _check_solver(node: str, solver: str, allowed: tuple) -> None:
    """``solver`` is an implementation knob, not a reference parameter:
    reject a name outside ``allowed`` and say what remains."""
    if solver in allowed:
        return
    what = "was removed" if solver in _REMOVED_SOLVERS else "is unknown"
    remain = " or ".join(repr(a) for a in allowed)
    raise ValueError(f"{node}: solver={solver!r} {what}; use solver={remain}")


@dataclass(frozen=True)
class DasParams:
    """das.cpp has no extra parameters."""


@dataclass(frozen=True)
class MvdrParams:
    """mvdr.cpp:146-187 defaults."""

    past_windows: int = 10
    freq_mag_threshold: float = 1.5
    freq_max: float = 4000.0
    freq_min: float = 400.0
    out_amp: float = 4.5
    #: implementation strategy, not a reference param: the dense block
    #: scan (models/mvdr.py) is the one route
    solver: str = "dense"

    def __post_init__(self):
        _check_solver("mvdr", self.solver, ("dense",))


@dataclass(frozen=True)
class LcmvParams:
    """lcmv.cpp:171-219 defaults."""

    past_windows: int = 10
    freq_mag_threshold: float = 1.5
    freq_max: float = 4000.0
    freq_min: float = 400.0
    out_amp: float = 4.5
    interf_angle_threshold: float = 5.0
    solver: str = "dense"         # see MvdrParams.solver

    def __post_init__(self):
        _check_solver("lcmv", self.solver, ("dense",))


@dataclass(frozen=True)
class GssParams:
    """gss.cpp:187-240 defaults."""

    freq_mag_threshold: float = 1.5
    freq_max: float = 4000.0
    freq_min: float = 400.0
    out_amp: float = 4.5
    mu: float = 0.01
    lam: float = 0.0  # "lambda" in the reference
    interf_angle_threshold: float = 5.0
    #: demixing-update strategy: the lax.scan over frames is the one route
    solver: str = "scan"

    def __post_init__(self):
        _check_solver("gss", self.solver, ("scan",))


@dataclass(frozen=True)
class GscParams:
    """gsc.cpp:206-258 defaults."""

    use_vad: bool = False
    vad_threshold: float = 0.1
    mu0: float = 0.0005
    mu_max: float = 0.01
    filter_size: int = 128
    write_mu: bool = False
    #: adaptive-stage semantics: "sample" = the faithful per-sample
    #: recurrence (gsc.cpp:120-179; kernels/gsc_sample.py on a GPU, a
    #: lax.scan elsewhere); "blocklms" = the NON-FAITHFUL block-LMS mode
    #: (kernels/gsc_blocklms.py): the filter bank is frozen for
    #: ``block_samples`` and the per-sample updates (gsc.cpp:162-169) land
    #: at block boundaries, with the per-sample dynamic-mu rule intact.
    #: SIR-gain parity with the faithful mode is pinned by
    #: tests/test_gsc_blocklms.py (docs/PARITY.md #24).
    solver: str = "sample"
    #: blocklms only: samples the filter bank stays frozen for (128, 256,
    #: 512 or 1024). Larger blocks shorten the serial chain at the cost of
    #: up-to-(block-1)-sample filter staleness; quality is pinned per block
    #: size by tests/test_gsc_blocklms.py. Implementation knob, not a
    #: reference parameter.
    block_samples: int = 128

    def __post_init__(self):
        _check_solver("gsc", self.solver, ("sample", "blocklms"))
        if self.write_mu and self.solver == "blocklms":
            raise ValueError("gsc: write_mu traces the faithful per-sample "
                             "stage; it needs solver='sample'")


@dataclass(frozen=True)
class PhaseParams:
    """phase.cpp:165-191 defaults.

    NOTE the reference quirk: ``launch/phase.launch`` passes ``min_mag`` and
    ``smooth_size`` but the node only reads ``min_phase``, ``mag_mult`` and
    ``mag_threshold`` — the launch values for the former two are silently
    ignored and the in-code defaults are used (phase.cpp:177-189).
    """

    min_phase: float = 10.0  # degrees
    mag_mult: float = 0.1
    mag_threshold: float = 0.05
    #: mask strategy: the batched XLA formulation is the one route
    solver: str = "xla"

    def __post_init__(self):
        _check_solver("phase", self.solver, ("xla",))


@dataclass(frozen=True)
class McraParams:
    """mcra.cpp:179-231 defaults."""

    alphaS: float = 0.95
    alphaD: float = 0.95
    alphaD2: float = 0.97
    delta: float = 0.001
    L: int = 75
    out_amp: float = 2.0
    out_only_noise: bool = True  # mcra.cpp:227 default when param absent


@dataclass(frozen=True)
class PhasempfParams:
    """phasempf.cpp:355-475 defaults."""

    min_phase: float = 10.0   # degrees
    min_mag: float = 10.0     # default when absent (phasempf.cpp:370)
    smooth_size: int = 20
    MCRA_alphaS: float = 0.95
    MCRA_alphaD: float = 0.95
    MCRA_alphaD2: float = 0.97
    MCRA_delta: float = 0.001
    MCRA_L: int = 75
    MPF_alphaS: float = 0.3
    MPF_eta: float = 0.3
    MPF_rev_gamma: float = 0.3
    MPF_rev_delta: float = 1.0
    out_amp: float = 2.0      # default when absent (phasempf.cpp:451)
    noise_floor: float = 0.001
    out_only_noise: bool = False
    out_only_mcra: bool = False
    #: see PhaseParams.solver
    solver: str = "xla"

    def __post_init__(self):
        _check_solver("phasempf", self.solver, ("xla",))


PARAM_CLASSES = {
    "das": DasParams,
    "mvdr": MvdrParams,
    "lcmv": LcmvParams,
    "gss": GssParams,
    "gsc": GscParams,
    "phase": PhaseParams,
    "mcra": McraParams,
    "phasempf": PhasempfParams,
    "ref": DasParams,
    "read": DasParams,
}

# Reference launch-file parameter name quirks: phase.launch passes min_mag /
# smooth_size which the phase node never reads (phase.cpp:177-189 vs
# launch/phase.launch:6-8). We mimic by dropping unknown keys.


def load_launch_params(node: str, path: Optional[str] = None
                       ) -> Dict[str, Any]:
    """The per-node hyperparameters the reference's launch files apply at
    node start (launch/mvdr.launch:4-9 etc.), shipped as
    configs/launch_params.yaml. Running ``beamform-tpu <node>`` applies
    these by default (``--launch-preset off`` restores in-code defaults),
    exactly like ``roslaunch beamform <node>.launch`` does for the
    reference."""
    import os
    if path is None:
        path = os.path.join(os.path.dirname(__file__), "configs",
                            "launch_params.yaml")
    return dict(_load_yaml_file(path).get(node) or {})


def make_params(model: str, overrides: Optional[Dict[str, Any]] = None):
    """Instantiate a node's parameter dataclass with launch-style overrides.

    Unknown keys are ignored with the same silently-forgiving behavior the
    ROS param server gives the reference (a node only reads keys it knows).
    ``lambda`` is accepted as an alias for :attr:`GssParams.lam`.

    Each known parameter is logged the way the reference's
    ``*_handle_params`` does (mvdr.cpp:150-186): INFO when supplied, WARN
    with the default value when absent. ``solver``/``block_samples`` are
    implementation knobs, not reference parameters — they are logged at
    DEBUG only when explicitly set, never warned about. A removed or
    unknown ``solver`` raises ValueError.
    """
    cls = PARAM_CLASSES[model]
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for key, val in (overrides or {}).items():
        if key == "lambda" and "lam" in fields:
            key = "lam"
        if key in fields:
            kw[key] = val
    obj = cls(**kw)
    _IMPL_KNOBS = {"solver", "block_samples"}
    for f in dataclasses.fields(cls):
        if f.name in _IMPL_KNOBS:
            if f.name in kw:
                log.debug("%s/%s (impl knob): %s", model, f.name, kw[f.name])
            continue
        if f.name in kw:
            log.info("%s/%s: %s", model, f.name, kw[f.name])
        else:
            log.warning(
                "%s/%s argument not found in config, using default value "
                "(%s).", model, f.name, getattr(obj, f.name))
    return obj


@dataclass(frozen=True)
class EngineConfig:
    """Global engine settings: the moral equivalent of the JACK server state
    plus our numerics policy.
    """

    sample_rate: int = 48000       # jack_get_sample_rate (rosjack.cpp:133)
    window_size: int = 1024        # jack_get_buffer_size (rosjack.cpp:131)
    dtype: str = "float32"         # compute dtype ("float32" | "float64")
    # Faithful reproduction of reference quirks that affect output parity.
    # See beamform_tpu.geometry.frequency_vector for the exact_freqs story.
    exact_freqs: bool = False
    # MCRA / PhaseMPF leave y_fft[0] unwritten (OOB write at mcra.cpp:127,
    # phasempf.cpp:274); on a fresh heap page that means DC==0 forever.
    bug_dc_zero: bool = True
    # Audit escape hatch: run the reference's literal N-point complex FFT
    # layout (das.cpp:127-128, util.h:190-199) instead of the extended-rFFT
    # shadow-bin layout, to check the equivalence argument on device
    # numerics. Slower; the default layout is proven bit-equivalent on
    # CPU f64 (tests/test_full_fft.py).
    full_fft: bool = False

    @property
    def fft_win(self) -> int:
        return 2 * self.window_size  # util.h:261

    @property
    def hop(self) -> int:
        return self.window_size
