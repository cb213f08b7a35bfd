"""CLI configuration plumbing: launch presets and theta-timeline files.

The reference applies per-node hyperparameters from launch/*.launch at node
start (launch/mvdr.launch:4-9); ``beamform-tpu <node>`` must reproduce
those values by default, with --param overriding and --launch-preset off
restoring in-code defaults.
"""

import json

import numpy as np

from beamform_tpu.config import load_launch_params, make_params
from beamform_tpu.runtime.cli import (
    _node_params,
    build_parser,
    theta_from_spec,
)


def _args(argv):
    return build_parser().parse_args(argv)


def test_launch_preset_reproduces_mvdr_launch():
    """launch/mvdr.launch:4-9 values flow into MvdrParams by default."""
    args = _args(["mvdr", "--in", "x.wav"])
    p = make_params("mvdr", _node_params(args))
    assert p.past_windows == 10
    assert p.freq_mag_threshold == 0.001
    assert p.freq_max == 16000
    assert p.freq_min == 100
    assert p.out_amp == 1.0


def test_launch_preset_off_gives_in_code_defaults():
    args = _args(["mvdr", "--in", "x.wav", "--launch-preset", "off"])
    p = make_params("mvdr", _node_params(args))
    assert p.freq_mag_threshold == 1.5      # mvdr.cpp:151 default
    assert p.out_amp == 4.5


def test_param_overrides_preset():
    args = _args(["gsc", "--in", "x.wav", "--param", "filter_size=64",
                  "--param", "write_mu=false"])
    p = make_params("gsc", _node_params(args))
    assert p.filter_size == 64              # override wins
    assert p.write_mu is False
    assert p.mu0 == 0.0001                  # launch/gsc.launch value kept


def test_launch_params_cover_every_node():
    for node in ("das", "mvdr", "lcmv", "gss", "gsc", "phase", "mcra",
                 "phasempf"):
        make_params(node, load_launch_params(node))  # must not raise


def test_theta_file_json_and_csv(tmp_path):
    j = tmp_path / "tl.json"
    j.write_text(json.dumps([0.0, 10.0, 20.0]))
    c = tmp_path / "tl.csv"
    c.write_text("5.0,15.0,25.0,35.0\n")

    # shorter than the stream: last angle holds
    th = theta_from_spec(str(j), 5, 256, 48000, 0.0)
    np.testing.assert_array_equal(th, [0.0, 10.0, 20.0, 20.0, 20.0])

    # longer than the stream: tail ignored, no late ValueError
    th = theta_from_spec(str(c), 2, 256, 48000, 0.0)
    np.testing.assert_array_equal(th, [5.0, 15.0])

    # exact length passes through
    th = theta_from_spec(str(c), 4, 256, 48000, 0.0)
    np.testing.assert_array_equal(th, [5.0, 15.0, 25.0, 35.0])


def test_param_resolution_logging(caplog):
    """Every resolved parameter is logged like the reference's
    *_handle_params (mvdr.cpp:150-186): INFO when supplied, WARN with the
    default when absent; implementation knobs (solver) never warn."""
    import logging

    with caplog.at_level(logging.INFO, logger="beamform_tpu.config"):
        make_params("mvdr", {"past_windows": 7, "solver": "dense"})
    warns = [r for r in caplog.records if r.levelno == logging.WARNING]
    infos = [r for r in caplog.records if r.levelno == logging.INFO]
    assert any("mvdr/past_windows" in r.getMessage() for r in infos)
    warned = {r.getMessage() for r in warns}
    # The four unspecified reference params warn with their defaults...
    for name, default in [("freq_mag_threshold", "1.5"), ("freq_max", "4000"),
                          ("freq_min", "400"), ("out_amp", "4.5")]:
        assert any(f"mvdr/{name}" in m and default in m for m in warned), name
    # ...and the impl-only solver knob never does.
    assert not any("solver" in m for m in warned)


def test_yaml_loader_reads_the_config_shapes():
    """The YAML subset of configs/*.yaml and the reference's
    beamform_config.yaml: scalars, one-line flow maps, indented block
    maps, comments — without pyyaml."""
    from beamform_tpu.config import load_yaml
    doc = load_yaml(
        "# geometry\n"
        "verbose: true\n"
        "initial_angle: -12.5   # degrees\n"
        "mic0: {id: 0, x:  0.158, y: -0.115}\n"
        "mic1:\n"
        "  id: 1\n"
        "  x: 1e-2\n"
        "  y: .5\n"
        "write_file_path: '/tmp/out.wav'\n"
        "das: {}\n"
        "angle_interf1: 181.0\n")
    assert doc == {"verbose": True, "initial_angle": -12.5,
                   "mic0": {"id": 0, "x": 0.158, "y": -0.115},
                   "mic1": {"id": 1, "x": 0.01, "y": 0.5},
                   "write_file_path": "/tmp/out.wav", "das": {},
                   "angle_interf1": 181.0}


def test_shipped_configs_load():
    import os
    import beamform_tpu
    from beamform_tpu.config import load_array_config
    cfg_dir = os.path.join(beamform_tpu.__path__[0], "configs")
    a16 = load_array_config(os.path.join(cfg_dir, "aira16.yaml"))
    assert a16.num_mics == 16 and a16.mics[15].x == 0.158
    a3 = load_array_config(os.path.join(cfg_dir, "aira3.yaml"))
    assert [(m.x, m.y) for m in a3.mics] == [(0.0, 0.0), (0.0, -0.18),
                                             (-0.156, -0.09)]
    assert load_launch_params("gss")["lambda"] == 0.0
    assert load_launch_params("mcra")["out_only_noise"] is False


def test_yaml_loader_rejects_what_it_cannot_read():
    import pytest
    from beamform_tpu.config import load_yaml
    for bad in ("just a line\n", "  indented: 1\n", "m: {id: 0, x: 1\n",
                "m: {id 0}\n"):
        with pytest.raises(ValueError):
            load_yaml(bad)
