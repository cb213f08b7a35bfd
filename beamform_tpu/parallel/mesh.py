"""Device mesh construction.

The reference scales by running one OS process per node connected over ROS
topics (SURVEY.md §2 parallelism table); this framework scales by laying a
``jax.sharding.Mesh`` over the chips:

* ``stream`` axis (data parallel): independent audio streams / files / mic
  arrays — the fleet-scale batch axis;
* ``bin`` axis (tensor parallel): frequency bins of one stream — the per-bin
  solves (MVDR/LCMV inverses, GSS demixing updates) are embarrassingly
  parallel across bins, so bins shard cleanly with a single all-gather
  before each iFFT.

Every device of a GPU host reaches every other at the same rate, so the
mesh follows the algorithm alone: streams first, a bin axis only where the
caller asks for one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              shape: Optional[Tuple[int, int]] = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    # independent streams take every device unless a bin axis is asked for
    dp, tp = shape if shape is not None else (len(devices), 1)
    assert dp * tp == len(devices), (dp, tp, len(devices))
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, axis_names=("stream", "bin"))


def make_mesh3(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None,
               shape: Optional[Tuple[int, int, int]] = None) -> Mesh:
    """Three-axis mesh (stream, frame, bin): data parallel over recordings,
    sequence parallel over STFT frames (stateless models' frames are
    independent; XLA inserts the one-hop halo exchange the 50%-overlap
    framing needs), tensor parallel over frequency bins."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if shape is None:
        if n % 8 == 0:
            shape = (n // 8, 2, 4)
        elif n % 4 == 0:
            shape = (n // 4, 2, 2)
        else:
            shape = (n, 1, 1)
    dp, sp, tp = shape
    assert dp * sp * tp == n, (shape, n)
    arr = np.asarray(devices).reshape(dp, sp, tp)
    return Mesh(arr, axis_names=("stream", "frame", "bin"))
