"""Multi-chip execution over a (stream, bin) mesh.

Follows the annotate-and-let-XLA-insert-collectives recipe: inputs are
placed with NamedShardings, intermediates are pinned with
``lax.with_sharding_constraint``, and XLA emits the all-gathers/psums. The
two meaningful parallel axes of this workload:

* ``stream`` (data parallel) — independent recordings / mic arrays;
* ``bin`` (tensor parallel) — per-frequency-bin state and solves: GSS
  demixing matrices, MVDR/LCMV covariances. Bin-sharded math needs exactly
  one all-gather (of output bins) before each iFFT, which XLA inserts at the
  sharding-constraint boundary.

Pipeline parallelism is deliberately absent: the per-frame compute graph is
two FFTs deep with no layer stack to cut; the profitable decomposition is
streams x bins (see SURVEY.md §2, parallelism inventory).

``sharded_training_step`` is the framework's "training" step: the online
adaptive beamformers *are* streaming learners (GSS natural-gradient demixing
updates, gss.cpp:124-136), so one step = ingest a frame batch, produce
beamformed audio, and update the learned per-bin demixing state — with the
state sharded over the ``bin`` axis and the batch over ``stream``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from beamform_tpu.config import EngineConfig
from beamform_tpu.models import common
from beamform_tpu.models.das import das_spectral
from beamform_tpu.models.gss import gss_update


def _constraint(x, mesh, spec):
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def _fft_last(x):
    """FFT over the last axis via a flattened 2D view: XLA's CPU FFT thunk
    requires a dim0-major layout, which sharded higher-rank intermediates
    don't always get; a (batch, n) reshape always does."""
    shape = x.shape
    y = jnp.fft.fft(x.reshape(-1, shape[-1]), axis=-1)
    return y.reshape(shape)


def _ifft_last_real(x):
    shape = x.shape
    y = jnp.fft.ifft(x.reshape(-1, shape[-1]), axis=-1).real
    return y.reshape(shape)


def _np_window(engine: EngineConfig):
    """Host-side window constant: jit captures it as a literal, so it
    never has to move between the default device and the mesh."""
    from beamform_tpu.dsp.wola import sqrt_hann
    rdtype = np.float64 if engine.dtype == "float64" else np.float32
    return sqrt_hann(engine.fft_win).astype(rdtype)


def sharded_spectral_pipeline(mesh: Mesh, engine: EngineConfig, weights,
                              x_batch, kind: str = "das"):
    """Run a stateless spectral beamformer over a batch of streams.

    x_batch: (B, M, S) with B divisible by the ``stream`` axis and nfft by
    the ``bin`` axis; weights: (M, nfft). Returns (B, S) outputs.

    Works with the 2-axis (stream, bin) mesh or the 3-axis
    (stream, frame, bin) mesh — with a ``frame`` axis the per-frame spectral
    math is additionally sequence-parallel (frames of a stateless model are
    independent; the framing halo and the overlap-add seam are XLA's to
    resolve at the sharding-constraint boundaries).
    """
    rdtype, cdtype = common.dtypes_of(engine)
    window = _np_window(engine)
    has_frame = "frame" in mesh.axis_names
    f_ax = "frame" if has_frame else None

    from beamform_tpu.dsp.wola import frame_signal, overlap_add

    @partial(jax.jit,
             in_shardings=(NamedSharding(mesh, P("stream", None, None)),
                           NamedSharding(mesh, P(None, "bin"))),
             out_shardings=NamedSharding(mesh, P("stream", None)))
    def fn(xb, w):
        frames = frame_signal(xb, engine.hop) * window   # (B, M, T, 2h)
        spec = _fft_last(frames.astype(cdtype))
        spec = jnp.moveaxis(spec, 1, 2)                  # (B, T, M, N)
        spec = _constraint(spec, mesh, P("stream", f_ax, None, "bin"))
        if kind == "das":
            y = jax.vmap(lambda s, ww: das_spectral(s, ww),
                         in_axes=(0, None))(spec, w)
        else:
            raise ValueError(kind)
        y = _constraint(y, mesh, P("stream", f_ax, "bin"))
        out = overlap_add(_ifft_last_real(y) * window, engine.hop)
        return _constraint(out, mesh, P("stream", None))

    return fn(jnp.asarray(x_batch, dtype=rdtype),
              jnp.asarray(weights, dtype=cdtype))


def _bin_axis_size(mesh: Mesh | None) -> int:
    if mesh is None:
        return 1
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get("bin", 1)


def _bin_pad(model, bin_size: int) -> int:
    """Zero-padding that rounds the in-band bin count up to the mesh's
    ``bin`` axis so NamedSharding placement is even."""
    nib = len(getattr(model, "ib", ()))
    if not nib or bin_size <= 1:
        return 0
    return (-nib) % bin_size


def pad_state_bins(model, state, bin_size: int):
    """Zero-pad every per-bin state axis (size nib) to the next multiple of
    the mesh ``bin`` axis. Padded lanes carry zeros; they are sliced off
    again before the model's ``_forward`` runs, so they never enter the
    per-bin math. Works inside and outside jit."""
    nib = len(getattr(model, "ib", ()))
    pad = _bin_pad(model, bin_size)
    if pad == 0:
        return state

    def pad_leaf(leaf):
        for i in range(1, np.ndim(leaf)):
            if leaf.shape[i] == nib:
                widths = [(0, 0)] * leaf.ndim
                widths[i] = (0, pad)
                return jnp.pad(leaf, widths)
        return leaf

    return jax.tree.map(pad_leaf, state)


def unpad_state_bins(model, state, bin_size: int):
    """Inverse of :func:`pad_state_bins`: slice padded per-bin axes back to
    the model's true in-band bin count."""
    nib = len(getattr(model, "ib", ()))
    pad = _bin_pad(model, bin_size)
    if pad == 0:
        return state
    nib_pad = nib + pad

    def unpad_leaf(leaf):
        for i in range(1, np.ndim(leaf)):
            if leaf.shape[i] == nib_pad:
                return jax.lax.slice_in_dim(leaf, 0, nib, axis=i)
        return leaf

    return jax.tree.map(unpad_leaf, state)


def state_partition_specs(model, state, mesh: Mesh | None = None):
    """PartitionSpecs for a model's batched carried state: leading axis is
    the ``stream`` (data-parallel) axis; the axis matching the model's
    in-band bin count is the ``bin`` (tensor-parallel) axis — MVDR/LCMV FFT
    histories (B, W, M, Nib) and GSS demixing stacks (B, Nib, S, M) are
    per-bin independent (mvdr.cpp:77-105), the textbook bin-sharded state.

    A bin count not divisible by the mesh's ``bin`` axis is handled by
    zero-padding the stored state up to the axis size
    (:func:`pad_state_bins`, applied by :func:`sharded_state_init`);
    specs therefore match either the raw or the padded bin axis.
    """
    nib = len(getattr(model, "ib", ()))
    bin_size = _bin_axis_size(mesh)
    nib_pad = nib + _bin_pad(model, bin_size)
    shard_sizes = {s for s in (nib, nib_pad)
                   if s and bin_size > 1 and s % bin_size == 0}

    def spec_of(leaf):
        dims = [None] * leaf.ndim
        if leaf.ndim:
            dims[0] = "stream"
        for i in range(1, leaf.ndim):
            if leaf.shape[i] in shard_sizes:
                dims[i] = "bin"
                break
        return P(*dims)

    return jax.tree.map(spec_of, state)


def sharded_state_init(mesh: Mesh, model, batch: int):
    """The model's batched carried state, placed over the mesh.

    When the in-band bin count does not divide the mesh ``bin`` axis, the
    per-bin axes are zero-padded up to it so the state is genuinely
    bin-sharded (not replicated); :func:`sharded_batched_step` slices the
    padding off before the model's math and restores it after."""
    state = pad_state_bins(model, model.batched_state_init(batch),
                           _bin_axis_size(mesh))
    specs = state_partition_specs(model, state, mesh)

    return jax.tree.map(lambda leaf, s: _place_global(mesh, leaf, s),
                        state, specs)


def _place_global(mesh: Mesh, value, spec):
    """Place a value that every process holds in full: each process puts
    only its addressable shards (a device_put onto a global NamedSharding
    would demand identical values from every process, and NaN never
    compares equal)."""
    host = np.asarray(value)
    return jax.make_array_from_callback(
        host.shape, NamedSharding(mesh, spec), lambda idx: host[idx])


def _broadcast_thetas(thetas, b: int, t: int):
    th = np.asarray(thetas, dtype=np.float64)
    if th.ndim == 0:
        th = np.full((b, t), float(th))
    elif th.ndim == 1:
        th = np.repeat(th[:, None], t, axis=1)
    return th


def sharded_batched_step(mesh: Mesh, model, x_batch, thetas, state):
    """One batched chunk of a REAL model over the (stream, bin) mesh.

    This shards the models' own ``_forward`` (the same code path the
    parity suite proves ≤1e-9 against the oracle). On a mesh without a bin
    axis every device runs its local streams through the model, with no
    collective at all (``shard_map``). With a bin axis, per-bin state
    rides it and XLA partitions the per-bin math, inserting the bin
    all-gather at the iFFT boundary.

    x_batch (B, M, S); thetas scalar | (B,) | (B, T). Returns
    (out (B, S), new_state) with the same shardings as the inputs.
    """
    rdtype = model.rdtype
    bin_size = _bin_axis_size(mesh)
    state = pad_state_bins(model, state, bin_size)  # no-op if already padded
    x = jnp.asarray(x_batch, dtype=rdtype)
    b = x.shape[0]
    t = x.shape[-1] // model.engine.hop
    th = _broadcast_thetas(thetas, b, t)
    ctrl = model.batch_controls(th)

    in_axes = (0,) + tuple(model.batch_axes) + (0,)
    vfn = jax.vmap(model._forward, in_axes=in_axes)

    def fn(xb, *rest):
        # slice any sharding pad off the per-bin state axes before the
        # model's math; re-pad the new state so it round-trips with the
        # same (evenly bin-sharded) placement
        *ctrl_args, st_p = rest
        out, st2 = vfn(xb, *ctrl_args,
                       unpad_state_bins(model, st_p, bin_size))
        return out, pad_state_bins(model, st2, bin_size)

    x_spec = P(*(["stream"] + [None] * (x.ndim - 1)))
    ctrl_spec = tuple(
        P(*(["stream"] + [None] * (np.ndim(c) - 1))) if ax == 0 else P()
        for c, ax in zip(ctrl, model.batch_axes))
    st_spec = state_partition_specs(model, state, mesh)
    out_spec = P("stream", None)
    if bin_size == 1:
        # streams are independent: one program per device on its local
        # streams (a hand-written kernel inside needs no partitioning rule)
        fn = jax.shard_map(fn, mesh=mesh,
                           in_specs=(x_spec,) + ctrl_spec + (st_spec,),
                           out_specs=(out_spec, st_spec), check_vma=False)

    def named(spec):
        return NamedSharding(mesh, spec)

    jf = jax.jit(fn, in_shardings=(named(x_spec),)
                 + tuple(map(named, ctrl_spec))
                 + (jax.tree.map(named, st_spec),),
                 out_shardings=(named(out_spec), jax.tree.map(named, st_spec)))
    ctrl = tuple(_place_global(mesh, c, sp) for c, sp in zip(ctrl, ctrl_spec))
    return jf(x, *ctrl, state)


def make_training_state(mesh: Mesh, engine: EngineConfig, batch: int,
                        num_mics: int, num_sources: int, steering):
    """Per-stream, per-bin GSS demixing state W = A^H, sharded (stream, bin).

    ``steering``: (M, nfft) DOI weights; sources beyond the DOI start from
    the same steering column (tiny init asymmetry is irrelevant for a
    compile-check and for cold-start training alike)."""
    np_c = np.complex128 if engine.dtype == "float64" else np.complex64
    n = engine.fft_win
    a_h = np.conj(np.swapaxes(np.asarray(steering).astype(np_c), 0, 1))
    w0 = np.broadcast_to(a_h[None, :, None, :],
                         (batch, n, num_sources, num_mics))
    return jax.device_put(
        w0, NamedSharding(mesh, P("stream", "bin", None, None)))


def sharded_training_step(mesh: Mesh, engine: EngineConfig, params,
                          x_batch, steering, w_state):
    """One full streaming-learning step over the mesh.

    x_batch (B, M, S): a chunk of frames per stream; steering (M, nfft);
    w_state (B, nfft, S_src, M) the learned demixing state.
    Returns (outputs (B, S), new_state, scalar diagnostic).
    """
    rdtype, cdtype = common.dtypes_of(engine)
    window = _np_window(engine)

    x_sh = NamedSharding(mesh, P("stream", None, None))
    w_sh = NamedSharding(mesh, P(None, "bin"))
    st_sh = NamedSharding(mesh, P("stream", "bin", None, None))

    @partial(jax.jit,
             in_shardings=(x_sh, w_sh, st_sh),
             out_shardings=(NamedSharding(mesh, P("stream", None)), st_sh,
                            NamedSharding(mesh, P())))
    def step(xb, w, state):
        from beamform_tpu.dsp.wola import frame_signal, overlap_add
        frames = frame_signal(xb, engine.hop) * window
        spec = jnp.moveaxis(_fft_last(frames.astype(cdtype)), 1, 2)
        spec = _constraint(spec, mesh, P("stream", None, None, "bin"))
        mag = common.mag_mean_over_mics(spec, engine.fft_win)  # (B, T, N)

        a_mat = jnp.swapaxes(w, 0, 1)[:, :, None]         # (N, M, 1) DOI col
        s_src = state.shape[-2]
        a_mat = jnp.broadcast_to(a_mat, a_mat.shape[:-1] + (s_src,))
        a_h = jnp.conj(jnp.swapaxes(a_mat, -1, -2))       # (N, S, M)

        def frame_step(w_sep, inp):
            x_t, mag_t = inp                              # (B, M, N), (B, N)
            gate = mag_t > params.freq_mag_threshold
            w_new, y0 = jax.vmap(gss_update, in_axes=(0, None, None, 0, 0,
                                                      None, None))(
                w_sep, a_mat, a_h, x_t, gate, params.mu, params.lam)
            y_t = jnp.where(gate, y0, x_t[:, 0, :] * 0.01)
            return w_new, y_t

        spec_t = jnp.swapaxes(spec, 0, 1)                 # (T, B, M, N)
        mag_t = jnp.swapaxes(mag, 0, 1)
        state, y = jax.lax.scan(frame_step, state, (spec_t, mag_t))
        y = jnp.swapaxes(y, 0, 1)                         # (B, T, N)
        y = _constraint(y, mesh, P("stream", None, "bin"))
        out = overlap_add(_ifft_last_real(y) * window, engine.hop)
        out = _constraint(out, mesh, P("stream", None))
        # global diagnostic: output power across all streams (forces a psum)
        power = jnp.mean(out ** 2)
        return out, state, power

    return step(jnp.asarray(x_batch, dtype=rdtype),
                jnp.asarray(steering, dtype=cdtype), w_state)
