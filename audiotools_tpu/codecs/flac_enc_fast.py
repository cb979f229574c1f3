"""Batched FLAC encoder: device/vectorized analysis + C++ frame emit.

The production encode path (reference counterpart:
``/root/reference/src/encoders/flac.c:43``): PCM is read in multi-frame
batches and analyzed entirely on device by
``ops.flac_frames.analyze_frames_packed`` — variants, subframe trials,
LPC order sweeps, Rice partition searches, channel assignment and the
final decision gather all run as one jitted program whose only output
is a small packed int32 decision array (one device->host transfer per
batch).  A bounded queue of in-flight batches keeps the device busy
(and a writer thread overlaps emit CPU with device waits) while the
C++ emitter (``_native.atpu_flac_emit_frames2``) serializes earlier
batches from the raw PCM + decisions at memory speed, re-deriving
residuals exactly in int64 (losslessness is independent of analysis
precision).  The final short block goes through the scalar oracle
encoder, which shares the same analysis kernel and is byte-identical
by construction.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import flac_frames, lpc as lpc_ops, pallas_bitpack, qpack
from ..ref import flac_enc as oracle
from ..utils.profiling import stage_timer, profiling_enabled
from .. import _native
from . import padgrid

_jax_analyze_cache = {}
# guards jit-object creation: concurrent submit-pool threads must not
# trigger duplicate XLA compiles of the same program
import threading as _threading
_jax_cache_lock = _threading.Lock()


_default_backend_cache = None


def default_backend():
    """"jax" when a JAX device is reachable, else "numpy"

    the analysis kernels are byte-identical across backends, so this
    only decides where the batched front half runs"""
    global _default_backend_cache
    if _default_backend_cache is None:
        try:
            import jax
            jax.devices()
            _default_backend_cache = "jax"
        except Exception:
            _default_backend_cache = "numpy"
    return _default_backend_cache


def _get_backend(backend):
    if backend is None:
        backend = os.environ.get("ATPU_FLAC_BACKEND") or \
            default_backend()
    return backend


# per-thread device pin: the farm's per-device queues
# (parallel/farm.py) set this so each worker's encodes dispatch to
# its own mesh device — track-level data parallelism without the
# analysis program itself communicating (the device form of the
# reference's fork-per-track queue)
_device_override = _threading.local()


def set_thread_device(device):
    """pins this thread's jax dispatches to a specific device
    (None clears the pin)"""
    _device_override.device = device


def _jax_device():
    """resolves the target JAX device (per-thread pin, then
    ATPU_JAX_PLATFORM)"""
    pinned = getattr(_device_override, "device", None)
    if pinned is not None:
        return pinned
    import jax
    platform = os.environ.get("ATPU_JAX_PLATFORM")
    if platform:
        return jax.devices(platform)[0]
    return None


_cache_enabled = False

# the compile cache's default home: inside the checkout, at a fixed
# path (the path is part of the cache key)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def _enable_compilation_cache(jax):
    """points JAX at a persistent compilation cache (idempotent)

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and is
    left alone; otherwise the cache lives in DEFAULT_CACHE_DIR."""
    global _cache_enabled
    if _cache_enabled:
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _cache_enabled = True


def _n_devices():
    """devices to shard encode batches over (ATPU_DEVICES, default 1)"""
    return max(int(os.environ.get("ATPU_DEVICES", "1")), 1)


def _pad_grid_enabled():
    """final-batch shape grid (see padgrid); default on"""
    return padgrid.enabled()


def _analyze_jax(blocks, stereo_trial, bps_scalar, n, K, precision,
                 porders, max_rice, exhaustive, mid_side, window,
                 n_devices=1):
    """jitted packed device analysis; cached per static configuration

    blocks: [B, n, ch] int16 (bps <= 16) or int32; everything through
    channel assignment and decision packing runs on device, so the
    host fetches a single [B, 1 + max_subframes*W] int32 array.

    With n_devices > 1 the batch axis is sharded over a 1-D Mesh —
    frames never communicate (the codec's blockwise independence, the
    device replacement for the reference's fork-per-track queue) —
    and the contraction-immune numeric spec guarantees the sharded
    decisions equal the host backend's bit for bit."""
    import jax
    jax.config.update("jax_enable_x64", True)
    _enable_compilation_cache(jax)

    key = (blocks.shape, blocks.dtype.str, stereo_trial, bps_scalar, n,
           K, precision, tuple(porders), max_rice, exhaustive,
           mid_side, n_devices, flac_frames._rice_mode())
    with _jax_cache_lock:
      if key not in _jax_analyze_cache:
        import jax.numpy as jnp

        def run(blocks, window):
            # flattened output: one bulk device->host fetch, which
            # the caller reshapes (multi-dim jit outputs can take a
            # slow per-row conversion path on some backends).
            # compact_decisions shrinks the fetch 3.5x on device.
            packed = flac_frames.analyze_frames_packed(
                jnp, blocks, stereo_trial, bps_scalar, n, K, precision,
                list(porders), max_rice, exhaustive, mid_side, window)
            max_subframes = 2 if stereo_trial else blocks.shape[2]
            return flac_frames.compact_decisions(
                jnp, packed, max_subframes, K,
                1 << porders[-1]).ravel()

        if n_devices > 1:
            from ..parallel.mesh import make_mesh
            from jax.sharding import NamedSharding, PartitionSpec as P
            mesh = make_mesh(n_devices)
            data = NamedSharding(mesh, P("blocks"))
            replicated = NamedSharding(mesh, P())
            _jax_analyze_cache[key] = jax.jit(
                run, in_shardings=(data, replicated),
                out_shardings=replicated)
        else:
            _jax_analyze_cache[key] = jax.jit(run)
    device = _jax_device()
    if device is not None and n_devices == 1:
        blocks = jax.device_put(blocks, device)
        window = _window_on_device(window, device)
    # async dispatch: the caller fetches the packed array later,
    # letting the device overlap with host-side serialization
    return _jax_analyze_cache[key](blocks, window)


def _analyze_jax_pallas(blocks, stereo_trial, bps_scalar, n, K,
                        precision, porders, max_rice, exhaustive,
                        mid_side, window, n_words):
    """jitted analysis + DEVICE residual packing (ATPU_PALLAS=1)

    One program produces both the packed decisions and the chosen
    subframes' residual partition blocks as bit-exact u32 word lanes
    (ops/pallas_bitpack.py prefix sum + XLA scatter-add), so the
    host emitter splices bits instead of re-deriving and serializing
    residuals — the Rice pack, the dominant host emit cost, moves to
    the device.  Requires exact uploads (no qpack wire: the device
    must see the true samples to pack true residuals).

    returns a (compact_decisions, words, bits, ok) handle tuple."""
    import jax
    jax.config.update("jax_enable_x64", True)
    _enable_compilation_cache(jax)

    key = ("pallas", blocks.shape, blocks.dtype.str, stereo_trial,
           bps_scalar, n, K, precision, tuple(porders), max_rice,
           exhaustive, mid_side, n_words, flac_frames._rice_mode())
    with _jax_cache_lock:
      if key not in _jax_analyze_cache:
        import jax.numpy as jnp

        P = 1 << porders[-1]

        def run(blocks, window):
            (packed, chosen) = flac_frames.analyze_frames_packed(
                jnp, blocks, stereo_trial, bps_scalar, n, K, precision,
                list(porders), max_rice, exhaustive, mid_side, window,
                return_chosen=True)
            max_subframes = 2 if stereo_trial else blocks.shape[2]
            compact = flac_frames.compact_decisions(
                jnp, packed, max_subframes, K, P).ravel()
            (words, bits, ok) = pallas_bitpack.pack_chosen_residuals(
                jnp, chosen, n, bps_scalar, stereo_trial, P, n_words)
            return (compact, words, bits, ok)

        _jax_analyze_cache[key] = jax.jit(run)
    device = _jax_device()
    if device is not None:
        blocks = jax.device_put(blocks, device)
        window = _window_on_device(window, device)
    return _jax_analyze_cache[key](blocks, window)


_device_window_cache = {}


def _window_on_device(window, device):
    """caches the constant analysis window (a host-split (hi, lo)
    pair) on the target device so each batch skips one host->device
    transfer"""
    import jax
    key = (id(window), window[0].shape[0], repr(device))
    if key not in _device_window_cache:
        _device_window_cache[key] = jax.device_put(window, device)
    return _device_window_cache[key]


def _analyze_jax_q(wire, k, W, ch, V, stereo_trial, bps_scalar,
                   n, K, precision, porders, max_rice, exhaustive,
                   mid_side, window, n_devices=1, E=0):
    """jitted quantized-upload analysis (ops/qpack.py wire format)

    wire: uint32 [B, ch*W (+ 2*ch*E) + 2*ch + 2*V] — ONE consolidated
    upload per batch (each device_put pays a fixed transfer cost): the
    first ch*W columns are the bit-packed zigzag diffs (k bits each),
    then (patched-base wire, E > 0) ch*E exception positions and ch*E
    full-width exception values, then the bitcast int32 sideband
    [t(ch), x0(ch), or_vals(V), const_flags(V)].  The device
    reconstructs the quantized samples exactly (integer gathers,
    exception scatter, cumsum) and analyzes them — typically 2-3x
    fewer host->device bytes than raw int16."""
    import jax
    jax.config.update("jax_enable_x64", True)
    _enable_compilation_cache(jax)

    key = ("q", wire.shape, k, W, ch, V, stereo_trial, bps_scalar, n,
           K, precision, tuple(porders), max_rice, exhaustive,
           mid_side, n_devices, E, flac_frames._rice_mode())
    with _jax_cache_lock:
      if key not in _jax_analyze_cache:
        import jax.numpy as jnp
        from jax import lax

        def run(wire, window):
            qwords = wire[:, :ch * W].reshape(-1, ch, W)
            off = ch * W
            if E > 0:
                exc_pos = lax.bitcast_convert_type(
                    wire[:, off:off + ch * E],
                    jnp.int32).reshape(-1, ch, E)
                exc_val = wire[:, off + ch * E:
                               off + 2 * ch * E].reshape(-1, ch, E)
                off += 2 * ch * E
            else:
                exc_pos = exc_val = None
            meta = lax.bitcast_convert_type(wire[:, off:],
                                            jnp.int32)
            t = meta[:, 0:ch]
            x0 = meta[:, ch:2 * ch]
            or_vals = meta[:, 2 * ch:2 * ch + V]
            const_flags = meta[:, 2 * ch + V:] != 0
            blocks = qpack.unpack(jnp, qwords, k, t, x0, n,
                                  exc_pos, exc_val)
            packed = flac_frames.analyze_frames_packed(
                jnp, blocks, stereo_trial, bps_scalar, n, K, precision,
                list(porders), max_rice, exhaustive, mid_side, window,
                or_vals=or_vals, const_flags=const_flags)
            max_subframes = 2 if stereo_trial else ch
            return flac_frames.compact_decisions(
                jnp, packed, max_subframes, K,
                1 << porders[-1]).ravel()

        if n_devices > 1:
            from ..parallel.mesh import make_mesh
            from jax.sharding import NamedSharding, PartitionSpec as P
            mesh = make_mesh(n_devices)
            data = NamedSharding(mesh, P("blocks"))
            replicated = NamedSharding(mesh, P())
            _jax_analyze_cache[key] = jax.jit(
                run, in_shardings=(data, replicated),
                out_shardings=replicated)
        else:
            _jax_analyze_cache[key] = jax.jit(run)
    device = _jax_device()
    if device is not None and n_devices == 1:
        wire = jax.device_put(wire, device)
        window = _window_on_device(window, device)
    return _jax_analyze_cache[key](wire, window)


def encode_flac_fast(file_or_path,
                     pcmreader,
                     block_size=4096,
                     max_lpc_order=8,
                     min_residual_partition_order=0,
                     max_residual_partition_order=5,
                     mid_side=True,
                     adaptive_mid_side=False,
                     exhaustive_model_search=False,
                     disable_verbatim_subframes=False,
                     disable_constant_subframes=False,
                     disable_fixed_subframes=False,
                     disable_lpc_subframes=False,
                     padding_size=4096,
                     batch_frames=None,
                     backend=None,
                     pipeline_depth=None):
    """encodes a FLAC file from a PCMReader (batched fast path)

    returns a list of (byte_offset, pcm_frames) pairs per FLAC frame"""
    from ..pcmstream import BufferedPCMReader

    backend = _get_backend(backend)
    if batch_frames is None:
        # big batches amortize device dispatch latency and per-batch
        # host overheads; short tracks pad on the {B/8, B/4, B/2, B}
        # grid so farm-sized files see the same shapes as full
        # batches.  The host path keeps working sets cache-sized.
        # (1024 is a default, not a measured optimum on a GPU.)
        batch_frames = int(os.environ.get(
            "ATPU_FLAC_BATCH", "1024" if backend == "jax" else "32"))
    if pipeline_depth is None:
        # depth 4 keeps several batches in flight, so dispatch and
        # transfer latency hide under host work
        pipeline_depth = int(os.environ.get(
            "ATPU_FLAC_PIPELINE", "4" if backend == "jax" else "1"))
    bps = pcmreader.bits_per_sample
    channels = pcmreader.channels
    sample_rate = pcmreader.sample_rate
    max_rice = 14 if bps <= 16 else 30

    options = oracle.EncodingOptions(
        block_size, max_lpc_order,
        adaptive_mid_side, mid_side, exhaustive_model_search,
        min_residual_partition_order, max_residual_partition_order,
        max_rice)
    precision = options.qlp_precision

    stereo_trial = (channels == 2) and (mid_side or adaptive_mid_side)
    max_subframes = 2 if stereo_trial else channels
    porders = flac_frames.valid_partition_orders(
        block_size, max_residual_partition_order, max(max_lpc_order, 4))
    window = lpc_ops.tukey_window_df(block_size)
    Kp = max(max_lpc_order, 1)
    P = 1 << porders[-1]

    if isinstance(file_or_path, str):
        output_file = open(file_or_path, "wb")
        close_file = True
    else:
        output_file = file_or_path
        close_file = False

    # ---- metadata headers (placeholder STREAMINFO) --------------------
    output_file.write(b"fLaC")
    header = oracle.TokenStream()
    header.write(1, 1 if padding_size is None else 0)
    header.write(7, 0)
    header.write(24, 34)
    output_file.write(header.to_bytes())
    streaminfo_offset = output_file.tell()
    output_file.write(b"\x00" * 34)
    if padding_size is not None:
        pad = oracle.TokenStream()
        pad.write(1, 1)
        pad.write(7, 1)
        pad.write(24, padding_size)
        output_file.write(pad.to_bytes())
        output_file.write(b"\x00" * padding_size)

    prof = stage_timer("flac_enc_fast[%s]" % backend)

    reader = BufferedPCMReader(pcmreader)
    stream_md5 = _native.MD5()
    total_pcm_frames = 0
    min_frame = (1 << 24) - 1
    max_frame = 0
    frame_number = 0          # frames emitted so far
    submitted_frames = 0      # frames submitted to analysis so far
    current_offset = 0
    frame_offsets = []

    n_devices = _n_devices()

    # device residual packing (ATPU_PALLAS=1): the analysis program
    # also emits the chosen subframes' residual partition blocks as
    # packed u32 word lanes, and the host emitter splices bits instead
    # of serializing Rice codes.  Needs exact uploads (quantized
    # samples would pack wrong residuals), so it supersedes qpack.
    use_pallas = (pallas_bitpack.enabled() and backend == "jax" and
                  bps <= 25)
    rb_stride = pallas_bitpack.residual_words_capacity(
        block_size, bps + (1 if stereo_trial else 0), P)

    # zigzag first-differences need up to bps + 2 bits; the two-word
    # wire format caps at 31, so streams deep enough to overflow it
    # (e.g. 32-bit PCM) fall back to exact uploads instead of
    # producing corrupt quantized samples
    use_qpack = (qpack.enabled() and (bps + 2 <= 31) and
                 not use_pallas)
    qguard = qpack.guard_bits()
    # patched-base wire state (ATPU_QPACK_PATCH, default on): diffs
    # pack at a base width below the batch max, the rare wider values
    # ride as (position, value) exceptions.  The diff distribution's
    # mean bit length sits 2-3 bits under its max, so the base width
    # sets the upload size.  (k_base, E) adapt per batch: start
    # one grid step below the plain width, retry on exception
    # overflow, probe a step lower every PATCH_PROBE_EVERY batches.
    use_qpatch = (use_qpack and
                  os.environ.get("ATPU_QPACK_PATCH", "1") != "0")
    qpatch_state = {"kb": None, "E": qpack.E_GRID[0], "since": 0}
    PATCH_PROBE_EVERY = 16

    def _pad_rows(arrays):
        """pads leading dims up to a small STATIC grid of batch shapes
        ({batch//8, batch//4, batch//2, batch}); extra rows are
        dropped after the fetch

        fixed shapes matter more than the wasted rows: a final batch
        of B < batch_frames blocks would otherwise compile a fresh
        XLA program per distinct track length; see codecs/padgrid.py
        (shared with ALAC,
        ATPU_PAD_GRID=0 restores full-batch padding)."""
        B = arrays[0].shape[0]
        target = (padgrid.target_rows(B, batch_frames)
                  if backend == "jax" else B)
        if n_devices > 1 and target % n_devices:
            target += n_devices - (target % n_devices)
        if target > B:
            pad = target - B
            arrays = [np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], dtype=a.dtype)])
                for a in arrays]
        return arrays

    def _qpack_wire(blocks):
        """builds the consolidated qpack upload columns; adaptive
        patched-base wire when profitable (see use_qpatch note)

        returns (wire_parts, k, W, E, t, orv) where E = 0 means the
        plain format"""
        n_rows = blocks.shape[1]
        st = qpatch_state
        st["since"] += 1
        probe = st["since"] >= PATCH_PROBE_EVERY or st["kb"] is None
        if probe:
            st["since"] = 0
        try_patched = (use_qpatch and n_rows > 1 and
                       (not st.get("plain") or probe))
        # stream MD5 folds into the FIRST C++ scan over this batch
        # (the scan walks every sample cache-hot anyway; a separate
        # md5 pass re-reads ~17 MB per 1024-block batch) — retries
        # and probe re-scans pass None so each sample folds once
        folded = {"done": False}

        def _md5_arg():
            if folded["done"]:
                return None
            folded["done"] = True
            return stream_md5

        if try_patched:
            def attempt(kb_req, E):
                """one patched-base attempt with overflow retries;
                returns the raw columns plus a profitability flag
                (base-width saving beats the patch columns: each
                exception slot is 2 uint32 columns; per-channel, so
                ch cancels on both sides)"""
                for _attempt in range(4):
                    (qwords, k_full, t, x0, orv, cflags, epos, evals,
                     mexc, kb) = _native.flac_qpack_patched(
                        blocks, bps, qguard, stereo_trial, kb_req, E,
                        md5=_md5_arg())
                    if mexc <= E:
                        break
                    # overflow: grow E, then widen the base
                    bigger = [e for e in qpack.E_GRID if e > E]
                    if bigger:
                        E = bigger[0]
                    else:
                        E = qpack.E_GRID[0]
                        above = [g for g in qpack.K_GRID
                                 if g > (kb if kb_req is None
                                         else kb_req)]
                        kb_req = above[0] if above else k_full
                W_plain = ((n_rows - 1) * k_full + 31) // 32 + 1
                W = qwords.shape[2]
                ok = (mexc <= E and (W_plain - W) > 2 * E and
                      kb < k_full)
                return (ok, qwords, k_full, t, x0, orv, cflags, epos,
                        evals, kb, W, E)

            kb_known = st["kb"]
            kb_req = kb_known
            if kb_req is not None and probe:
                # periodic probe one grid step lower
                below = [g for g in qpack.K_GRID if g < kb_req]
                if below:
                    kb_req = below[-1]
            res = attempt(kb_req, st["E"])
            if (not res[0] and probe and kb_known is not None and
                    kb_req != kb_known and not st.get("plain")):
                # unprofitable probe: retry at the previous
                # known-good width before falling back to the plain
                # format — the pre-probe (kb, E) configuration may
                # still win this batch (it won every prior one)
                res = attempt(kb_known, st["E"])
            (ok, qwords, k_full, t, x0, orv, cflags, epos, evals,
             kb, W, E) = res
            if ok:
                st["kb"] = kb
                st["E"] = E
                st["plain"] = False
                meta = np.concatenate(
                    [t, x0, orv, cflags.astype(np.int32)],
                    axis=1).astype(np.int32)
                B = qwords.shape[0]
                parts = [qwords.reshape(B, -1),
                         epos.reshape(B, -1).view(np.uint32),
                         evals.reshape(B, -1),
                         meta.view(np.uint32)]
                return (parts, kb, W, E, t, orv)
            # not profitable here: remember the plain choice and fall
            # through (probe again after PATCH_PROBE_EVERY batches)
            st["kb"] = k_full
            st["E"] = qpack.E_GRID[0]
            st["plain"] = True
        (qwords, k, t, x0, orv, cflags) = _native.flac_qpack(
            blocks, bps, qguard, stereo_trial, md5=_md5_arg())
        meta = np.concatenate(
            [t, x0, orv, cflags.astype(np.int32)],
            axis=1).astype(np.int32)
        B = qwords.shape[0]
        parts = [qwords.reshape(B, -1), meta.view(np.uint32)]
        return (parts, k, qwords.shape[2], 0, t, orv)

    def prepare(blocks):
        """host half of a batch submission: the qpack scan and wire
        assembly.  Returns the payload the submit thread turns into a
        device dispatch — the main thread never blocks on the device.
        The stream MD5 folds into the first C++ scan over the batch
        (cache-hot samples; a dedicated md5 pass would re-read ~17 MB
        per 1024-block batch) — order is preserved
        because prepare runs on the main thread in read order; paths
        without a native scan hash explicitly here."""
        if backend == "jax":
            if use_qpack:
                with prof("qpack"):
                    (wire_parts, k, W, E, t, orv) = _qpack_wire(blocks)
                    wire = np.concatenate(wire_parts, axis=1)
                    (wire,) = _pad_rows([wire])
                    return (("q", wire, k, W, E, orv.shape[1]), t)
            else:
                with prof("md5"):
                    stream_md5.update_pcm(
                        blocks.reshape(-1, channels), bps)
                upload = (blocks.astype(np.int16) if bps <= 16
                          else blocks)
                (upload,) = _pad_rows([upload])
                return (("raw", upload), None)
        if use_qpack:
            # same spec, no wire format: analysis sees (x >> t) << t
            # plus the exact sideband
            (_qw, _k, t, _x0, orv, cflags) = _native.flac_qpack(
                blocks, bps, qguard, stereo_trial, md5=stream_md5)
            return (("np_q", qpack.quantize(np, blocks, t), orv,
                     cflags), t)
        with prof("md5"):
            stream_md5.update_pcm(blocks.reshape(-1, channels), bps)
        return (("np", blocks), None)

    def dispatch(payload):
        """device (or numpy) half of a batch submission; runs in the
        submit thread so device_put transfers and jit dispatch never
        stall the reader"""
        tag = payload[0]
        if tag == "q":
            (_tag, wire, k, W, E, V) = payload
            with prof("submit"):
                return _analyze_jax_q(
                    wire, k, W, channels, V,
                    stereo_trial, bps, block_size, max_lpc_order,
                    precision, porders, max_rice,
                    exhaustive_model_search, mid_side, window,
                    n_devices, E)
        elif tag == "raw":
            if use_pallas:
                with prof("submit"):
                    return _analyze_jax_pallas(
                        payload[1], stereo_trial, bps, block_size,
                        max_lpc_order, precision, porders, max_rice,
                        exhaustive_model_search, mid_side, window,
                        rb_stride)
            with prof("submit"):
                return _analyze_jax(payload[1], stereo_trial, bps,
                                    block_size, max_lpc_order,
                                    precision, porders, max_rice,
                                    exhaustive_model_search,
                                    mid_side, window, n_devices)
        elif tag == "np_q":
            (_tag, analysis_blocks, orv, cflags) = payload
            return flac_frames.analyze_frames_packed(
                np, analysis_blocks, stereo_trial, bps, block_size,
                max_lpc_order, precision, porders, max_rice,
                exhaustive_model_search, mid_side, window,
                or_vals=orv, const_flags=cflags)
        else:
            return flac_frames.analyze_frames_packed(
                np, payload[1], stereo_trial, bps, block_size,
                max_lpc_order, precision, porders, max_rice,
                exhaustive_model_search, mid_side, window)

    packed_sub_width = flac_frames.packed_width(max_lpc_order, P)
    row_width = 1 + max_subframes * packed_sub_width
    compact_row_width = 1 + max_subframes * flac_frames.compact_width(
        max_lpc_order, P)

    def fetch(handle):
        """single device->host sync of a packed decision array"""
        if isinstance(handle, np.ndarray):
            return handle
        import jax
        # device_get: one bulk transfer (np.asarray may convert jit
        # outputs chunk by chunk)
        return jax.device_get(handle)

    # ------------------------------------------------------------------
    # four-stage pipeline:
    #   main thread:   read + qpack/MD5 scans (serial by spec); also
    #                  owns ORDER — it enqueues each batch's result
    #                  slot to the writer before handing the dispatch
    #                  job to the pools, so pool completion order
    #                  never matters
    #   submit pool:   device_put + jit dispatch; dispatches issued
    #                  from separate threads may overlap their
    #                  uploads
    #   fetch pool:    device->host decision downloads, concurrent
    #                  across threads
    #   writer thread: emit + file write, in submission order.
    # The device waits and the ctypes kernels all release the GIL, so
    # the stages overlap: transfers ride under host CPU and vice
    # versa.  The bounded
    # queues are the pipeline-depth backpressure.
    import queue as queue_mod
    import threading

    n_submitters = (int(os.environ.get("ATPU_FLAC_SUBMIT_THREADS",
                                       "2"))
                    if backend == "jax" else 1)
    submit_queue = queue_mod.Queue(maxsize=max(pipeline_depth, 1))
    writer_queue = queue_mod.Queue(maxsize=max(pipeline_depth, 1))
    fetch_queue = queue_mod.Queue()
    writer_error = []

    CW = flac_frames.compact_width(max_lpc_order, P)

    def _sub_fields(packed, s):
        """per-subframe decision columns from compact or standard
        rows: (choice, wasted, order, porder, shift, qlp [B, Kp],
        rice [B, P])"""
        B = packed.shape[0]
        if packed.shape[1] == compact_row_width:
            Kp2 = (Kp + 1) // 2
            base = 1 + s * CW
            w0 = packed[:, base].astype(np.uint32)
            choice = (w0 & 0xF).astype(np.int32)
            wasted = ((w0 >> 4) & 0x3F).astype(np.int32)
            order = ((w0 >> 10) & 0x3F).astype(np.int32)
            porder = ((w0 >> 16) & 0xF).astype(np.int32)
            shift = ((w0 >> 20) & 0x1F).astype(np.int32)
            qw = packed[:, base + 1:base + 1 + Kp2].astype(np.uint32)
            qlp = np.stack(
                [(qw >> (16 * h)) & 0xFFFF for h in range(2)],
                axis=2).reshape(B, -1)[:, :Kp].astype(
                    np.uint16).astype(np.int16).astype(np.int32)
            rw = packed[:, base + 1 + Kp2:base + CW].astype(np.uint32)
            rice = np.stack(
                [(rw >> (8 * b)) & 0xFF for b in range(4)],
                axis=2).reshape(B, -1)[:, :P].astype(np.int32)
        else:
            base = 1 + s * packed_sub_width
            choice = packed[:, base]
            wasted = packed[:, base + 1]
            order = packed[:, base + 2]
            porder = packed[:, base + 3]
            shift = packed[:, base + 4]
            qlp = packed[:, base + 6:base + 6 + Kp]
            rice = packed[:, base + 6 + Kp:base + 6 + Kp + P]
        return (choice, wasted, order, porder, shift, qlp, rice)

    def _floor_stage1_thr(packed, t_arr, blocks):
        """stage 1 of the quantization-floor retry spec: frames whose
        quantized analysis MAY be floor limited — the true content
        possibly more predictable than the wire showed (pure tones
        cost ~80% compression under quantized analysis, noise
        ~0.15%).  A candidate frame has a coded subframe where EVERY
        used partition's Rice parameter sits at or below the
        quantization shift + 1 (its residuals may be mostly
        quantization noise: noise at step 2^t codes at r in
        {t-1, t, t+1}, and genuinely tonal frames land in the same
        band — measured on the reference's libFLAC sweep fixtures,
        whose frames sit at r == t and were missed by the original
        strictly-below rule).

        Stage 2 (the probe — exact samples through the quantized-fit
        predictor, tonal iff mean-|residual| bits <= t_base - 2 with
        t_base the plan WITHOUT the noise-adaptive extra) runs FOR
        FREE inside the C++ emitter from the exact residuals it
        derives anyway (hostkernels flac_emit_frames_impl probe_thr/
        probe_out; the scalar oracle applies the identical two-stage
        rule in ref/flac_analysis.analyze_frame).

        returns int32 [B] per-frame probe thresholds (t_base - 2 for
        candidates, -1 for never), or None when no frame qualifies"""
        B = packed.shape[0]
        cand = np.zeros(B, dtype=bool)
        t_frame = t_arr[:B].max(axis=1)
        if qpack.noise_extra() == 0:
            t_base = t_frame         # adaptive coarsening off
        else:
            # BASE plan (noise extra removed) from the C++ scan —
            # same spec as qpack.plan_t(extra=0) but ~40x cheaper
            # (the numpy form was the pipeline's largest CPU sink)
            t_base = _native.flac_qplan_t(
                blocks, bps, noise_extra=0).max(axis=1)
        pidx = np.arange(P, dtype=np.int32)[None, :]
        for s in range(max_subframes):
            (choice, _w, _o, porder, _sh, _q, rice) = _sub_fields(
                packed, s)
            used = pidx < (1 << porder)[:, None]
            rmax = np.where(used, rice, -1).max(axis=1)
            coded = (choice == 2) | (choice == 3)
            cand |= coded & (rmax <= t_frame + 1) & (t_frame > 0)
        if not cand.any():
            return None
        return np.where(cand, t_base - 2, -1).astype(np.int32)

    def restitch_floor(blocks, flags, first_frame, frame_bytes,
                       lens):
        """re-analyzes probe-flagged frames EXACTLY (host, no
        quantization), re-emits just those frames, and splices their
        bytes over the already-emitted batch output"""
        idx = np.nonzero(flags)[0]
        sub = np.ascontiguousarray(blocks[idx])
        exact = np.asarray(flac_frames.analyze_frames_packed(
            np, sub, stereo_trial, bps, block_size, max_lpc_order,
            precision, porders, max_rice, exhaustive_model_search,
            mid_side, window)).reshape(-1, row_width)
        fn = (first_frame + idx).astype(np.int64)
        (bytes_b, lens_b) = _native.flac_emit_frames2(
            sub, fn, np.full(len(idx), block_size, dtype=np.int32),
            exact, max_subframes, Kp, P, sample_rate, bps, channels,
            precision)
        pieces = []
        out_lens = np.empty(len(lens), dtype=np.int64)
        (oa, ob, ib) = (0, 0, 0)
        for f in range(len(lens)):
            if flags[f]:
                ln = int(lens_b[ib]); ib += 1
                pieces.append(bytes_b[ob:ob + ln]); ob += ln
                oa += int(lens[f])
            else:
                ln = int(lens[f])
                pieces.append(frame_bytes[oa:oa + ln]); oa += ln
            out_lens[f] = ln
        return (b"".join(pieces), out_lens)

    def emit_exact_retry(blocks, first_frame):
        """fallback for _native.EmitOverflow: the quantized-analysis
        decisions implied unsafe Rice parameters for this batch (a
        partition whose exact content sits below the quantization
        step can analyze as near-constant while its exact residuals
        are large), so re-run the batch through EXACT host analysis —
        identical spec, no quantization — and emit from those
        decisions.  Output stays lossless either way; this only
        trades the rare pathological batch's speed for safety."""
        B = blocks.shape[0]
        packed = np.asarray(flac_frames.analyze_frames_packed(
            np, blocks, stereo_trial, bps, block_size,
            max_lpc_order, precision, porders, max_rice,
            exhaustive_model_search, mid_side,
            window)).reshape(-1, row_width)
        return _native.flac_emit_frames2(
            blocks,
            np.arange(first_frame, first_frame + B, dtype=np.int64),
            np.full(B, block_size, dtype=np.int32),
            packed, max_subframes, Kp, P,
            sample_rate, bps, channels, precision)

    def fetch_loop():
        """fetch-pool worker: blocks on one device->host download at
        a time; concurrency across workers overlaps the transfers"""
        while True:
            job = fetch_queue.get()
            if job is None:
                return
            (handle, slot, done) = job
            try:
                with prof("fetch"):
                    slot.append(("jax", fetch(handle)))
            except BaseException as err:  # noqa: B902
                writer_error.append(err)
            finally:
                done.set()

    def writer_loop():
        nonlocal current_offset, min_frame, max_frame, frame_number
        while True:
            item = writer_queue.get()
            if item is None:
                return
            if writer_error:
                continue                  # drain after a failure
            try:
                if item[0] == "batch":
                    (_tag, slot, done, blocks, first_frame,
                     t_batch) = item
                    with prof("fetch_wait"):
                        done.wait()
                    if writer_error:
                        continue
                    (kind, arr) = slot[0]
                    B = blocks.shape[0]
                    rb_kw = {}
                    if isinstance(arr, tuple):
                        # pallas path: (compact, words, bits, ok)
                        (arr, rb_words, rb_bits, rb_ok) = arr
                        if bool(rb_ok):
                            S = B * max_subframes
                            rb_kw = {"rb_words": rb_words[:S],
                                     "rb_bits": rb_bits[:S]}
                        # ok=False (capacity/clip): exact host retry
                        else:
                            (frame_bytes, lens) = emit_exact_retry(
                                blocks, first_frame)
                            rb_kw = None
                    # device handles carry the 3.5x-smaller compact
                    # row layout; the numpy path keeps standard rows
                    is_compact = (kind == "jax")
                    width = (compact_row_width if is_compact
                             else row_width)
                    if rb_kw is not None:
                        packed = arr.reshape(-1, width)
                        packed = packed[:B]  # drop shard-pad rows
                        probe_thr = probe_out = None
                        if t_batch is not None and not rb_kw:
                            probe_thr = _floor_stage1_thr(
                                packed, t_batch, blocks)
                            if probe_thr is not None:
                                probe_out = np.zeros(B,
                                                     dtype=np.uint8)
                        try:
                            with prof("emit"):
                                (frame_bytes, lens) = \
                                    _native.flac_emit_frames2(
                                        blocks,
                                        np.arange(
                                            first_frame,
                                            first_frame + B,
                                            dtype=np.int64),
                                        np.full(B, block_size,
                                                dtype=np.int32),
                                        packed, max_subframes,
                                        Kp, P, sample_rate, bps,
                                        channels, precision,
                                        compact=is_compact,
                                        probe_thr=probe_thr,
                                        probe_out=probe_out,
                                        **rb_kw)
                            if (probe_out is not None and
                                    probe_out.any()):
                                with prof("floor"):
                                    (frame_bytes, lens) = \
                                        restitch_floor(
                                            blocks,
                                            probe_out.astype(bool),
                                            first_frame,
                                            frame_bytes, lens)
                        except _native.EmitOverflow:
                            (frame_bytes, lens) = emit_exact_retry(
                                blocks, first_frame)
                    with prof("write"):
                        output_file.write(frame_bytes)
                    for length in lens:
                        frame_offsets.append(
                            (current_offset, block_size))
                        current_offset += int(length)
                        min_frame = min(min_frame, int(length))
                        max_frame = max(max_frame, int(length))
                        frame_number += 1
                else:                     # ("bytes", data, pcm_frames)
                    (_tag, frame_bytes, pcm_frames) = item
                    output_file.write(frame_bytes)
                    frame_offsets.append(
                        (current_offset, pcm_frames))
                    current_offset += len(frame_bytes)
                    min_frame = min(min_frame, len(frame_bytes))
                    max_frame = max(max_frame, len(frame_bytes))
                    frame_number += 1
            except BaseException as err:  # noqa: B902
                writer_error.append(err)

    # the caller's device pin (parallel/farm.py) holds in the pool
    pinned_device = getattr(_device_override, "device", None)

    def submit_loop():
        """submit-pool worker: one device dispatch at a time;
        ordering is the main thread's job (it enqueued the result
        slot to the writer before handing the payload here)"""
        set_thread_device(pinned_device)
        while True:
            item = submit_queue.get()
            if item is None:
                return
            (payload, slot, done) = item
            if writer_error:
                done.set()
                continue                  # drain after a failure
            try:
                handle = dispatch(payload)
                if isinstance(handle, np.ndarray):
                    slot.append(("np", handle))   # numpy: ready now
                    done.set()
                else:
                    fetch_queue.put((handle, slot, done))
            except BaseException as err:  # noqa: B902
                writer_error.append(err)
                done.set()

    # stream MD5: hashing is serial BY SPEC (STREAMINFO hashes the
    # PCM in stream order).  Full batches fold into prepare's C++
    # scan while the samples are cache-hot (see prepare); tails hash
    # synchronously on the main thread right after, so stream order
    # is preserved without a worker thread (on this one-core host
    # the dedicated md5 worker cost a full extra ~17 MB read per
    # batch, not overlap).

    writer = threading.Thread(target=writer_loop, daemon=True)
    writer.start()
    submitters = []
    for _ in range(max(n_submitters, 1)):
        worker = threading.Thread(target=submit_loop, daemon=True)
        worker.start()
        submitters.append(worker)
    fetchers = []
    if backend == "jax":
        for _ in range(max(pipeline_depth, 1)):
            worker = threading.Thread(target=fetch_loop, daemon=True)
            worker.start()
            fetchers.append(worker)

    def check_writer():
        if writer_error:
            raise writer_error[0]

    try:
        while True:
            with prof("read"):
                framelist = reader.read(block_size * batch_frames)
            if framelist.frames == 0:
                break
            total_pcm_frames += framelist.frames

            samples = framelist.samples  # int32 [frames, channels]
            n_full = samples.shape[0] // block_size
            full = samples[:n_full * block_size]
            tail = samples[n_full * block_size:]

            if n_full:
                blocks = np.ascontiguousarray(
                    full.reshape(n_full, block_size, channels))
                # prepare's qpack scan also folds these samples into
                # the stream MD5 (order matters: before any tail)
                (payload, t_batch) = prepare(blocks)
                check_writer()
                slot = []
                done = threading.Event()
                with prof("queue_wait"):
                    # writer first (establishes order), then the pool
                    writer_queue.put(
                        ("batch", slot, done, blocks,
                         submitted_frames, t_batch))
                    submit_queue.put((payload, slot, done))
                submitted_frames += n_full
            if tail.shape[0]:
                with prof("md5"):
                    stream_md5.update_pcm(tail, bps)

            if tail.shape[0]:
                # final short block: independent scalar oracle path
                # (byte-identical by spec); ordered via writer_queue
                frame_bytes = oracle.encode_frame(
                    reader, options, submitted_frames,
                    tail.astype(np.int64))
                check_writer()
                writer_queue.put(
                    ("bytes", frame_bytes, tail.shape[0]))
                submitted_frames += 1
    finally:
        with prof("drain"):
            for _ in submitters:
                submit_queue.put(None)
            for worker in submitters:
                worker.join()
            for _ in fetchers:
                fetch_queue.put(None)
            for worker in fetchers:
                worker.join()
            writer_queue.put(None)
            writer.join()
    check_writer()
    prof.report(extra="(%d frames)" % frame_number)

    if max_frame == 0:
        min_frame = (1 << 24) - 1

    output_file.seek(streaminfo_offset, 0)
    output_file.write(oracle.build_streaminfo(
        block_size, block_size, min_frame, max_frame,
        sample_rate, channels, bps, total_pcm_frames,
        stream_md5.digest()))
    if close_file:
        output_file.close()
    else:
        output_file.seek(0, 2)

    return frame_offsets
