"""Device (JAX) WavPack decorrelation backend.

``ATPU_WV_BACKEND=jax`` routes the WavPack encoder's correlation
passes through ``ops/wv_scan.py``: a block's whole pass chain (up to
16 sign-adaptive weight scans) runs as ONE jitted device program;
the byte-serial tail (entropy coder, sub-block framing, CRC) and the
format's block-to-block quantized state chain stay on host —
the same analysis/emit split as the FLAC/ALAC/TTA backends.

Byte-identical to the oracle (``ref/wavpack.py``) and the native
kernels across the roundtrip matrix (tests/test_wavpack.py).
Pathological tiny blocks (shorter than a pass's warm-up span) return
None, falling back to the oracle path for that block.
"""

from __future__ import annotations

import os

import numpy as np

_jit_cache = {}


def enabled():
    return os.environ.get("ATPU_WV_BACKEND", "native") == "jax"


def dec_enabled():
    return os.environ.get("ATPU_WV_DEC_BACKEND", "native") == "jax"


def install():
    """points ref/wavpack's override hooks at the device backends
    (each hook checks its ``enabled()`` per call, so installing is
    unconditional and the env vars stay live)"""
    from ..ref import wavpack as ref_wv
    ref_wv.correlate_channels_override = _correlate_jax
    ref_wv.decorrelate_channels_override = _decorrelate_jax


def _get_jit(chain, cc, n, sample_shapes):
    key = (chain, cc, n, sample_shapes)
    if key in _jit_cache:
        return _jit_cache[key]
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from ..ops import wv_scan

    def run(x, weights, samples):
        return wv_scan.run_pass_chain(jnp, x, chain, weights, samples)

    fn = jax.jit(run)
    _jit_cache[key] = fn
    return fn


def _correlate_jax(uncorrelated, params, channel_count):
    """the correlate_channels override; returns None to fall back"""
    if not enabled():
        return None
    cc = channel_count
    x = np.stack([np.asarray(c, dtype=np.int64)
                  for c in uncorrelated[:cc]], axis=0)
    n = x.shape[1]
    chain = tuple((p.term, p.delta) for p in params)
    if not chain:
        return None
    # warm-up spans must fit inside the block
    max_span = max((t if 1 <= t <= 8 else 2) for (t, _d) in chain)
    if n < max_span:
        return None

    weights = np.zeros((len(params), cc), dtype=np.int64)
    samples = []
    for (p_i, p) in enumerate(params):
        weights[p_i, :] = [int(w) for w in p.weights[:cc]]
        span = len(p.samples[0])
        s = np.zeros((cc, span), dtype=np.int64)
        for c in range(cc):
            s[c, :] = [int(v) for v in p.samples[c]]
        samples.append(s)
    samples = tuple(samples)

    fn = _get_jit(chain, cc, n, tuple(s.shape for s in samples))
    (latest, w_out, s_out) = fn(x, weights, samples)
    latest = np.asarray(latest)
    w_out = np.asarray(w_out)

    for (p_i, p) in enumerate(params):
        p.update_weights([int(v) for v in w_out[p_i][:cc]])
        p.update_samples([[int(v) for v in np.asarray(s_out[p_i])[c]]
                          for c in range(cc)])
    return [latest[c] for c in range(cc)]


def _prep_dec_inputs(parsed):
    """builds the device-dispatch arrays for one parsed block
    (ref/wavpack._parse_block output); returns (key, x, w, samples)
    with key = (chain, cc, n, sample_shapes), or None when the block
    must take the host/per-block fallback (unsupported term,
    degenerate warm-up, >2 channels)"""
    residuals = parsed["residuals"]
    terms = parsed["terms"]
    cc = len(residuals)
    if cc not in (1, 2):
        return None
    x = np.stack([np.asarray(c, dtype=np.int64)
                  for c in residuals[:cc]], axis=0)
    n = x.shape[1]
    chain = tuple(zip(terms, parsed["deltas"]))
    if not chain or n == 0:
        return None
    for (term, _delta) in chain:
        if not (1 <= term <= 8 or term in (17, 18) or
                (-3 <= term <= -1 and cc == 2)):
            return None
    weights = parsed["weights"]
    samples_list = parsed["samples"]
    w = np.zeros((len(chain), cc), dtype=np.int64)
    samples = []
    for (p_i, (term, _delta)) in enumerate(chain):
        w[p_i, :] = [int(v) for v in weights[p_i][:cc]]
        span = len(samples_list[p_i][0]) if samples_list[p_i] else 0
        want = (2 if term in (17, 18)
                else term if 1 <= term <= 8 else 1)
        if span < want:
            return None
        s = np.zeros((cc, span), dtype=np.int64)
        for c in range(min(cc, len(samples_list[p_i]))):
            s[c, :] = [int(v) for v in samples_list[p_i][c]]
        samples.append(s)
    key = (chain, cc, n, tuple(s.shape for s in samples))
    return (key, x, w, tuple(samples))


def _get_dec_vjit(chain, B):
    """vmapped decode-chain program: B independent blocks sharing one
    (chain, cc, n, sample_shapes) signature decorrelate in ONE device
    dispatch (WavPack blocks are self-contained — pure data
    parallelism, byte-identical to the per-block path)"""
    key = ("decv", chain, B)
    if key in _jit_cache:
        return _jit_cache[key]
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from ..ops import wv_scan

    def one(x, weights, samples):
        return wv_scan.run_dec_chain(jnp, x, chain, weights, samples)

    fn = jax.jit(jax.vmap(one))
    _jit_cache[key] = fn
    return fn


def _bucket(count):
    """pad batch sizes to powers of two so distinct group sizes reuse
    compiled programs"""
    b = 1
    while b < count:
        b *= 2
    return b


class BatchedWavPackDecoder:
    """drop-in WavPackDecoder for ``ATPU_WV_DEC_BACKEND=jax``: parses
    ahead up to ``ATPU_WV_DEC_BATCH`` blocks (default 32), entropy-
    decodes them on host, and runs every block sharing a decorrelation
    signature through ONE vmapped device program — amortizing the
    per-dispatch cost that bounds the per-block hook.
    Blocks with unsupported shapes fall back per-block (override →
    host), so output stays byte-identical to the host decoder."""

    def __init__(self, file_or_path):
        from ..ref import wavpack as ref_wv
        self._ref = ref_wv
        self._inner = ref_wv.WavPackDecoder(file_or_path)
        self._queue = []
        self.sample_rate = self._inner.sample_rate
        self.bits_per_sample = self._inner.bits_per_sample
        self.channels = self._inner.channels
        self.channel_mask = self._inner.channel_mask
        self.total_frames = self._inner.total_frames

    def _read_group(self):
        """reads one initial..final block run; returns ([(header,
        parsed)], True) or (partial, False) on EOF mid-group"""
        ref_wv = self._ref
        group = []
        while True:
            try:
                header = ref_wv.Block_Header.read(self._inner.reader)
            except (ValueError, IOError):
                return (group, False)
            sub_blocks = self._inner.reader.read_bytes(
                header.block_size - 24)
            group.append((header,
                          ref_wv._parse_block(header, sub_blocks)))
            if header.final_block == 1:
                return (group, True)

    def read(self, pcm_frames):
        from .. import pcm
        ref_wv = self._ref
        inner = self._inner
        if self._queue:
            return self._queue.pop(0)
        if inner.pcm_finished:
            return inner.read(pcm_frames)   # trailing-MD5 + empty

        max_blocks = int(os.environ.get("ATPU_WV_DEC_BATCH", "32"))
        groups = []
        nblocks = 0
        while (not inner.pcm_finished) and nblocks < max_blocks:
            (group, ok) = self._read_group()
            if not ok:
                # EOF mid-group: the host path drops the partial
                # group and finishes (ref/wavpack.py read())
                inner.pcm_finished = True
                break
            groups.append(group)
            nblocks += len(group)
            h = group[-1][0]
            if (h.block_index + h.block_samples) >= h.total_samples:
                inner.pcm_finished = True
        if not groups:
            return inner.read(pcm_frames)

        # group blocks by decorrelation signature; one vmapped
        # dispatch per signature
        by_key = {}
        prepped = {}
        for (g_i, group) in enumerate(groups):
            for (b_i, (header, parsed)) in enumerate(group):
                if not parsed["terms"]:
                    continue
                pre = _prep_dec_inputs(parsed) if dec_enabled() \
                    else None
                if pre is None:
                    continue
                (key, x, w, samples) = pre
                prepped[(g_i, b_i)] = (x, w, samples)
                by_key.setdefault(key, []).append((g_i, b_i))

        results = {}
        for (key, members) in by_key.items():
            (chain, _cc, _n, _shapes) = key
            B = _bucket(len(members))
            xs = [prepped[m][0] for m in members]
            ws = [prepped[m][1] for m in members]
            ss = [prepped[m][2] for m in members]
            while len(xs) < B:        # pad by repeating block 0
                xs.append(xs[0])
                ws.append(ws[0])
                ss.append(ss[0])
            fn = _get_dec_vjit(chain, B)
            out = np.asarray(fn(
                np.stack(xs, axis=0), np.stack(ws, axis=0),
                tuple(np.stack([s[p] for s in ss], axis=0)
                      for p in range(len(ss[0])))))
            for (m_i, m) in enumerate(members):
                cc = out.shape[1]
                results[m] = [out[m_i, c] for c in range(cc)]

        for (g_i, group) in enumerate(groups):
            channels = []
            for (b_i, (header, parsed)) in enumerate(group):
                if (g_i, b_i) in results:
                    decorrelated = results[(g_i, b_i)]
                elif parsed["terms"]:
                    decorrelated = ref_wv._decorrelate_channels(
                        parsed["residuals"], parsed["terms"],
                        parsed["deltas"], parsed["weights"],
                        parsed["samples"])
                else:
                    decorrelated = parsed["residuals"]
                channels.extend(ref_wv._finish_block(
                    header, parsed, decorrelated))
            out = np.stack([np.asarray(ch, dtype=np.int64)
                            for ch in channels], axis=1)
            framelist = pcm.FrameList._wrap(
                out.astype(np.int32), self.bits_per_sample)
            inner.md5sum.update(framelist.to_bytes(
                False, self.bits_per_sample > 8))
            self._queue.append(framelist)

        if self._queue:
            return self._queue.pop(0)
        return inner.read(pcm_frames)

    def seekable(self):
        return self._inner.seekable()

    def seek(self, pcm_frame):
        self._queue = []
        return self._inner.seek(pcm_frame)

    def close(self):
        self._inner.close()


def _get_dec_jit(chain, cc, n, sample_shapes):
    key = ("dec", chain, cc, n, sample_shapes)
    if key in _jit_cache:
        return _jit_cache[key]
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from ..ops import wv_scan

    def run(x, weights, samples):
        return wv_scan.run_dec_chain(jnp, x, chain, weights, samples)

    fn = jax.jit(run)
    _jit_cache[key] = fn
    return fn


def _decorrelate_jax(residuals, terms, deltas, weights,
                     samples_list):
    """the _decorrelate_channels override (DECODE direction: one
    fused device program inverting a block's whole pass chain);
    returns None to fall back to the host path"""
    if not dec_enabled():
        return None
    cc = len(residuals)
    if cc not in (1, 2):
        return None
    x = np.stack([np.asarray(c, dtype=np.int64)
                  for c in residuals[:cc]], axis=0)
    n = x.shape[1]
    chain = tuple(zip(terms, deltas))
    if not chain or n == 0:
        return None
    for (term, _delta) in chain:
        # the oracle raises 'unsupported term' for anything outside
        # this set — fall back so the error surface stays identical
        # (and negative terms are 2-channel-only)
        if not (1 <= term <= 8 or term in (17, 18) or
                (-3 <= term <= -1 and cc == 2)):
            return None

    w = np.zeros((len(chain), cc), dtype=np.int64)
    samples = []
    for (p_i, (term, _delta)) in enumerate(chain):
        w[p_i, :] = [int(v) for v in weights[p_i][:cc]]
        span = len(samples_list[p_i][0]) if samples_list[p_i] else 0
        want = (2 if term in (17, 18)
                else term if 1 <= term <= 8 else 1)
        if span < want:
            return None         # degenerate warm-up: host path
        s = np.zeros((cc, span), dtype=np.int64)
        for c in range(min(cc, len(samples_list[p_i]))):
            s[c, :] = [int(v) for v in samples_list[p_i][c]]
        samples.append(s)
    samples = tuple(samples)

    fn = _get_dec_jit(chain, cc, n, tuple(s.shape for s in samples))
    out = np.asarray(fn(x, w, samples))
    return [out[c] for c in range(cc)]
