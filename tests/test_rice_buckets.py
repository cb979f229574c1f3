"""The chunk-bucket Rice decoders (lock-step scan and pointer
doubling, jitted) must return the values a bucket was coded from."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from audiotools_tpu.ops import rice_decode  # noqa: E402


def _random_bucket(seed, P, W, C, mix_raw=True):
    """builds a coherent random bucket by ENCODING random codes, so
    every lane's bit stream is valid; returns the bucket and the
    [P, C] values it codes (zeros past each lane's count)"""
    rng = np.random.default_rng(seed)
    N = W * 32
    bits = np.zeros((P, N), dtype=np.uint8)
    base_bits = rng.integers(0, 32, P).astype(np.int32)
    k = rng.integers(0, 8, P).astype(np.int32)
    raw = np.full(P, -1, dtype=np.int32)
    if mix_raw:
        rawsel = rng.random(P) < 0.3
        raw[rawsel] = rng.integers(1, 17, rawsel.sum())
        k[rawsel] = -1
    count = rng.integers(1, C + 1, P).astype(np.int32)
    values = rng.integers(-40, 40, (P, C)).astype(np.int64)
    coded = np.zeros((P, C), dtype=np.int32)

    for p in range(P):
        pos = int(base_bits[p])
        for c in range(int(count[p])):
            v = int(values[p, c])
            if raw[p] >= 0:
                nb = int(raw[p])
                val = v & ((1 << nb) - 1)
                if pos + nb >= N - 1:
                    count[p] = c
                    break
                for b in range(nb):
                    bits[p, pos] = (val >> (nb - 1 - b)) & 1
                    pos += 1
                # a raw run reads back sign-extended from nb bits
                coded[p, c] = val - ((val >> (nb - 1)) << nb)
            else:
                kk = int(k[p])
                u = (v << 1) ^ (v >> 63)
                q = u >> kk
                if pos + q + 1 + kk >= N - 1:
                    count[p] = c
                    break
                pos += q
                bits[p, pos] = 1
                pos += 1
                for b in range(kk):
                    bits[p, pos] = (u >> (kk - 1 - b)) & 1
                    pos += 1
                coded[p, c] = v
    count = np.maximum(count, 0)

    # pack MSB-first into one shared word buffer, one window per lane
    total_words = P * W + 2
    words = np.zeros(total_words, dtype=np.uint32)
    word_base = (np.arange(P, dtype=np.int32) * W)
    for p in range(P):
        for w in range(W):
            acc = 0
            for b in range(32):
                acc = (acc << 1) | int(bits[p, w * 32 + b])
            words[word_base[p] + w] = acc
    return ((words, word_base, base_bits, k, raw, count), coded)


@pytest.mark.parametrize("seed,P,W,C", [
    (1, 8, 4, 8),
    (2, 16, 8, 16),
    (3, 32, 16, 32),
])
def test_scan_and_pointer_doubling_decode_coded_values(seed, P, W, C):
    import jax.numpy as jnp

    (bucket, coded) = _random_bucket(seed, P, W, C)
    for decode in (rice_decode.decode_partitions_scan,
                   rice_decode.decode_partitions):
        fn = jax.jit(lambda *a, decode=decode: decode(jnp, *a, W, C))
        got = np.asarray(fn(*bucket))
        assert np.array_equal(got, coded), decode.__name__
