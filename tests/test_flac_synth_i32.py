"""The FLAC int32 synthesis (the device decode's ``lax.scan`` form)
against the numpy oracle and the signal the residuals were coded from,
across predictor orders, both shift branches of the hi/lo algebra and
block lengths, with a batch width that is no power of two."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jax.config.update("jax_enable_x64", True)

from audiotools_tpu.ops import flac_synth  # noqa: E402

ORDERS = (1, 2, 4, 8, 12, 32)
SHIFTS = (9, 13)            # the int32 algebra's <= 11 and > 11 branches
LENGTHS = (16, 192, 4096)
S = 37                      # no power of two


def _case(order, shift, n, seed=0):
    """a stream coded from a known signal: returns the synthesis
    inputs and the signal they must reproduce"""
    rng = np.random.default_rng(seed + 1000 * order + shift + n)
    Kw = 8
    while Kw < order:
        Kw <<= 1
    t = np.arange(n)
    x = np.stack([
        (6000 * np.sin(2 * np.pi * (100 + 37 * s) * t / 44100) +
         rng.integers(-300, 300, n)).astype(np.int64)
        for s in range(S)])
    qlp = np.zeros((S, Kw), dtype=np.int32)
    orders = np.full(S, order, dtype=np.int32)
    orders[::5] = 0                       # pass-through rows
    for s in range(S):
        qlp[s, :orders[s]] = rng.integers(-1500, 1500, orders[s])
    shifts = np.full(S, shift, dtype=np.int32)
    warm = np.zeros((S, Kw), dtype=np.int32)
    res = np.zeros((S, n), dtype=np.int32)
    for s in range(S):
        o = int(orders[s])
        k = min(o, n)
        warm[s, :k] = x[s, :k]
        for i in range(o, n):
            pred = int(np.dot(qlp[s, :o].astype(np.int64),
                              x[s, i - o:i][::-1])) >> shift
            res[s, i] = x[s, i] - pred
        res[s, :k] = 0
    return (res, warm, qlp, shifts, orders, x.astype(np.int32))


def _scan(n):
    import jax.numpy as jnp
    return jax.jit(lambda *a: flac_synth.synthesize(
        jnp, *a, n, use_i32=True))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("order", ORDERS)
def test_int32_scan_matches_oracle(order, shift, n):
    (res, warm, qlp, sh, orders, x) = _case(order, shift, n)
    assert flac_synth.i32_synthesis_safe(qlp, sh, np.full(S, 17))
    oracle = flac_synth.synthesize(np, res, warm, qlp, sh, orders, n)
    assert np.array_equal(oracle, x)
    got = np.asarray(_scan(n)(res, warm, qlp, sh, orders))
    assert got.shape == (S, n)
    assert np.array_equal(got, oracle)


@pytest.mark.gpu
def test_int32_scan_on_the_card(gpu):
    """the int32 scan as the GPU compiler builds it, at a decode
    batch's width (2048 subframes of 4096 samples)"""
    import jax.numpy as jnp

    (res, warm, qlp, sh, orders, x) = _case(12, 9, 4096, seed=7)
    reps = 2048 // S + 1
    args = [jnp.asarray(np.tile(a, (reps,) + (1,) * (a.ndim - 1)))
            for a in (res, warm, qlp, sh, orders)]
    got = np.asarray(_scan(4096)(*args))
    assert got.shape == (reps * S, 4096)
    assert np.array_equal(got, np.tile(x, (reps, 1)))
