"""The ALAC and TTA device synthesis scans (jitted lax.scan forms)
against the scalar reference decoders in ``ref/``, on adversarial
residual patterns."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
# the device decoders switch x64 on before they trace these scans
jax.config.update("jax_enable_x64", True)

from audiotools_tpu.ops import alac_synth  # noqa: E402
from audiotools_tpu.ref.alac import ALACDecoder  # noqa: E402


def _alac_oracle(residuals, qlp, order, shift, sample_size):
    """ref/alac.py's scalar decode_subframe, row by row"""
    out = np.zeros(residuals.shape, dtype=np.int32)
    for s in range(residuals.shape[0]):
        coeffs = [int(v) for v in qlp[s, :order[s]]]
        out[s] = ALACDecoder.decode_subframe(
            None, int(shift[s]), coeffs, int(sample_size[s]),
            [int(v) for v in residuals[s]])
    return out


def _alac_scan(residuals, qlp, order, shift, sample_size, n):
    import jax.numpy as jnp
    fn = jax.jit(lambda *a: alac_synth.synthesize(
        jnp, *a, n, max_order=8))
    return np.asarray(fn(residuals, qlp, order, shift, sample_size))


@pytest.mark.parametrize("seed,S,n,order_hi", [
    (1, 8, 64, 4),
    (2, 16, 128, 8),
])
def test_alac_scan_matches_oracle(seed, S, n, order_hi):
    rng = np.random.default_rng(seed)
    residuals = rng.integers(-500, 500, (S, n)).astype(np.int32)
    order = rng.integers(1, order_hi + 1, S).astype(np.int32)
    qlp = np.zeros((S, alac_synth.K), dtype=np.int32)
    for s in range(S):
        qlp[s, :order[s]] = rng.integers(-2000, 2000, order[s])
    shift = rng.integers(6, 13, S).astype(np.int32)
    sample_size = np.full(S, 16, dtype=np.int32)

    expected = _alac_oracle(residuals, qlp, order, shift, sample_size)
    got = _alac_scan(residuals, qlp, order, shift, sample_size, n)
    assert np.array_equal(got, expected)


def test_alac_scan_diff_chain_rows():
    """order >= 31 rows (pure difference chain) beside LPC rows"""
    rng = np.random.default_rng(9)
    S, n = 8, 64
    residuals = rng.integers(-300, 300, (S, n)).astype(np.int32)
    order = np.array([31, 31, 1, 2, 3, 4, 5, 6], dtype=np.int32)
    qlp = np.zeros((S, alac_synth.K), dtype=np.int32)
    for s in range(2, S):
        qlp[s, :order[s]] = rng.integers(-1500, 1500, order[s])
    shift = np.full(S, 9, dtype=np.int32)
    sample_size = np.full(S, 16, dtype=np.int32)

    expected = _alac_oracle(residuals, qlp, order, shift, sample_size)
    got = _alac_scan(residuals, qlp, order, shift, sample_size, n)
    assert np.array_equal(got, expected)


def test_tta_inverse_scan_matches_reference():
    """the TTA inverse filter + fixed predictor scan against
    ref/tta.py's scalar tta_unfilter and fixed_unpredict"""
    import jax.numpy as jnp

    from audiotools_tpu.ops import tta_synth
    from audiotools_tpu.ref import tta as ref_tta

    rng = np.random.default_rng(4)
    for bps in (8, 16, 24):
        res = rng.integers(-400, 400, (8, 64)).astype(np.int32)
        expected = np.stack([
            ref_tta.fixed_unpredict(bps, ref_tta.tta_unfilter(bps, row))
            for row in res]).astype(np.int32)
        fn = jax.jit(lambda r, bps=bps: tta_synth.inverse_filter_predict(
            jnp, r, bps))
        got = np.asarray(fn(res))
        assert np.array_equal(got, expected), bps
