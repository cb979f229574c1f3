"""Deterministic double-f32 arithmetic (~45-bit precision).

The analysis kernels' cross-backend exactness contract (ops/lpc.py
``f32round``) permits exactly one shape of operation: a SINGLE f64
add/mul/div on f32-valued operands followed by an immediate f32
re-round — such ops are exact (or round in a vanishingly small band)
under IEEE f64 and float-float f64 emulation alike, because any
sum/product of two f32s is representable as a pair of f32s (the
classic Møller/Dekker error-term theorems).  Single-f32 precision (24
bits) costs real compression on tonal content though: Levinson-Durbin
on a near-singular (tone) autocorrelation needs ~40+ significant bits
to find the deep predictor (measured: up to 7 ratio points on the
reference's tone fixtures).

This module composes that contract into DOUBLE-f32 numbers: a value
is an (hi, lo) pair of f32-valued f64s with |lo| <= ulp(hi)/2,
~48-bit mantissa.  Every primitive below is built exclusively from
single-ops-then-round plus the exact error-term identities, so the
whole arithmetic keeps the determinism guarantee while delivering
near-f64 accuracy.  Backend-generic: ``xp`` is numpy or jax.numpy.

The scalar oracle mirror lives in ref/scalar_lpc.py (zero ops/
imports, per the dual-implementation pattern).
"""

from __future__ import annotations

import numpy as np


def _R(xp, x):
    """round f64 -> f32 precision, staying f64-typed"""
    return x.astype(xp.float32).astype(xp.float64)


def split(xp, x):
    """f64 value -> df pair (hi = nearest f32, lo = f32 remainder)

    PRECONDITION: x must be an EXACT value of <= 47 significant bits
    (e.g. an integer sum below 2^47, or an exact product) so that it
    is identical on every backend and the remainder x - hi spans <=
    24 bits (f32-valued, subtraction exact everywhere).  Wider or
    inexact inputs would make lo backend-dependent."""
    hi = _R(xp, x)
    lo = _R(xp, x - hi)
    return (hi, lo)


def fast_two_sum(xp, a, b):
    """exact renormalization of a + b for f32-valued a, b

    Magnitude-ordered Fast2Sum with every step a single op on
    f32-valued operands (the determinism contract):

    * ``s = R(big + small)`` — the sum of two f32s spans <= 49 bits,
      exact under float-float and within f64's innocuous
      double-rounding bound (53 >= 2*24 + 2), so both backends round
      to the same f32
    * ``z = s - big`` — exactly f32-representable by the Fast2Sum
      lemma (|small| <= |big|), so the f64 subtraction is exact on
      both backends
    * ``e = R(small - z)`` — equals (a + b) - s exactly, which the
      2Sum error theorem guarantees is f32-representable; the
      subtraction of two f32s with an f32 result is exact everywhere
      and the rounding is a no-op kept for contract uniformity

    The naive unordered form ``e = (a + b) - s`` is NOT portable:
    when the exponent gap exceeds ~29 bits the f64 add rounds (span >
    53) while float-float's two-sum stays exact, so the raw error
    term diverges between backends."""
    swap = xp.abs(a) < xp.abs(b)
    big = xp.where(swap, b, a)
    small = xp.where(swap, a, b)
    s = _R(xp, big + small)
    z = s - big
    e = _R(xp, small - z)
    return (s, e)


def add(xp, a, b):
    """df + df"""
    (ah, al) = a
    (bh, bl) = b
    (sh, se) = fast_two_sum(xp, ah, bh)
    t = _R(xp, _R(xp, se + al) + bl)
    return fast_two_sum(xp, sh, t)


def add1(xp, a, b):
    """df + f32-valued scalar/array"""
    (ah, al) = a
    (sh, se) = fast_two_sum(xp, ah, b)
    t = _R(xp, se + al)
    return fast_two_sum(xp, sh, t)


def neg(xp, a):
    return (-a[0], -a[1])


def sub(xp, a, b):
    return add(xp, a, neg(xp, b))


def mul(xp, a, b):
    """df * df"""
    (ah, al) = a
    (bh, bl) = b
    p = ah * bh              # exact: 48-bit product of two f32s
    ph = _R(xp, p)
    pe = p - ph              # exact, f32-valued
    cross = _R(xp, _R(xp, ah * bl) + _R(xp, al * bh))
    t = _R(xp, pe + cross)
    return fast_two_sum(xp, ph, t)


def mul1(xp, a, b):
    """df * f32-valued scalar/array"""
    (ah, al) = a
    p = ah * b               # exact
    ph = _R(xp, p)
    pe = p - ph
    t = _R(xp, pe + _R(xp, al * b))
    return fast_two_sum(xp, ph, t)


def div(xp, a, b):
    """df / df via one Newton-style correction step

    q1 = fl(ah / bh); r = a - q1*b (df, near-exact); q2 = fl(rh / bh);
    result = q1 + q2 — accurate to ~2^-45 relative."""
    (ah, al) = a
    (bh, bl) = b
    safe = xp.where(bh == 0.0, 1.0, bh)
    q1 = _R(xp, ah / safe)
    r = sub(xp, (ah, al), mul1(xp, (bh, bl), q1))
    q2 = _R(xp, r[0] / safe)
    out = fast_two_sum(xp, q1, q2)
    zero = bh == 0.0
    return (xp.where(zero, 0.0, out[0]), xp.where(zero, 0.0, out[1]))


def to_f64(xp, a):
    """df -> plain f64 value (hi + lo: <= 49-bit span, exact on both
    backends; NOT f32-valued — feed only exact consumers or to_f32)"""
    return a[0] + a[1]


def to_f32(xp, a):
    """df -> f32-valued f64 (exact 49-bit sum, then ONE f32 rounding
    — identical under IEEE f64 and float-float, so the result
    re-enters the single-f32 contract domain)"""
    return _R(xp, a[0] + a[1])


def from_parts(xp, *terms):
    """exact f64 terms -> df pair (terms summed hi-first)

    Every term must individually be an EXACT f64 (e.g. exact integer
    sums below 2^47); the accumulation splits and renormalizes after
    each term, so accuracy stays ~2^-45 of the total."""
    acc = split(xp, terms[0])
    for t in terms[1:]:
        acc = add(xp, acc, split(xp, t))
    return acc


def const(xp, value, like):
    """df constant broadcast to `like`'s shape"""
    ones = xp.ones_like(like)
    hi = float(np.float32(value))
    lo = float(np.float32(value - hi))
    return (ones * hi, ones * lo)
