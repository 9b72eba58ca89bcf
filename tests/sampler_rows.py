"""Adversarial rows for the fused sampler, shared by the CPU tests, the
card's tests and ``chip_smoke.py`` (numpy only: no JAX, no torch).

Each row probes one edge of an exact threshold search: ties straddling
the k boundary, ``+0.0`` and ``-0.0`` (distinct ordered keys), all-equal
rows, k = 1 and k = V - 1, p tiny and p = 1 - 1e-7, rows whose kept
``exp`` values mostly underflow to 0, and a ``-1e30`` masked tail. The
rows are built so that the answer does not hang on f32 rounding: every
kept or dropped value clears its threshold by far more than a sum's
rounding, so any exact implementation, in any summation order, keeps the
same support (:func:`oracle_support`, in float64, says which).
"""

from __future__ import annotations

import numpy as np

NEG_INF = -1e30


def adversarial_rows(V: int, seed: int = 0):
    """``(names, logits (R, V) f32, temperature (R,) f32, top_k (R,)
    int32, top_p (R,) f32)`` for a vocabulary of ``V >= 64``."""
    if V < 64:
        raise ValueError(f"V must be at least 64, got {V}")
    rng = np.random.default_rng(seed)
    rows = []

    def base(scale=2.0):
        return (scale * rng.normal(size=V)).astype(np.float32)

    def place(values, fill):
        """``fill`` with ``values`` at random positions."""
        row = np.asarray(fill, np.float32).copy()
        at = rng.permutation(V)[:len(values)]
        row[at] = values
        return row

    # 3 values above t = 5 and 7 ties at t; k = 5 cuts through the ties,
    # so all 7 are kept; with p = 0.6 only 8 and 7 are
    ties = place([8.0, 7.0, 6.0] + [5.0] * 7, np.minimum(base(), 3.5))
    rows += [("ties_straddle_k", ties, 1.0, 5, 1.0),
             ("ties_straddle_k_top_p", ties, 1.0, 5, 0.6)]
    # two 1.0s, three +0.0 and three -0.0 over a tail far below: k = 5
    # keeps the +0.0s and drops the -0.0s; so does p = 0.6 (the mass
    # strictly above +0.0 is 2, above -0.0 3.10, of z = 4.21)
    zeros = place([1.0, 1.0, 0.0, 0.0, 0.0, -0.0, -0.0, -0.0],
                  -30.0 - np.abs(base(1.0)))
    rows += [("signed_zeros_k", zeros, 1.0, 5, 1.0),
             ("signed_zeros_top_p", zeros, 1.0, 0, 0.6)]
    flat = np.full(V, 0.25, np.float32)
    rows += [("all_equal", flat, 0.7, 3, 0.9),
             ("all_equal_greedy", flat, 0.0, 3, 0.9)]
    rows += [("k_one", base(), 1.3, 1, 1.0),
             ("k_v_minus_1", base(), 0.9, V - 1, 1.0),
             ("p_tiny", base(), 1.1, 0, 1e-6)]
    # 12 values within 5 of the max over a tail 35 below it: p = 1 - 1e-7
    # keeps the 12 (each holds > 1e-3 of z) and drops the tail (its whole
    # mass is < 1e-12 of z)
    body = rng.uniform(0.0, 5.0, size=12).astype(np.float32)
    near_one = place(body, -35.0 - np.abs(base(1.0)))
    rows += [("p_near_one", near_one, 1.0, 0, float(np.float32(1 - 1e-7)))]
    # logits 300 apart on average: past the max almost every exp is 0 in
    # f32 (or a denormal); k = V / 2 keeps values of zero mass
    rows += [("underflow", base(300.0), 1.0, V // 2, 0.5)]
    live = V - V // 3
    masked = base()
    masked[live:] = NEG_INF
    rows += [("masked_tail", masked, 1.0, 0, 1.0),
             ("masked_tail_k_past_live", masked, 0.8, live + 5, 1.0),
             ("masked_tail_top_p", masked, 1.0, 0, 0.9),
             ("masked_tail_greedy", masked, 0.0, 0, 1.0)]
    names = [r[0] for r in rows]
    logits = np.stack([r[1] for r in rows]).astype(np.float32)
    temp = np.asarray([r[2] for r in rows], np.float32)
    top_k = np.asarray([r[3] for r in rows], np.int32)
    top_p = np.asarray([r[4] for r in rows], np.float32)
    return names, logits, temp, top_k, top_p


def _ordered(x: np.ndarray) -> np.ndarray:
    b = x.astype(np.float32).view(np.int32)
    return np.where(b < 0, b ^ np.int32(0x7FFFFFFF), b)


def oracle_support(row, temperature, top_k, top_p) -> np.ndarray:
    """Indices the sampler may draw for one row, by sorting, with the
    masses in float64: a greedy row's first argmax; else the values >=
    the k-th largest, then >= the smallest kept value whose strictly-above
    mass is below p * z."""
    row = np.asarray(row, np.float32)
    V = row.shape[0]
    if temperature <= 0:
        return np.asarray([int(np.argmax(row))])
    x = row / np.float32(temperature)
    key = _ordered(x)
    k_eff = V if top_k <= 0 else min(int(top_k), V)
    kth = np.sort(key)[::-1][k_eff - 1]
    kmask = key >= kth
    if top_p >= 1:
        return np.flatnonzero(kmask)
    m = x[kmask].max().astype(np.float64)
    e = np.where(kmask, np.exp(x.astype(np.float64) - m), 0.0)
    target = float(top_p) * e.sum()
    keys, group = np.unique(key[kmask], return_inverse=True)  # ascending
    mass = np.bincount(group, weights=e[kmask])
    above = mass.sum() - np.cumsum(mass)     # strictly above each key
    ok = np.flatnonzero(above < target)
    if not len(ok):
        return np.asarray([], np.int64)
    return np.flatnonzero(kmask & (key >= keys[ok[0]]))
