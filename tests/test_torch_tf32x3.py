"""The 3xTF32 products of kernel A' (digat_tpu_torch/csrc/tc_gemm.cuh),
replayed in numpy.

Each fp32 operand is split as it enters shared memory into hi = rna(x) and
lo = rna(x - hi), where rna rounds to TF32 (10 mantissa bits) as
`cvt.rna.tf32.f32` does: to nearest on the 13 dropped bits, ties away from
zero. The tensor cores sum lo*hi + hi*lo + hi*hi into fp32 accumulators,
8 deep a step (m16n8k8). The replay does the same in float32 and holds the
result to kernel A''s gate, max |got - ref| <= 1e-4 * max(1, max |ref|),
against float64 at A''s product shapes cut to a few hundred rows: the
Q|K|V recompute and dx (K 300 and 1,200), the pool's u and dh (K 400 and
256), and a weight gradient whose K runs over the rows, split into fixed
slices summed in order. It also records why the route is 3x: one TF32 pass
misses the gate at K 1,200."""

import numpy as np
import pytest

GATE = 1e-4


def rna_tf32(x):
    """x (float32) rounded to TF32 like cvt.rna.tf32.f32: the low 13 mantissa
    bits dropped, to nearest, a tie away from zero."""
    x = np.asarray(x, dtype=np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    out = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(x), out, x)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(np.asarray(x, np.float32) - hi)


def tf32x3(a, b):
    """a [M, K] @ b [K, N] as the kernel sums it: fp32 accumulators, k in
    steps of 8, lo*hi + hi*lo + hi*hi each step."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc = acc + (al[:, s] @ bh[s]).astype(np.float32)
        acc = acc + (ah[:, s] @ bl[s]).astype(np.float32)
        acc = acc + (ah[:, s] @ bh[s]).astype(np.float32)
    return acc


def tf32x1(a, b):
    ah, bh = rna_tf32(a), rna_tf32(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc = acc + (ah[:, s] @ bh[s]).astype(np.float32)
    return acc


def err_and_limit(got, a, b):
    ref = a.astype(np.float64) @ b.astype(np.float64)
    return float(np.abs(got - ref).max()), GATE * max(1.0, float(np.abs(ref).max()))


def test_rna_rounds_to_nearest_with_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's step at 1
    cases = [(one + ulp * np.float32(0.25), one), (one + ulp * np.float32(0.75), one + ulp),
             (one + ulp * np.float32(0.5), one + ulp),  # the tie goes away from zero
             (-(one + ulp * np.float32(0.5)), -(one + ulp)), (np.float32(0.0), np.float32(0.0))]
    for x, want in cases:
        assert rna_tf32(np.float32(x)) == np.float32(want), (x, want)
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    assert not (rna_tf32(x).view(np.uint32) & 0x1FFF).any()  # 10 mantissa bits left
    hi, lo = split(x)
    assert np.abs((hi.astype(np.float64) + lo) - x).max() <= 2.0 ** -21 * np.abs(x).max()


@pytest.mark.parametrize("what,M,K,N", [
    ("Q|K|V recompute", 256, 300, 1200), ("dx", 256, 1200, 300), ("pool u", 256, 400, 256),
    ("pool dh", 256, 256, 400)])
def test_tf32x3_meets_the_gate_at_the_product_shapes(what, M, K, N):
    rng = np.random.default_rng(K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    err, limit = err_and_limit(tf32x3(a, b), a, b)
    assert err <= limit, (what, err, limit)


def test_tf32x3_split_reduction_meets_the_gate():
    """dW = dqkv^T xd: K runs over the rows, cut into slices of 128 whose
    partials are summed in slice order (the kernel's split over M)."""
    rng = np.random.default_rng(7)
    rows, m, n, per = 640, 96, 60, 128
    dq = rng.standard_normal((rows, m)).astype(np.float32)
    xd = rng.standard_normal((rows, n)).astype(np.float32)
    parts = [tf32x3(dq[z:z + per].T, xd[z:z + per]) for z in range(0, rows, per)]
    got = np.zeros_like(parts[0])
    for p in parts:
        got = got + p
    err, limit = err_and_limit(got, dq.T, xd)
    assert err <= limit, (err, limit)


def test_one_tf32_pass_misses_the_gate_at_k_1200():
    """Why the route is 3x: a single TF32 pass at K 1,200 is off by more than
    the gate, and 3xTF32 is well inside it."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((256, 1200)).astype(np.float32)
    b = rng.standard_normal((1200, 300)).astype(np.float32)
    one, limit = err_and_limit(tf32x1(a, b), a, b)
    three, _ = err_and_limit(tf32x3(a, b), a, b)
    assert one > limit
    assert three < limit / 10
