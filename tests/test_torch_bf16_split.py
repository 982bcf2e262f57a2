"""The arithmetic of the bf16 instances of kernels A'' and A' (csrc/dropout.cu,
csrc/tc_wgmma.cuh, csrc/msa_encoder_bwd.cu), replayed on the CPU.

A'' bf16 multiplies by the fp32 value of 1 / keep where the plain version
(and XLA's bf16 dropout) divides by keep: over every finite bf16 x and
every bf16 keep above 2^-128 (every keep a rate in [0, 1) gives) the two
round to the same bf16 bits. Its 32-bit row division is a multiply-shift
by `ops.dropout.divider`, exact for every group index below 2^31.

A''s products run on bf16 wgmma: an fp32 operand x enters as three bf16
terms, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which sum
back to x within 2^-24 |x|; a product against an exact bf16 operand takes
three passes (lo, mid, hi), one of two split operands six (every pair down
to 2^-16 of the leading term), each 64-deep k-tile's sum (32-deep for the
six-pass product) rounded to fp32 and added to the running sum rounding to
nearest (kRN). The replay holds each product to kernel A''s gate,
max |got - ref| <= 1e-4 * max(1, max |ref|), against float64 at A''s
product shapes cut to a few hundred rows."""

import numpy as np
import pytest
import torch

from digat_tpu_torch.ops import dropout as DR

BF16 = torch.bfloat16
GATE = 1e-4


def _finite_bf16():
    """Every finite bf16 value, as a bf16 tensor."""
    x = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(BF16)
    return x[torch.isfinite(x)]


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.3, 0.5])
def test_dropout_multiply_equals_division_at_the_configs_rates(rate):
    """bf16(x * fp32(1 / keep)) == bf16(x / keep) for every finite bf16 x at
    the rates the models use (0.2 and its half, and the tests' 0.3, 0.5)."""
    x = _finite_bf16().float()
    keep, inv = DR.bf16_keep(rate), DR.bf16_inv_keep(rate)
    assert inv == float(torch.tensor(1.0) / torch.tensor(keep))  # fp32 division
    assert torch.equal(_bits((x * inv).to(BF16)), _bits((x / keep).to(BF16)))


def test_dropout_multiply_equals_division_at_every_bf16_keep():
    """The same over the 1,025 bf16 keeps in [2^-8, 1], exhaustively."""
    keeps = _finite_bf16().float()
    keeps = keeps[(keeps >= 2.0**-8) & (keeps <= 1.0)]
    assert keeps.numel() == 1025
    x = _finite_bf16().float()[None, :]
    for chunk in keeps.split(64):
        k = chunk[:, None]
        inv = torch.ones_like(k) / k  # fp32, rounded to nearest
        assert torch.equal(_bits((x * inv).to(BF16)), _bits((x / k).to(BF16)))


def test_dropout_multiply_below_2_to_the_minus_8():
    """Every bf16 keep in (0, 2^-8), exhaustively: the multiply gives the
    division's bits wherever keep > 2^-128 (below, 1 / keep overflows fp32),
    and no rate that `threshold` accepts gives a keep below 2^-53."""
    keeps = _finite_bf16().float()
    keeps = keeps[(keeps > 0.0) & (keeps < 2.0**-8)]
    x = _finite_bf16().float()[None, :]
    differ = []
    for chunk in keeps.split(512):
        k = chunk[:, None]
        inv = torch.ones_like(k) / k
        same = torch.eq(_bits((x * inv).to(BF16)), _bits((x / k).to(BF16))).all(dim=1)
        differ += chunk[~same].tolist()
    assert differ and max(differ) <= 2.0**-128
    last = np.nextafter(1.0, 0.0)
    DR.threshold(last)  # the largest rate accepted
    assert DR.bf16_keep(last) >= 2.0**-53
    assert np.isfinite(DR.bf16_inv_keep(last))


def test_dropout_plain_is_the_kernels_multiply():
    """dropout_plain (x / keep) and the kernel's arithmetic (x * inv_keep,
    the same Philox mask) agree bit for bit on a bf16 tensor."""
    x = (torch.randn(97, 300, generator=torch.Generator().manual_seed(3)) * 8).to(BF16)
    for rate in (0.1, 0.2):
        keep = DR.keep_mask_plain(97, 300, rate, 77, 5)
        want = DR.dropout_plain(x, rate, 77, 5)
        got = torch.where(keep, (x.float() * DR.bf16_inv_keep(rate)).to(BF16),
                          torch.zeros((), dtype=BF16))
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("d", [1, 2, 3, 7, 75, 76, 100, 128, 255, 300, 1001, 2**16 + 1,
                               2**20 - 3, 2**31 - 1])
def test_divider_is_integer_division(d):
    """(n * magic) >> shift == n // d for group indices n < 2^31: all n below
    2^17, random ones, the top of the range and each side of multiples of
    d near it."""
    magic, shift = DR.divider(d)
    assert 0 < magic < 2**32 and 31 <= shift <= 62
    g = torch.Generator().manual_seed(d)
    top = 2**31 - 1
    near = torch.arange(max(0, top // d - 64), top // d + 1, dtype=torch.int64) * d
    n = torch.cat([torch.arange(2**17, dtype=torch.int64),
                   torch.randint(0, 2**31, (2**17,), generator=g, dtype=torch.int64),
                   torch.arange(top - 4096, top + 1, dtype=torch.int64),
                   near - 1, near, near + 1]).clamp(0, top)
    assert torch.equal((n * magic) >> shift, n // d)


def test_divider_over_every_small_divisor():
    n = torch.cat([torch.arange(4096, dtype=torch.int64),
                   torch.randint(0, 2**31, (4096,), generator=torch.Generator().manual_seed(1),
                                 dtype=torch.int64), torch.tensor([2**31 - 1])])
    for d in range(1, 4097):
        magic, shift = DR.divider(d)
        assert torch.equal((n * magic) >> shift, n // d), d


def test_dropout_refuses_too_many_groups_for_the_bf16_kernel(monkeypatch):
    """The bf16 kernel's index math is 32-bit: a tensor of 2^31 groups of four
    or more raises before any launch (a meta tensor stands in for it)."""
    from digat_tpu_torch.ops import build

    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    x = torch.empty((2**29, 16), dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        DR.dropout(x, 0.2, 1, 2)


# ---------------------------------------------------------------------------
# the three-term split and the products on it
# ---------------------------------------------------------------------------
def split3(x):
    """x (fp32) -> (hi, mid, lo) bf16 as csrc/msa_encoder_bwd.cu's split3:
    rest = x - bf16(x) (exact), hi = x - rest, mid = bf16(rest), lo =
    bf16(rest - mid)."""
    x = x.float()
    rest = x - x.to(BF16).float()
    mid = rest.to(BF16)
    return (x - rest).to(BF16), mid, (rest - mid.float()).to(BF16)


def test_split3_terms_sum_back_to_x():
    """Each difference is exact in fp32, hi is bf16(x), and the three terms
    sum to x within 2^-24 |x| over fp32 values of every exponent from
    2^-100 to 2^100 (random mantissas) and random normal fp32 bit
    patterns."""
    g = torch.Generator().manual_seed(0)
    scales = torch.exp2(torch.randint(-100, 101, (2**16,), generator=g).float())
    x = torch.randn(2**16, generator=g) * scales
    bits = torch.randint(0x00800000, 0x7F000000, (2**16,), generator=g, dtype=torch.int64)
    sign = torch.randint(0, 2, (2**16,), generator=g, dtype=torch.int64) << 31
    x = torch.cat([x, ((bits | sign) - ((bits | sign) >= 2**31).long() * 2**32).to(
        torch.int32).view(torch.float32)])
    x = x[torch.isfinite(x) & (x.abs() >= 2.0**-100) & (x.abs() <= 2.0**100)]
    hi, mid, lo = split3(x)
    x64 = x.double()
    assert torch.equal(hi, x.to(BF16))
    rest = x - hi.float()
    assert torch.equal(rest.double(), x64 - hi.double())  # x - hi is exact in fp32
    assert torch.equal((rest - mid.float()).double(), rest.double() - mid.double())
    total = hi.double() + mid.double() + lo.double()
    assert float(((total - x64).abs() / x64.abs()).max()) <= 2.0**-24


def _passes(ta, tb):
    """(A term, B term) of each pass, small terms first, as tc_wgmma.cuh's
    pass_a and pass_b."""
    if ta == 3 and tb == 3:
        return [(1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)]
    return [(2, 0), (1, 0), (0, 0)] if ta == 3 else [(0, 0)]


def wg_product(a, b, kt=64, split_b=False, slice_rows=None):
    """a [M, K] (fp32, split into three terms) @ b [K, N] (bf16, exact; or
    fp32 split too) as the wgmma products sum it: per kt-deep k-tile every
    pass and every 16-deep step added into fresh fp32 sums, each 16-deep
    product exact (bf16 x bf16 in float64, rounded to fp32), then the
    tile's sums added to the running sums rounding to nearest; slices of
    `slice_rows` rows of K summed apart and added in slice order."""
    ta = split3(a)
    tb = split3(b) if split_b else (b.to(BF16),)
    passes = _passes(3, 3 if split_b else 1)
    K = a.shape[1]
    slice_rows = slice_rows or K
    total = None
    for s0 in range(0, K, slice_rows):
        run = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
        for k0 in range(s0, min(K, s0 + slice_rows), kt):
            tile = torch.zeros_like(run)
            for pa, pb in passes:
                for k in range(k0, min(K, k0 + kt, s0 + slice_rows), 16):
                    ks = slice(k, min(K, k + 16, s0 + slice_rows))
                    tile = tile + (ta[pa][:, ks].double() @ tb[pb][ks].double()).float()
            run = run + tile
        total = run if total is None else total + run
    return total


def wg_logit_parts(u, b1, v, tile=128):
    """The v-product of tanh(u + b1) per `tile`-wide column block of the
    wgmma kPool / kLogits epilogue (tc_wgmma.cuh), in its order: within a
    block each of a row's four lanes sums its four of every sixteen columns
    in column order, then (l0 + l1) + (l2 + l3) -> [parts, M], u's dtype."""
    t = torch.tanh(u + b1.to(u.dtype)) * v.to(u.dtype)
    parts = []
    for c0 in range(0, t.shape[1], tile):
        lanes = [torch.zeros(t.shape[0], dtype=t.dtype) for _ in range(4)]
        for c in range(c0, min(t.shape[1], c0 + tile)):
            lane = (0, 2, 1, 3)[((c - c0) % 16) // 4]
            lanes[lane] = lanes[lane] + t[:, c]
        parts.append((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
    return torch.stack(parts)


# A''s products cut to a few hundred rows: (what, M, K, N, B split, k-tile,
# rows of a slice of K); q|k|v has two exact bf16 operands (one pass); the
# pool logits are kernel A's bf16 product (u's product, then its v-product
# per 128-wide column, the parts added in order; no u stored)
PRODUCTS = [("u = h W1^T", 256, 400, 256, False, 64, None),
            ("logits = tanh(h W1^T + b1) v", 256, 400, 256, False, 64, None),
            ("dO = dpre W1", 256, 256, 400, False, 64, None),
            ("dx = dqkv Wqkv", 192, 1200, 300, False, 64, None),
            ("dWqkv = dqkv^T xd", 96, 9000, 100, False, 64, 4096),
            ("dW1 = dpre^T h", 64, 9000, 80, True, 32, 4096)]


@pytest.mark.parametrize("what,M,K,N,split_b,kt,rows", PRODUCTS,
                         ids=[p[0].split(" =")[0] for p in PRODUCTS])
def test_wgmma_split_products_within_the_gate(what, M, K, N, split_b, kt, rows):
    """Each product of the split operands against float64 from the fp32
    (and bf16) operands: within A''s gate, and within 2^-20 of the sum of
    the terms' magnitudes (fp32-class, as 3xTF32 is)."""
    g = np.random.default_rng(M + K)
    a = torch.from_numpy(g.standard_normal((M, K)).astype(np.float32))
    if what.startswith(("u", "logits")):
        a = a.clamp(min=0)  # h is a ReLU's output
    b = torch.from_numpy((g.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32))
    if not split_b:
        b = b.to(BF16).float()  # the exact bf16 weight or x
    got = wg_product(a, b, kt, split_b, rows).double()
    ref = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    if what.startswith("logits"):
        b1 = torch.from_numpy((0.1 * g.standard_normal(N)).astype(np.float32))
        v = torch.from_numpy((g.standard_normal(N) / np.sqrt(N)).astype(np.float32))
        parts = wg_logit_parts(got.float(), b1, v)
        got = torch.zeros(M)
        for part in parts:
            got = got + part
        got = got.double()
        terms = torch.tanh(ref + b1.double()) * v.double()
        ref, scale = terms.sum(dim=1), terms.abs().sum(dim=1)
    err = float((got - ref).abs().max())
    assert err <= GATE * max(1.0, float(ref.abs().max())), err
    assert float(((got - ref).abs() / scale).max()) <= 2.0**-20
