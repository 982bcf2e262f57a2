"""The plain versions of the attention pair, A'', B and C at `compute_dtype`
bfloat16 against the JAX kernels they replace (Pallas in interpret mode, as
the TPU runs them), on bf16 inputs made from a seed with numpy, on the CPU.

Tolerances. The TPU kernels and the port both compute in fp32 from the same
bf16 values and round each bf16 output once, so two results agree up to
the fp32 summation order, which can put an element on the other side of a
bf16 rounding boundary: a bf16 output is held within one bf16 ulp of its
JAX element plus 1e-5 * max(1, max |JAX|), an fp32 one within that 1e-5.

  * The pair (E and F): `msa_attention` against F on the packed layout at
    L 12 and 130 (past 128 only F runs) and `msa_attention_grouped` against
    E on the head-padded layout at L 12, key-masked, forward and VJP (bf16
    do; dq, dk and dv bf16). JAX's XLA path rounds the scores and the
    probabilities to bf16 and lies further away (recorded in ROADMAP.md
    section 3).
  * A'' on a bf16 tensor: `dropout_plain` against XLA's
    jnp.where(m, x / keep, 0).astype(bf16) under the port's Philox mask,
    bit for bit, forward and VJP, at the rates of the sites (0.2, 0.1).
  * B with bf16 activations (x, query, weights and out bf16) against the
    JAX kernel at G 8 and 10.
  * C with bf16 k1, k2, k3 and a: the forward against the JAX kernel (bf16
    scores), the backward (bf16 gradients) against its custom VJP.
  * The ReLU kink: an Eq. (8) sum built within rounding of 0, where the
    fp32 sum k1 + (k2 + k3) rounds to 0 but the exact one is 2^-25; C's
    backward takes the float64 sum's side, the branch the card's kernel
    takes (tests/test_torch_cuda_bf16.py).
  * On CPU tensors the wrappers count no launch of the bf16 instances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.ops.gat import interactive_gat_scores as jax_scores
from digat_tpu.ops.pallas import msa_attention as JF
from digat_tpu.ops.pallas import msa_attention_grouped as JE
from digat_tpu.ops.pallas.gat_layer import interactive_gat_layer_fused as jax_gat_layer
from digat_tpu_torch.ops import dropout as DR
from digat_tpu_torch.ops import gat_layer as GL
from digat_tpu_torch.ops import gat_scores as GS
from digat_tpu_torch.ops import msa_attention as MA
from digat_tpu_torch.ops import msa_attention_grouped as MG
from tests.test_torch_support import bf16_ulp, jax_interpret, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BF16 = jnp.bfloat16
HEADS, DK = 4, 6


def _bf(a):
    """numpy fp32 -> JAX bf16."""
    return jnp.asarray(a, jnp.float32).astype(BF16)


def _t(a):
    """A JAX or numpy array -> torch, bf16 kept bf16."""
    a = jnp.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, want):
    """got (torch) within one bf16 ulp of want (JAX) plus 1e-5 * max(1, max
    |want|) where got is bf16, else within that 1e-5."""
    want = _t(want).double()
    d = (got.double() - want).abs()
    if got.dtype == torch.bfloat16:
        d = (d - bf16_ulp(want).double()).clamp(min=0)
    limit = 1e-5 * max(1.0, float(want.abs().max()))
    assert float(d.max()) <= limit, (float(d.max()), limit)


def _attention_case(N, L, width, seed):
    rng = np.random.default_rng(seed)
    q, k, v, w = (_bf(rng.normal(size=(N, L, width))) for _ in range(4))
    mask = rng.random((N, L)) < 0.7
    mask[:, 0] = True
    return q, k, v, w, mask


def _pad(x, dkp):
    """packed [N, L, H * dk] -> head-padded [N, L, H * dkp], zero pad lanes."""
    n, L, _ = x.shape
    return jnp.pad(x.reshape(n, L, HEADS, DK), ((0, 0), (0, 0), (0, 0), (0, dkp - DK))
                   ).reshape(n, L, HEADS * dkp)


def _vjp_both(jfn, pfn, q, k, v, w):
    """(JAX out and grads, port out and grads) of fn(q, k, v) with
    cotangent w, all bf16."""
    with jax_interpret():
        out, vjp = jax.vjp(jfn, q, k, v)
        want = [out, *vjp(w)]
    leaves = [_t(t).requires_grad_(True) for t in (q, k, v)]
    got = pfn(*leaves)
    got.backward(_t(w))
    return want, [got.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("L", [12, 130])
def test_pair_plain_matches_f_at_bf16(L):
    """F on the packed layout: out, dq, dk and dv bf16 on both sides."""
    q, k, v, w, mask = _attention_case(5, L, HEADS * DK, seed=L)
    want, got = _vjp_both(lambda a, b, c: JF.msa_attention(a, b, c, HEADS, mask=jnp.asarray(mask)),
                          lambda a, b, c: MA.msa_attention(a, b, c, HEADS, torch.from_numpy(mask)),
                          q, k, v, w)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.bfloat16 and wnt.dtype == BF16
        _close(g, wnt)
    # JAX's XLA path rounds the scores and probabilities: further away
    xla = np.asarray(JF._attention_xla(q, k, v, jnp.asarray(mask), HEADS).astype(jnp.float32))
    kernel = np.asarray(want[0].astype(jnp.float32))
    assert float(np.abs(xla - kernel).max()) > float(np.abs(got[0].float().numpy() - kernel).max())


def test_pair_plain_matches_e_at_bf16():
    """E on the head-padded layout (dkp 8 at L 12): the pad lanes of out and
    the gradients zero."""
    L, dkp = 12, 8
    assert JE.group_size(HEADS, L, DK) > 0
    q, k, v, w, mask = _attention_case(5, L, HEADS * DK, seed=3)
    q, k, v, w = (_pad(t, dkp) for t in (q, k, v, w))
    want, got = _vjp_both(
        lambda a, b, c: JE.msa_attention_grouped(a, b, c, HEADS, DK, mask=jnp.asarray(mask)),
        lambda a, b, c: MG.msa_attention_grouped(a, b, c, HEADS, DK, torch.from_numpy(mask)),
        q, k, v, w)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, wnt)
        assert not g.reshape(5, L, HEADS, dkp)[..., DK:].any()


@pytest.mark.parametrize("rate", [0.2, 0.1])
def test_dropout_plain_matches_xla_bf16_dropout_bit_for_bit(rate):
    """Forward and VJP of XLA's bf16 dropout (x / keep with keep rounded to
    bf16) under the port's mask, bit for bit."""
    rng = np.random.default_rng(int(rate * 100))
    rows, cols, seed, site = 300, 40, 17, 3
    x, g = _bf(rng.normal(size=(rows, cols)) * 3), _bf(rng.normal(size=(rows, cols)))
    m = jnp.asarray(DR.keep_mask_plain(rows, cols, rate, seed, site).numpy())
    keep = 1.0 - rate
    out, vjp = jax.vjp(lambda t: jnp.where(m, t / keep, 0.0).astype(t.dtype), x)
    (gx,) = vjp(g)
    xt = _t(x).requires_grad_(True)
    got = DR.dropout_plain(xt, rate, seed, site)
    got.backward(_t(g))
    assert got.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    assert DR.bf16_keep(rate) == float(jnp.asarray(keep, BF16))
    torch.testing.assert_close(got.detach(), _t(out), rtol=0, atol=0)
    torch.testing.assert_close(xt.grad, _t(gx), rtol=0, atol=0)
    # the fp32 rule (x * (1 / (1 - rate)) rounded) gives other bits
    fp32_rule = torch.where(torch.from_numpy(np.array(m)),
                            (_t(x).float() * (1.0 / keep)).to(torch.bfloat16),
                            torch.zeros((), dtype=torch.bfloat16))
    assert not torch.equal(fp32_rule, got.detach())


def _gat_case(B, G, D, seed):
    """bf16 x, query and weights (the CNN-DIGAT compute copy), a row with no
    neighbour."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: _bf(rng.normal(size=s) * sc)
    adj = (rng.random((B, G, G)) < 0.3) | np.eye(G, dtype=bool)
    adj[0, 1] = False
    return [f(B, G, D, sc=0.3), jnp.asarray(adj), f(B, D, sc=0.3), f(D, D, sc=0.2),
            f(D, sc=0.05), f(D, D, sc=0.2), f(D, D, sc=0.2), f(D, D, sc=0.2), f(D, sc=0.05),
            f(D, sc=0.2)]


@pytest.mark.parametrize("G", [8, 10])
def test_gat_layer_plain_with_bf16_activations_matches_jax_kernel(G):
    case = _gat_case(5, G, 32, seed=G)
    with jax_interpret():
        want = jax_gat_layer(*case, interpret=True)
    assert want.dtype == BF16
    got = GL.interactive_gat_layer_plain(*map(_t, case))
    assert got.dtype == torch.bfloat16
    _close(got, want)


def _scores_case(B, G, D, seed):
    rng = np.random.default_rng(seed)
    return [_bf(rng.normal(size=s) * 0.5) for s in ((B, G, D), (B, G, D), (B, D), (D,))] \
        + [_bf(rng.normal(size=(B, G, G)))]


@pytest.mark.parametrize("G", [8, 12])
def test_gat_scores_at_bf16_match_jax_kernel(G):
    """C's forward (bf16 scores) and backward (bf16 gradients, the fp32
    kernel between the casts) against the JAX kernel's custom VJP."""
    k1, k2, k3, a, g = _scores_case(3, G, 24, seed=G)
    with jax_interpret():
        out, vjp = jax.vjp(lambda *t: jax_scores(*t, use_pallas=True), k1, k2, k3, a)
        want = [out, *vjp(g)]
    leaves = [_t(t).requires_grad_(True) for t in (k1, k2, k3, a)]
    got = GS.interactive_gat_scores(*leaves)
    got.backward(_t(g))
    for x, w in zip([got.detach()] + [t.grad for t in leaves], want):
        assert x.dtype == torch.bfloat16 and w.dtype == BF16
        _close(x, w)


def test_relu_kink_takes_the_float64_side():
    """k1 = -1, k2 = 1, k3 = 2^-25 at one (i, j, d): the fp32 sum k1 + (k2 +
    k3) is 0, the exact sum 2^-25 > 0. The backward counts g there, as the
    float64 sum says; an fp32 mask would drop it. Elsewhere the sums are
    far from 0 and the gradients are the float64 reference's."""
    B, G, D = 1, 3, 4
    rng = np.random.default_rng(5)
    k1 = torch.from_numpy(rng.normal(size=(B, G, D)).astype(np.float32))
    k2 = torch.from_numpy(rng.normal(size=(B, G, D)).astype(np.float32))
    k3 = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    k1[0, 2, 1], k2[0, 0, 1], k3[0, 1] = -1.0, 1.0, 2.0 ** -25
    assert float(k1[0, 2, 1] + (k2[0, 0, 1] + k3[0, 1])) == 0.0
    a = torch.from_numpy(rng.normal(size=D).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, G, G)).astype(np.float32))
    got = GS.interactive_gat_scores_bwd_plain(k1, k2, k3, a, g)
    ref = GS.interactive_gat_scores_bwd_plain(*(t.double() for t in (k1, k2, k3, a, g)))
    for x, r in zip(got, ref):
        torch.testing.assert_close(x.double(), r, rtol=1e-6, atol=1e-6)
    # the kink's term: gk1[0, 2, 1] holds a[1] * g[0, 0, 2]
    t = k1[:, None] + (k2[:, :, None] + k3[:, None, None])
    fp32_mask = torch.where(t > 0, g[..., None], torch.zeros(()))
    assert abs(float((fp32_mask.sum(dim=1) * a)[0, 2, 1] - got[0][0, 2, 1])) \
        == pytest.approx(abs(float(a[1] * g[0, 0, 2])), rel=1e-5)
    # at bf16 through the autograd Function, the same side
    leaves = [t.to(torch.bfloat16).requires_grad_(True) for t in (k1, k2, k3, a)]
    GS.interactive_gat_scores(*leaves).backward(g.to(torch.bfloat16))
    assert torch.equal(leaves[0].grad, GS.gat_scores_bwd_any(*(t.detach() for t in leaves),
                                                             g.to(torch.bfloat16))[0])


def _kernel_mask(k1, k2, k3):
    """C's backward kernel's mask (csrc/gat_scores.cu), replayed in fp32:
    t = k1 + c with c = k2 + k3, and t == +0 taken where the TwoSum error e
    of c is positive, by an integer compare of t's bits."""
    c = k2[:, :, None, :] + k3[:, None, None, :]
    cb = c - k2[:, :, None, :]
    e = (k2[:, :, None, :] - (c - cb)) + (k3[:, None, None, :] - cb)
    t = k1[:, None, :, :] + c
    thr = torch.where(e > 0, -1, 0).to(torch.int32)
    return t.view(torch.int32) > thr


def test_kernel_kink_rule_is_the_float64_rule():
    """The kernel's per-row rule takes the plain version's side (the float64
    sum's within KINK_TOL, the fp32 t's outside) at every term, on sums
    built at the kink: k1 = -fl(k2 + k3) moved by 0 to 3 ulps of either
    operand, k3 from 0 to 2^-20 of k2, and around powers of two."""
    rng = np.random.default_rng(9)
    B, G, D = 4, 16, 64
    k2 = torch.from_numpy(rng.normal(size=(B, G, D)).astype(np.float32))
    k2[0, :8] = torch.from_numpy(2.0 ** rng.integers(-3, 3, size=(8, D))).float()
    k3 = torch.from_numpy((rng.normal(size=(B, D)) * 2.0 ** rng.integers(-24, 0, size=(B, D)))
                          .astype(np.float32))
    k3[1] = 0.0
    c = (k2 + k3[:, None, :])[:, rng.permutation(G)]
    steps = torch.from_numpy(rng.integers(-3, 4, size=(B, G, D)).astype(np.float32))
    k1 = -c
    moved = torch.nextafter(k1, torch.where(steps > 0, torch.inf, -torch.inf))
    for _ in range(3):
        k1 = torch.where(steps.abs() > 0, moved, k1)
        steps = steps - steps.sign()
        moved = torch.nextafter(k1, torch.where(steps > 0, torch.inf, -torch.inf))
    k1[2] = torch.from_numpy(rng.normal(size=(G, D)).astype(np.float32))
    t = k1[:, None, :, :] + (k2[:, :, None, :] + k3[:, None, None, :])
    want = GS.relu_mask(k1, k2, k3, t)
    assert int((t == 0).sum()) > 100 and int((want != (t > 0)).sum()) > 10
    assert torch.equal(_kernel_mask(k1, k2, k3), want)


def test_wrappers_on_cpu_count_no_bf16_launch():
    q, k, v, w, mask = _attention_case(3, 12, HEADS * DK, seed=1)
    counts = lambda: (MA.attention_fwd.launches_bf16, MA.attention_bwd.launches_bf16,
                      DR.dropout.launches_bf16, GS.gat_scores_fwd.launches_bf16,
                      GL.interactive_gat_layer_fused.launches_bf16_act)
    before = counts()
    torch.testing.assert_close(MA.msa_attention(_t(q), _t(k), _t(v), HEADS),
                               MA._attention_plain(_t(q), _t(k), _t(v), HEADS), rtol=0, atol=0)
    x = _t(q)
    torch.testing.assert_close(DR.dropout(x, 0.2, 1, 2), DR.dropout_plain(x, 0.2, 1, 2),
                               rtol=0, atol=0)
    k1, k2, k3, a, _ = map(_t, _scores_case(2, 8, 16, seed=2))
    torch.testing.assert_close(GS.gat_scores_fwd(k1, k2, k3, a),
                               GS.gat_scores_fwd_plain(k1, k2, k3, a), rtol=0, atol=0)
    case = list(map(_t, _gat_case(3, 8, 32, seed=1)))
    torch.testing.assert_close(GL.interactive_gat_layer_fused(*case),
                               GL.interactive_gat_layer_plain(*case), rtol=0, atol=0)
    assert counts() == before
