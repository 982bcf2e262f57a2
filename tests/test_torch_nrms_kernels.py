"""The plain versions of the NRMS slice's kernels against the JAX functions
they replace, on the CPU, forward and `jax.grad` of a scalar loss:

  * the attention pair (stands in for E and F): the port's `msa_attention`
    against `digat_tpu.ops.pallas.msa_attention.msa_attention` (F) through
    its XLA path and in Pallas interpret mode, at L 12, 20 and 130 (L 130
    only F takes); the port's `msa_attention_grouped` against
    `msa_attention_grouped` (E) through its XLA path and with
    `interpret=True`, on the head-padded layout, at L 12 and 20; each
    unmasked, key-masked, and with a sequence whose keys are all masked;
    4 heads of width 6, 5 sequences; and F at the wide instance's heads (2
    heads of dk 80, 100 and 128, L 32 and 160: on the card
    `csrc/msa_attention_wide.cu`); max |port - JAX| <= 1e-5 * max(1, max
    |JAX|) per output;
  * C' (Eq. 8 scores read from the fused projection y): the port's
    `interactive_gat_scores_fused_y` against
    `interactive_gat_scores_fused_y_pallas` in interpret mode at G 26, and
    against its XLA path at G 6 and 26 (the JAX kernel cannot trace under
    8 nodes, ROADMAP.md section 3), <= 1e-5.

The attention kernels select the mask (`where`), as the reference and the
JAX XLA path do; E and F add -1e9. On a sequence whose keys are all masked
every score then rounds to -1e9 in both, so the outputs and dv agree, but E
and F pass a gradient to q and k there and the select passes none: against
the Pallas kernels that sequence's dq and dk are held to be 0 on the port's
side and the difference is recorded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.ops.pallas import msa_attention as JF
from digat_tpu.ops.pallas import msa_attention_grouped as JE
from digat_tpu.ops.pallas import runtime as jax_runtime
from digat_tpu.ops.pallas.gat_scores import interactive_gat_scores_fused_y_pallas
from digat_tpu_torch.ops import build
from digat_tpu_torch.ops import gat_scores as GS
from digat_tpu_torch.ops import msa_attention as MA
from digat_tpu_torch.ops import msa_attention_grouped as MG

N, HEADS, DK = 5, 4, 6
MASKS = ["unmasked", "masked", "all_masked_row"]


def _limit(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def _case(L, mask_kind, seed, heads=HEADS, dk=DK):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(size=(N, L, heads * dk)).astype(np.float32) for _ in range(4))
    mask = None
    if mask_kind != "unmasked":
        mask = rng.random((N, L)) < 0.7
        mask[:, 0] = True
        if mask_kind == "all_masked_row":
            mask[0] = False
    return q, k, v, w, mask


def _pad(x, dkp):
    """packed [N, L, H * dk] -> head-padded [N, L, H * dkp], zero pad lanes."""
    n, L, _ = x.shape
    return np.pad(x.reshape(n, L, HEADS, DK), ((0, 0), (0, 0), (0, 0), (0, dkp - DK))
                  ).reshape(n, L, HEADS * dkp)


def _jax(fn, q, k, v, w, interpret):
    """(out, dq, dk, dv) of sum(fn(q, k, v) * w) in the JAX package."""
    jax_runtime.set_interpret(interpret)
    try:
        out, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
        grads = vjp(jnp.asarray(w))
    finally:
        jax_runtime.set_interpret(False)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port(fn, q, k, v, w):
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*t)
    out.backward(torch.from_numpy(w))
    return [out.detach().numpy()] + [x.grad.numpy() for x in t]


def _compare(got, want, mask, pallas):
    for name, g, ref in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        if pallas and mask is not None and not mask[0].any() and name in ("dq", "dk"):
            # the all-masked sequence: no gradient through the select, and
            # E / F's additive mask passes one (the recorded difference)
            assert not g[0].any(), name
            assert np.abs(ref[0]).max() > 1e-3, name
            g, ref = g[1:], ref[1:]
        err = float(np.abs(g - ref).max())
        assert err <= _limit(ref), (name, err)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("L", [12, 20, 130])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_msa_attention_matches_jax_f(impl, L, mask_kind):
    q, k, v, w, mask = _case(L, mask_kind, seed=L)
    jm = None if mask is None else jnp.asarray(mask)
    want = _jax(lambda a, b, c: JF.msa_attention(a, b, c, HEADS, mask=jm), q, k, v, w,
                impl == "pallas_interpret")
    tm = None if mask is None else torch.from_numpy(mask)
    got = _port(lambda a, b, c: MA.msa_attention(a, b, c, HEADS, tm), q, k, v, w)
    _compare(got, want, mask, impl == "pallas_interpret")


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("L", [32, 160])
@pytest.mark.parametrize("dk", [80, 100, 128])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_msa_attention_wide_heads_match_jax_f(impl, dk, L, mask_kind):
    """F at heads of dk 65-128, which the port's wide instance takes on the
    card; 2 heads."""
    q, k, v, w, mask = _case(L, mask_kind, seed=dk + L, heads=2, dk=dk)
    assert MA.head_width(dk) == MA.WIDE
    jm = None if mask is None else jnp.asarray(mask)
    want = _jax(lambda a, b, c: JF.msa_attention(a, b, c, 2, mask=jm), q, k, v, w,
                impl == "pallas_interpret")
    tm = None if mask is None else torch.from_numpy(mask)
    got = _port(lambda a, b, c: MA.msa_attention(a, b, c, 2, tm), q, k, v, w)
    _compare(got, want, mask, impl == "pallas_interpret")


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("L", [12, 20])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_msa_attention_grouped_matches_jax_e(impl, L, mask_kind):
    q, k, v, w, mask = _case(L, mask_kind, seed=100 + L)
    g = MG.group_size(HEADS, L, DK)
    assert g == JE.group_size(HEADS, L, DK) == 4
    q, k, v, w = (_pad(x, 128 // g) for x in (q, k, v, w))  # the loss reads real lanes only
    jm = None if mask is None else jnp.asarray(mask)
    interpret = impl == "pallas_interpret"
    want = _jax(lambda a, b, c: JE.msa_attention_grouped(a, b, c, HEADS, DK, mask=jm,
                                                         interpret=interpret),
                q, k, v, w, interpret)
    tm = None if mask is None else torch.from_numpy(mask)
    got = _port(lambda a, b, c: MG.msa_attention_grouped(a, b, c, HEADS, DK, tm), q, k, v, w)
    for x in got:  # pad lanes zero, as E's
        assert not x.reshape(N, L, HEADS, -1)[..., DK:].any()
    _compare(got, want, mask, interpret)


def test_grouped_helpers_match_jax():
    rng = np.random.default_rng(0)
    w, b = rng.normal(size=(24, HEADS * DK)).astype(np.float32), \
        rng.normal(size=HEADS * DK).astype(np.float32)
    for heads, L, dk in ((20, 32, 20), (20, 50, 20), (16, 32, 25), (4, 130, 6), (3, 40, 50)):
        assert MG.group_size(heads, L, dk) == JE.group_size(heads, L, dk)
    wp, bp = MG.pad_head_projection(torch.from_numpy(w), torch.from_numpy(b), HEADS, 32)
    jw, jb = JE.pad_head_projection(jnp.asarray(w), jnp.asarray(b), HEADS, 32)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(MG.unpad_heads(wp, HEADS, DK).numpy(), w)


def test_grouped_refuses_what_only_f_takes():
    q = torch.zeros(2, 130, HEADS * 32)
    with pytest.raises(ValueError, match="group size"):
        MG.msa_attention_grouped(q, q, q, HEADS, DK)


def test_kernel_path_goes_through_its_autograd_function(monkeypatch):
    """On a CUDA tensor `msa_attention` runs MSAAttentionFunction: with the
    dispatch sent down that path and the two launches replaced by the plain
    computations, the result carries a graph whose backward is the
    backward kernel, and the gradients are the plain ones."""
    launched = []

    def forward_launch(q, k, v, mask, heads, dk):
        launched.append("fwd")
        with torch.no_grad():
            return MA.attention_plain_strided(q, k, v, heads, dk, mask)

    def backward_launch(q, k, v, mask, do, heads, dk):
        launched.append("bwd")
        return MA.attention_bwd_plain(q, k, v, mask, do, heads, dk)

    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    monkeypatch.setattr(MA, "attention_fwd", forward_launch)
    monkeypatch.setattr(MA, "attention_bwd", backward_launch)
    q, k, v, w, mask = _case(12, "all_masked_row", seed=3)
    tm = torch.from_numpy(mask)
    got = _port(lambda a, b, c: MA.msa_attention(a, b, c, HEADS, tm), q, k, v, w)
    assert launched == ["fwd", "bwd"]
    monkeypatch.setattr(build, "use_kernel", lambda where: False)
    want = _port(lambda a, b, c: MA.msa_attention(a, b, c, HEADS, tm), q, k, v, w)
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g, ref, rtol=1e-6, atol=1e-6)


def test_kernel_path_refuses_sequences_beyond_its_cap(monkeypatch):
    """A sequence whose head does not fit a block's shared memory raises
    with the longest length the kernel takes; it never falls back."""
    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    longest = MA.max_length(DK)
    assert 300 < longest < MA.max_length(DK, backward=False)
    assert 314 <= MA.max_length(20) < 894 <= MA.max_length(20, backward=False)
    assert MA.max_length(64) >= 127 and MA.max_length(64, backward=False) >= 283
    ok = torch.zeros(1, longest, HEADS * DK)
    MA._check(ok, ok, ok, None, HEADS, DK, True, "msa_attention")
    long = torch.zeros(1, longest + 1, HEADS * DK, requires_grad=True)
    with pytest.raises(ValueError, match=f"longest it takes is {longest}"):
        MA.attention_bwd(long, long, long, None, long, HEADS, DK)
    too_long = torch.zeros(1, MA.max_length(DK, backward=False) + 1, HEADS * DK)
    with pytest.raises(ValueError, match="shared memory"):
        MA.msa_attention(too_long, too_long, too_long, HEADS)


@pytest.mark.parametrize("G,interpret", [(26, True), (26, False), (6, False)],
                         ids=["26-pallas_interpret", "26-xla", "6-xla"])
def test_fused_y_scores_match_jax(G, interpret):
    """C': kernel C's entry point on y = x [W|W1|W2]; its gradient into y is
    [0 | gk1 | gk2]."""
    rng = np.random.default_rng(G)
    B, D = 5, 40
    y, k3, a, g = (rng.normal(size=s).astype(np.float32) * 0.5
                   for s in ((B, G, 3 * D), (B, D), (D,), (B, G, G)))
    jax_runtime.set_interpret(interpret)
    try:
        s, vjp = jax.vjp(interactive_gat_scores_fused_y_pallas,
                         *(jnp.asarray(t) for t in (y, k3, a)))
        want = [np.asarray(s)] + [np.asarray(t) for t in vjp(jnp.asarray(g))]
    finally:
        jax_runtime.set_interpret(False)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (y, k3, a)]
    out = GS.interactive_gat_scores_fused_y(*t)
    out.backward(torch.from_numpy(g))
    got = [out.detach().numpy()] + [x.grad.numpy() for x in t]
    assert not got[1][..., :D].any()
    for name, gv, ref in zip(("scores", "dy", "dk3", "da"), got, want):
        assert np.abs(gv - ref).max() <= _limit(ref), name
