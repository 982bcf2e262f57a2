"""Kernel B's bf16-weight instance (digat_tpu_torch/csrc/gat_layer.cu:
gat_layer_project_bf16, then gat_layer_fused_f32), replayed on the CPU in
the order the kernels work, from the plans the wrapper passes them:

1. x and query split into three bf16 planes each (hi, mid, lo: tc_wgmma.cuh
   split3_kernel, `tests.test_torch_bf16_split.split3`), padded to Dp (a
   multiple of 8); y = x [W|W1|W2] + [bW|0|0] and k3 = q W3 + b3 on wgmma
   against the exact bf16 weights: for each 64-deep k-tile three passes
   (lo, mid, hi: `pass_a`), each 16-deep step's exact product added to the
   tile's fresh fp32 sums rounding toward zero, then the tile's sums added
   to the running sums rounding to nearest (kRN); the bias added in fp32;
2. the fused step on fp32 x, tile by tile as `ops.gat_layer.fused_plan`
   cuts it (`tests.test_torch_gat_bf16_tiles.fused`: the block's scores in
   registers, the softmax, relu(alpha h) + x over slices of h), each output
   written as fp32, not rounded.

In float64 (the split the identity, no rounding) the replay equals
`interactive_gat_layer_plain` (1e-12), which shows that the k-tiles,
passes and tiles cover every term and output once. In float32 (fmaf
emulated in float64, one rounding each) it is held against the plain
version at the card's gate, 1e-4 * max(1, max |plain|), against the JAX
package's XLA composition `_fused_xla` on the same bf16 weights and against
its Pallas kernel in interpret mode at G >= 8 (`gat_layer.py`'s kernel
cannot trace under 8 nodes), within 1e-5 * max(1, max |JAX|), the figure of
`test_gat_layer_plain_with_bf16_weights_matches_jax_kernel`: the planes
carry x to 2^-24 |x| and the fp32 sums differ from JAX's only in their
order. Shapes: G 5, 26, 68 and 100 (two tiles of columns), D 24, 30
(padded to 32) and 400, a row with no neighbour. Inputs from numpy with a
seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.ops.pallas.gat_layer import _fused_xla
from digat_tpu.ops.pallas.gat_layer import interactive_gat_layer_fused as jax_gat_layer
from digat_tpu_torch.ops import gat_layer as GL
from tests.test_torch_bf16_split import split3
from tests.test_torch_gat_bf16_tiles import _jax, fmaf, fused
from tests.test_torch_msa_fwd_chain import round_toward_zero
from tests.test_torch_support import jax_interpret, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BF16 = torch.bfloat16
GATE = 1e-4  # the card's kernel gate: 1e-4 * max(1, max |plain|)
JAX_TOL = 1e-5  # against the JAX package: 1e-5 * max(1, max |JAX|)
KT, STEP = 64, 16  # wgmma's k-tile and step


def planes(a):
    """The terms of an operand in the order the passes read them (lo, mid,
    hi): float32 a's three bf16 planes, or float64 a alone."""
    if a.dtype == torch.float64:
        return [a.numpy()]
    return [t.double().numpy() for t in reversed(split3(a))]


def wg_split_product(a, b):
    """a [M, K] @ b [K, N] (b's values bf16, a fp32 split into planes) as
    the three-pass wgmma product sums it; in float64 (a float64) the same
    k-tiles and steps with no rounding."""
    exact = a.dtype == torch.float64
    terms, bn = planes(a), b.double().numpy()
    M, K = a.shape
    total = np.zeros((M, bn.shape[1]), np.float64 if exact else np.float32)
    for k0 in range(0, K, KT):
        acc = np.zeros_like(total)  # the k-tile's fresh sums
        for term in terms:
            for k in range(k0, min(K, k0 + KT), STEP):
                step = term[:, k:k + STEP] @ bn[k:k + STEP]
                acc = acc + step if exact else round_toward_zero(acc.astype(np.float64) + step)
        total = total + acc  # kRN: rounding to nearest in float32
    return torch.from_numpy(total)


def project(x, query, W, bW, W1, W2, W3, b3, a_vec):
    """Step 1 -> (y [B G, 3Dp], k3 [B, Dp], a [Dp]), x, query and the
    result in x's dtype, the weights padded to Dp."""
    B, G, D = x.shape
    Dp = GL.padded_width(D, 8)
    wy, by, w3, b3p, ap = GL.stacked_weights(W, bW, W1, W2, W3, b3, a_vec, 8)
    assert wy.shape == (3 * Dp, Dp) and Dp % 8 == 0
    pad = lambda t: torch.nn.functional.pad(t, (0, Dp - D))
    xk, qk = pad(x.reshape(B * G, D)), pad(query)
    dt = x.dtype
    y = wg_split_product(xk, wy.t().to(dt)) + by.to(dt)
    k3 = wg_split_product(qk, w3.t().to(dt)) + b3p.to(dt)
    return y, k3, ap.to(dt)


def layer(case):
    """The bf16-weight instance, steps 1 and 2, on `case` (float64
    throughout, or fp32 x and query with bf16 weights as the card runs it)."""
    x, adj, q, *w = case
    y, k3, a = project(x, q, *w)
    return fused(x, adj, y, k3, a, x.shape[2],
                 fma=None if x.dtype == torch.float64 else fmaf)


def _case(B, G, D, seed, dtype=np.float64):
    """x, adj, query and the weights (row 1 of graph 0 with no neighbour):
    all float64, or fp32 x, query and vectors with bf16 weight matrices."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: rng.normal(size=s) * sc
    adj = (rng.random((B, G, G)) < 0.3) | np.eye(G, dtype=bool)
    adj[0, 1] = False
    sc = D ** -0.5
    vals = [f(B, G, D, sc=0.5), f(B, D, sc=0.5), f(D, D, sc=sc), f(D, sc=0.05), f(D, D, sc=sc),
            f(D, D, sc=sc), f(D, D, sc=sc), f(D, sc=0.05), f(D, sc=sc)]
    t = [torch.from_numpy(v) for v in vals]
    if dtype != np.float64:
        t = [v.to(BF16) if v.dim() == 2 and i >= 2 else v.float() for i, v in enumerate(t)]
    x, q, *w = t
    return [x, torch.from_numpy(adj), q, *w]


def _close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    want = want.double()
    err, limit = float((got.double() - want).abs().max()), tol * max(1.0, float(want.abs().max()))
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("B,G,D", [(3, 5, 30), (2, 26, 24), (2, 68, 30), (1, 100, 24),
                                   (1, 26, 400)])
def test_bf16_weight_layer_equals_the_plain_layer_fp64(B, G, D):
    case = _case(B, G, D, seed=G + D)
    got = layer(case)
    torch.testing.assert_close(got, GL.interactive_gat_layer_plain(*case), rtol=0, atol=1e-12)


@pytest.mark.parametrize("B,G,D", [(3, 5, 30), (2, 26, 24), (2, 68, 30), (1, 100, 24),
                                   (1, 26, 400), (1, 68, 400)])
def test_bf16_weight_layer_meets_the_gate_and_jax_xla(B, G, D):
    """The card's order of work (x's planes in three wgmma passes with kRN,
    the fused step with fmaf) on fp32 x and bf16 weights against the plain
    layer at the card's gate, and against JAX's XLA composition."""
    case = _case(B, G, D, seed=3 * G + D, dtype=np.float32)
    got = layer(case)
    assert got.dtype == torch.float32
    _close(got, GL.interactive_gat_layer_plain(*case), GATE)
    want = _fused_xla(*(_jax(t) for t in case), 0.2)
    assert want.dtype == jnp.float32
    _close(got, torch.from_numpy(np.array(want)), JAX_TOL)


@pytest.mark.parametrize("B,G,D", [(2, 26, 24), (2, 68, 30)])
def test_bf16_weight_layer_matches_the_jax_kernel_in_interpret_mode(B, G, D):
    case = _case(B, G, D, seed=11 + G, dtype=np.float32)
    with jax_interpret():
        want = jax_gat_layer(*(_jax(t) for t in case), interpret=True)
    assert want.dtype == jnp.float32
    _close(layer(case), torch.from_numpy(np.array(want)), JAX_TOL)


def test_three_passes_carry_x_as_fp32_does():
    """The projection's shape at production width (K 400, N 1,200) from an
    fp32 x and bf16 weights: the three passes with kRN stay within 2^-20 of
    the terms' magnitudes of the float64 product, as close as an fp32
    product; one pass (x rounded to bf16) is over 100 times further (RMS)."""
    rng = np.random.default_rng(400)
    a = torch.from_numpy(rng.standard_normal((136, 400)).astype(np.float32) * 0.5)
    b = torch.from_numpy((rng.standard_normal((400, 1200)) * 400 ** -0.5).astype(np.float32))
    b = b.to(BF16).float()
    ref = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    got = wg_split_product(a, b).double()
    assert float(((got - ref).abs() / scale).max()) <= 2.0 ** -20
    rms = lambda t: float(((t - ref) ** 2).mean().sqrt())
    assert rms(got) <= 1.5 * rms((a @ b).double())
    assert rms((a.to(BF16).float() @ b).double()) > 100 * rms(got)


def test_no_neighbour_row_is_the_mean_of_h():
    case = _case(2, 26, 24, seed=5, dtype=np.float32)
    x, W, bW = case[0], case[3], case[4]
    got = layer(case)
    h = x[0].double() @ W.double() + bW.double()
    torch.testing.assert_close(got[0, 1].double(), torch.relu(h.mean(dim=0)) + x[0, 1].double(),
                               rtol=0, atol=1e-5)
