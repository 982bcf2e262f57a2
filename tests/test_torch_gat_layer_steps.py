"""Kernel B's three steps (digat_tpu_torch/csrc/gat_layer.cu), replayed in
plain torch on the CPU as the kernels run them:

1. the projection on the stacked weights of `ops.gat_layer.stacked_weights`:
   y = x [W|W1|W2] + [bW|0|0] ([B G, 3Dp]) and k3 = q W3 + b3, with D
   padded with zeros to Dp, the next multiple of 4;
2. kernel C''s scores on y's k1 and k2 column blocks
   (`ops.gat_scores.interactive_gat_scores_fused_y`, plain on the CPU);
3. the attend step tile by tile as `ops.gat_layer.attend_plan` cuts it:
   leaky ReLU, the -1e9 mask and the softmax over j of a tile's rows, then
   relu(alpha h) + x over a slice of features, summed over j in order.

The replay is held against `interactive_gat_layer_plain` in float64 (1e-12)
and against the JAX package's XLA composition of the layer
(`digat_tpu/ops/pallas/gat_layer.py::_fused_xla`) in float32 (1e-5), at
G 6, 26 and 68, at a D that is not a multiple of 4 and with a row that has
no neighbour. With the projections at 3xTF32 as `tc_gemm.cuh` sums them
(kRN: each 32-deep k-tile rounded to nearest into the running sums), at
K 400, it meets the card's gate against float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.ops.pallas.gat_layer import _fused_xla
from digat_tpu_torch.layers import MASK_FILL
from digat_tpu_torch.ops import gat_layer as GL
from digat_tpu_torch.ops.gat_scores import interactive_gat_scores_fused_y
from digat_tpu_torch.ops.msa_attention import MAX_SMEM_BYTES
from tests.test_torch_msa_fwd_chain import tc_3xtf32

GATE = 1e-4  # the card's kernel gate: 1e-4 * max(1, max |plain|)


def matmul(a, b):
    return a @ b


def product_tf32x3(a, b):
    """a @ b as kernel B's projections sum it (3xTF32, kRN), float32."""
    return torch.from_numpy(tc_3xtf32(a.numpy(), b.numpy(), rn_tiles=True))


def steps(x, adj, query, W, bW, W1, W2, W3, b3, a_vec, slope=0.2, product=matmul):
    B, G, D = x.shape
    Dp = GL.padded_width(D)
    pad = lambda t: torch.nn.functional.pad(t, (0, Dp - D))
    # 1. the projections on the stacked, padded weights
    wy, by, w3, b3p, ap = GL.stacked_weights(W, bW, W1, W2, W3, b3, a_vec)
    assert wy.shape == (3 * Dp, Dp) and by.shape == (3 * Dp,) and w3.shape == (Dp, Dp)
    y = product(pad(x.reshape(B * G, D)), wy.t().contiguous()) + by
    k3 = product(pad(query), w3.t().contiguous()) + b3p
    assert not y.reshape(B * G, 3, Dp)[..., D:].any() and not k3[:, D:].any()  # pads are 0
    # 2. kernel C' on y's k1 and k2 column blocks, D padded with a = 0
    s = interactive_gat_scores_fused_y(y.reshape(B, G, 3 * Dp), k3, ap)
    # 3. the attend step, tile by tile
    h = y[:, :D].reshape(B, G, D)
    plan = GL.attend_plan(G, D)
    out = torch.full_like(x, float("nan"))
    for t in range(plan.row_tiles):
        rows = slice(t * plan.TI, min(G, (t + 1) * plan.TI))
        e = torch.where(s[:, rows] > 0, s[:, rows], slope * s[:, rows])
        e = torch.where(adj[:, rows], e, torch.full_like(e, MASK_FILL))
        p = torch.exp(e - e.max(dim=2, keepdim=True).values)
        alpha = p / p.sum(dim=2, keepdim=True)
        for c in range(plan.slices):
            cols = slice(4 * plan.CG * c, min(D, 4 * plan.CG * (c + 1)))
            acc = torch.zeros_like(out[:, rows, cols])
            for j in range(G):
                acc = acc + alpha[:, :, j, None] * h[:, None, j, cols]
            out[:, rows, cols] = torch.relu(acc) + x[:, rows, cols]
    assert not out.isnan().any()  # the tiles cover every row and feature
    return out


def _case(B, G, D, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, G, D)) * 0.5
    adj = (rng.random((B, G, G)) < 0.3) | np.eye(G, dtype=bool)
    adj[0, 1] = False  # a row with no neighbour: uniform alpha
    q = rng.normal(size=(B, D)) * 0.5
    W, W1, W2, W3 = (rng.normal(size=(D, D)) * D ** -0.5 for _ in range(4))
    bW, b3 = (rng.normal(size=(D,)) * 0.05 for _ in range(2))
    a = rng.normal(size=(D,)) * D ** -0.5
    cast = lambda t: t if t.dtype == bool else t.astype(dtype)
    return tuple(cast(t) for t in (x, adj, q, W, bW, W1, W2, W3, b3, a))


_SHAPES = [(4, 6, 16), (3, 26, 32), (2, 68, 24), (3, 26, 18), (2, 68, 30), (2, 9, 7)]


@pytest.mark.parametrize("B,G,D", _SHAPES, ids=lambda v: str(v))
def test_steps_equal_the_plain_layer_fp64(B, G, D):
    case = tuple(torch.from_numpy(t) for t in _case(B, G, D, seed=G + D))
    got = steps(*case)
    want = GL.interactive_gat_layer_plain(*case)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("B,G,D", _SHAPES, ids=lambda v: str(v))
def test_steps_match_jax_xla_fp32(B, G, D):
    case = _case(B, G, D, seed=3 * G + D, dtype=np.float32)
    want = np.asarray(_fused_xla(*(jnp.asarray(t) for t in case), 0.2))
    got = steps(*(torch.from_numpy(t) for t in case)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_no_neighbour_row_is_the_mean_of_h():
    case = tuple(torch.from_numpy(t) for t in _case(2, 26, 32, seed=5))
    case[1][1, 3] = False
    x, _, _, W, bW = case[:5]
    got = steps(*case)
    h = x[1] @ W + bW
    torch.testing.assert_close(got[1, 3], torch.relu(h.mean(dim=0)) + x[1, 3], rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("G", [26, 68])
def test_steps_at_3xtf32_meet_the_gate(G):
    """Production width D 400 (the projections at K 400, N 1,200), the
    products emulated as the tensor cores sum them with kRN, against the
    float64 plain layer."""
    case = _case(2, G, 400, seed=G, dtype=np.float32)
    got = steps(*(torch.from_numpy(t) for t in case), product=product_tf32x3)
    ref = GL.interactive_gat_layer_plain(*(torch.from_numpy(t.astype(np.float64) if
                                                            t.dtype != bool else t)
                                           for t in case))
    err = float((got.double() - ref).abs().max())
    assert err <= GATE * max(1.0, float(ref.abs().max())), err


def test_projection_krn_at_k_400():
    """B's projection shape (K 400, N 1,200): 3xTF32 summed toward zero all
    the way lands over 4 times further from float64 (RMS) than an fp32
    product, and with kRN within 1.5 times, as for A's products."""
    rng = np.random.default_rng(400)
    a = rng.standard_normal((136, 400)).astype(np.float32)
    b = (rng.standard_normal((400, 1200)) * 400 ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rms = lambda t: float(np.sqrt(np.mean((t - ref) ** 2)))
    fp32 = rms(a @ b)
    assert rms(tc_3xtf32(a, b, rn_tiles=False)) > 4 * fp32
    assert rms(tc_3xtf32(a, b, rn_tiles=True)) <= 1.5 * fp32


@pytest.mark.parametrize("D", [7, 30, 64, 400])
def test_attend_plan_fits_its_block(D):
    """For every G up to 128 and a few larger graphs, at D 400 (the
    production width), small test widths and ones not a multiple of 4: rows
    in tiles of at most 32, a multiple of 4, covering G; features in float4
    columns covering D; at most 256 threads and the block's shared memory
    under the card's limit."""
    for G in list(range(1, 129)) + [200, 400, 800]:
        p = GL.attend_plan(G, D)
        assert p.TI % 4 == 0 and p.TI <= GL.MAX_ROWS
        assert (p.row_tiles - 1) * p.TI < G <= p.row_tiles * p.TI
        assert (p.slices - 1) * 4 * p.CG < D <= p.slices * 4 * p.CG
        assert p.TI // 4 * p.CG <= GL.MAX_THREADS
        assert GL.attend_smem_bytes(G, p.TI, p.CG) <= MAX_SMEM_BYTES


def test_attend_plan_at_the_serving_graphs():
    """G 26 and 68 at D 400: one tile of 28 and three of 24 rows, three
    slices of 136 features; 17 KB and 43.5 KB a block."""
    assert GL.attend_plan(26, 400) == GL.AttendPlan(28, 34, 1, 3)
    assert GL.attend_plan(68, 400) == GL.AttendPlan(24, 34, 3, 3)
    assert GL.attend_smem_bytes(68, 24, 34) == 43520
