"""Kernel B's bf16-activation instance and kernel C's bf16 forward
(digat_tpu_torch/csrc/gat_layer.cu, gat_scores.cu and the score tile they
share, gat_score_tile.cuh), replayed on the CPU in the order the kernels
work, from the launch plans the wrappers pass them:

1. B's projections on wgmma: y = x [W|W1|W2] + [bW|0|0] and k3 = q W3 + b3
   with bf16 operands padded to Dp (a multiple of 8), each 16-deep step's
   exact products added to the tile's fp32 sums rounding toward zero, each
   64-deep k-tile's sums added to the running sums rounding to nearest
   (kRN);
2. B's fused step, tile by tile as `ops.gat_layer.fused_plan` cuts it: the
   scores of a block's rows (thread (ti, tj) rows ti + q TIb, columns tj + r
   TJb) against each tile of columns, the features staged in slices of 32
   (zero past D and past the graph), c = k2 + k3 formed once, each score as
   (P[j] + Q[i] + sum over d, in order, of a |k1 + c|) / 2, with P and Q the
   a-weighted sums of k1's and c's rows in the staging's order (each
   thread's chunks over the slices, then the chunks' parts by the shuffles'
   tree); the leaky ReLU, the -1e9 mask and the softmax
   of each row; relu(alpha h) + x over slices of 4 CG features, rows in
   groups of 4, summed over j in order; each output rounded once to bf16;
3. C's bf16 forward, block by block as `ops.gat_scores.tile_plan` cuts it
   (at least two row blocks a graph), slice by slice, each score rounded
   once to bf16.

In float64 the replays equal the plain versions (1e-12), which shows that
the tiles cover every score and output once. In float32 (fmaf emulated in
float64, one rounding each) they are held against
`interactive_gat_layer_plain` / `gat_scores_fwd_plain` at the card's gate
(one bf16 ulp plus 1e-4 * max(1, max |plain|)), against the JAX package's
XLA compositions (`_fused_xla` on the bf16 inputs, `_scores_xla` on them
upcast, each rounded once) and against its Pallas kernels in interpret mode
at G >= 8 (`gat_layer.py`'s kernel cannot trace under 8 nodes, ROADMAP §3)
within one bf16 ulp plus 1e-5 * max(1, max |JAX|): the fp32 sums differ from
JAX's only in their order, by far less than half a bf16 ulp, so a rounding
lands at most one ulp apart. Shapes: G 5, 26 and 68 (and 100: two tiles of
columns), D 24, 30 and 400 (30 not a multiple of 8: padded to 32), a row
with no neighbour. The plans are checked for every graph to 140 nodes."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.ops.pallas.gat_layer import _fused_xla
from digat_tpu.ops.pallas.gat_layer import interactive_gat_layer_fused as jax_gat_layer
from digat_tpu.ops.pallas.gat_scores import _scores_xla, interactive_gat_scores_pallas
from digat_tpu_torch.layers import MASK_FILL
from digat_tpu_torch.ops import gat_layer as GL
from digat_tpu_torch.ops import gat_scores as GS
from digat_tpu_torch.ops.msa_attention import MAX_SMEM_BYTES
from tests.test_torch_msa_fwd_chain import round_toward_zero
from tests.test_torch_support import bf16_ulp, jax_interpret, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BF16 = torch.bfloat16
GATE = 1e-4  # the card's kernel gate: 1e-4 * max(1, max |plain|), one bf16 ulp more
JAX_TOL = 1e-5


def fmaf(a, b, c):
    """fmaf on float32 tensors: a b + c in float64 (a b exact), rounded once."""
    return (a.double() * b.double() + c.double()).float()


def wg_product(a, b, rn_tiles=True, kt=64):
    """a [M, K] @ b [K, N], both bf16 values (numpy float32), as the wgmma
    product sums it: each 16-deep step exact, added to the fp32 sums
    rounding toward zero; with `rn_tiles` (kRN) each kt-deep k-tile into
    fresh sums, then added to the running sums rounding to nearest."""
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    acc = total
    for k0 in range(0, a.shape[1], kt):
        if rn_tiles:
            acc = np.zeros_like(total)
        for k in range(k0, min(a.shape[1], k0 + kt), 16):
            step = a[:, k:k + 16].astype(np.float64) @ b[k:k + 16].astype(np.float64)
            acc = round_toward_zero(acc.astype(np.float64) + step)
        total = total + acc if rn_tiles else acc
    return total


def project(x, query, W, bW, W1, W2, W3, b3, a_vec, wgmma):
    """Step 1: (y [B G, 3Dp], k3 [B, Dp], a [Dp]) from the stacked weights
    padded to Dp (a multiple of 8), in float32 as the wgmma products sum them
    (`wgmma`) or in x's dtype."""
    B, G, D = x.shape
    Dp = GL.padded_width(D, 8)
    wy, by, w3, b3p, ap = GL.stacked_weights(W, bW, W1, W2, W3, b3, a_vec, 8)
    assert wy.shape == (3 * Dp, Dp) and Dp % 8 == 0
    pad = lambda t: torch.nn.functional.pad(t, (0, Dp - D))
    xk, qk = pad(x.reshape(B * G, D)), pad(query)
    if wgmma:
        prod = lambda a, b: torch.from_numpy(wg_product(a.float().numpy(),
                                                        b.float().t().contiguous().numpy()))
        y, k3 = prod(xk, wy) + by.float(), prod(qk, w3) + b3p.float()
        return y, k3, ap.float()
    dt = x.dtype
    return xk @ wy.t().to(dt) + by.to(dt), qk @ w3.t().to(dt) + b3p.to(dt), ap.to(dt)


def row_sums(rows, a, itemsize, fma):
    """P or Q of staged rows [B, n, D]: each thread's 16-byte chunk of every
    slice summed in order (a-weighted, one fmaf a feature), then the
    chunks' parts added as the shuffles add them: (v0 + v1) + (v2 + v3), ..."""
    B, n, D = rows.shape
    kE = 16 // itemsize
    cpr = GS.TILE_SLICE // kE
    parts = [torch.zeros((B, n), dtype=rows.dtype) for _ in range(cpr)]
    for d0 in range(0, D, GS.TILE_SLICE):
        for m in range(cpr):
            for d in range(d0 + m * kE, min(D, d0 + (m + 1) * kE)):
                v = rows[..., d]
                parts[m] = fma(a[d], v, parts[m]) if fma else parts[m] + a[d] * v
    step = 1
    while step < cpr:  # the xor butterfly, as lane 0 of the row's lanes ends with it
        parts = [parts[m] + parts[m ^ step] for m in range(cpr)]
        step *= 2
    return parts[0]


def score_tile(k1, c, a, rows, cols, fma, itemsize):
    """The scores of rows x cols ([B, len(rows), len(cols)]): (P[j] + Q[i] +
    sum over d of a |k1 + c|) / 2, the features in slices of 32, each d in
    order (staged rows and columns past the graph are zero: the kernel never
    writes their scores)."""
    B, G, D = k1.shape
    pad = lambda t, idx: torch.where((idx < G)[None, :, None],
                                     t[:, idx.clamp(max=G - 1)], torch.zeros((), dtype=t.dtype))
    cr, kc = pad(c, rows), pad(k1, cols)
    acc = torch.zeros((B, len(rows), len(cols)), dtype=k1.dtype)
    for d0 in range(0, D, GS.TILE_SLICE):
        for d in range(d0, min(D, d0 + GS.TILE_SLICE)):
            t = (kc[:, None, :, d] + cr[:, :, None, d]).abs()
            acc = fma(a[d], t, acc) if fma else acc + a[d] * t
    P, Q = row_sums(kc, a, itemsize, fma), row_sums(cr, a, itemsize, fma)
    return 0.5 * ((P[:, None, :] + Q[:, :, None]) + acc)


def tile_indices(plan, i0, j0):
    """(rows, cols) of a block's tile in the order its threads own them:
    thread (ti, tj) rows i0 + ti + q TIb and columns j0 + tj + r TJb."""
    R = plan.R
    rows = torch.tensor([i0 + ti + q * plan.TIb for q in range(R) for ti in range(plan.TIb)])
    cols = torch.tensor([j0 + tj + r * plan.TJb for r in range(R) for tj in range(plan.TJb)])
    return rows, cols


def fused(x, adj, y, k3, a, D, slope=0.2, fma=None):
    """Step 2 as gat_layer_fused_kernel runs it -> out [B, G, D] in
    x's dtype. y [B G, 3Dp] (h | k1 | k2), k3 [B, Dp], a [Dp]."""
    B, G, _ = x.shape
    Dp = k3.shape[1]
    y = y.reshape(B, G, 3 * Dp)
    h, k1, k2 = y[..., :Dp], y[..., Dp:2 * Dp], y[..., 2 * Dp:]
    c = k2 + k3[:, None, :]  # c = k2 + k3, formed once at staging
    plan = GL.fused_plan(G, D)
    t = plan.tile
    BI, BJ = t.R * t.TIb, t.R * t.TJb
    assert t.row_blocks * BI >= G > (t.row_blocks - 1) * BI
    assert t.col_blocks * BJ >= G > (t.col_blocks - 1) * BJ
    out = torch.full((B, G, D), float("nan"), dtype=torch.float64)
    written = torch.zeros((G, D), dtype=torch.int64)
    for bi in range(t.row_blocks):
        i0 = bi * BI
        s = torch.full((B, BI, G), float("nan"), dtype=y.dtype)  # the block's alpha^T
        for j0 in range(0, G, BJ):  # the block's tiles of columns, in turn
            rows, cols = tile_indices(t, 0, j0)
            acc = score_tile(k1, c, a, rows + i0, cols, fma, 4)
            keep = cols < G
            s[:, rows[:, None], cols[keep][None, :]] = acc[:, :, keep]
        n = min(BI, G - i0)
        s = s[:, :n]
        assert not s.isnan().any()  # every score of the block's rows, once
        e = torch.where(s > 0, s, slope * s)
        e = torch.where(adj[:, i0:i0 + n], e, torch.full_like(e, MASK_FILL))
        p = torch.exp(e - e.max(dim=2, keepdim=True).values)
        alpha = p / p.sum(dim=2, keepdim=True)
        for sl in range(plan.slices):  # slices of 4 CG features, rows in groups of 4
            feats = slice(4 * plan.CG * sl, min(D, 4 * plan.CG * (sl + 1)))
            for g0 in range(0, n, 4):
                r = slice(g0, min(n, g0 + 4))
                acc = torch.zeros_like(h[:, r, feats])
                for j in range(G):
                    acc = (fma(alpha[:, r, j, None], h[:, None, j, feats], acc) if fma else
                           acc + alpha[:, r, j, None] * h[:, None, j, feats])
                res = torch.relu(acc) + x[:, i0 + g0:i0 + r.stop, feats].to(acc.dtype)
                out[:, i0 + g0:i0 + r.stop, feats] = res.to(x.dtype).double()
                written[i0 + g0:i0 + r.stop, feats] += 1
    assert torch.equal(written, torch.ones_like(written))  # each output once
    return out.to(x.dtype)


def layer(case, wgmma):
    """B's bf16-activation instance, steps 1 and 2, on `case` (float64
    throughout, or bf16 inputs with fp32 math as the card runs it)."""
    x, adj, q, *w = case
    y, k3, a = project(x, q, *w, wgmma=wgmma)
    if x.dtype == torch.float64:
        return fused(x, adj, y, k3, a, x.shape[2])
    return fused(x, adj, y, k3, a, x.shape[2], fma=fmaf)


def _case(B, G, D, seed, dtype=np.float64):
    """x, adj, query and the weights (a row with no neighbour), float64 or
    rounded to bf16 values."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: rng.normal(size=s) * sc
    adj = (rng.random((B, G, G)) < 0.3) | np.eye(G, dtype=bool)
    adj[0, 1] = False
    sc = D ** -0.5
    vals = [f(B, G, D, sc=0.5), f(B, D, sc=0.5), f(D, D, sc=sc), f(D, sc=0.05), f(D, D, sc=sc),
            f(D, D, sc=sc), f(D, D, sc=sc), f(D, sc=0.05), f(D, sc=sc)]
    cast = (lambda t: torch.from_numpy(t)) if dtype == np.float64 else \
        (lambda t: torch.from_numpy(t).to(BF16))
    x, q, *w = (cast(t) for t in vals)
    return [x, torch.from_numpy(adj), q, *w]


def _close(got, want, tol):
    """got (bf16) within one bf16 ulp of want plus tol * max(1, max |want|)."""
    want = want.double()
    d = ((got.double() - want).abs() - bf16_ulp(want).double()).clamp(min=0)
    limit = tol * max(1.0, float(want.abs().max()))
    assert float(d.max()) <= limit, (float(d.max()), limit)


def _jax(t):
    """torch -> JAX, bf16 kept bf16."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _torch(a):
    a = jnp.asarray(a)
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16) \
        if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a))


def test_projection_on_wgmma_krn_at_64_deep_tiles():
    """B's projection shape (K 400, N 1,200) with bf16 operands: summed
    toward zero all the way, over 3 times further from float64 (RMS) than
    an fp32 product; with kRN at wgmma's 64-deep k-tiles no further than
    1.5 times."""
    rng = np.random.default_rng(400)
    bf = lambda t: torch.from_numpy(t).to(BF16).float().numpy()
    a = bf(rng.standard_normal((136, 400)).astype(np.float32) * 0.5)
    b = bf((rng.standard_normal((400, 1200)) * 400 ** -0.5).astype(np.float32))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rms = lambda t: float(np.sqrt(np.mean((t - ref) ** 2)))
    fp32 = rms(a @ b)
    assert rms(wg_product(a, b, rn_tiles=False)) > 3 * fp32
    assert rms(wg_product(a, b, rn_tiles=True)) <= 1.5 * fp32


@pytest.mark.parametrize("B,G,D", [(3, 5, 30), (2, 26, 24), (2, 68, 24), (2, 100, 8)])
def test_fused_layer_equals_the_plain_layer_fp64(B, G, D):
    case = _case(B, G, D, seed=G + D)
    got = layer(case, wgmma=False)
    torch.testing.assert_close(got, GL.interactive_gat_layer_plain(*case), rtol=0, atol=1e-12)


@pytest.mark.parametrize("B,G,D", [(3, 5, 30), (2, 26, 24), (2, 68, 24)])
def test_fused_layer_bf16_meets_the_gate_and_jax_xla(B, G, D):
    """The card's order of work (wgmma projections with kRN, the fused step
    with fmaf) on bf16 inputs against the plain layer at the card's gate,
    and against JAX's XLA composition."""
    case = _case(B, G, D, seed=3 * G + D, dtype=np.float32)
    got = layer(case, wgmma=True)
    assert got.dtype == BF16
    _close(got, GL.interactive_gat_layer_plain(*case), GATE)
    want = _fused_xla(*(_jax(t) for t in case), 0.2)
    assert want.dtype == jnp.bfloat16
    _close(got, _torch(want), JAX_TOL)


def test_fused_layer_at_d_400_meets_the_gate():
    """Production width D 400 (the projections at K 400, N 1,200) on one
    graph of 26 nodes."""
    case = _case(1, 26, 400, seed=7, dtype=np.float32)
    _close(layer(case, wgmma=True), GL.interactive_gat_layer_plain(*case), GATE)


def test_fused_layer_bf16_matches_the_jax_kernel_in_interpret_mode():
    case = _case(2, 26, 24, seed=11, dtype=np.float32)
    with jax_interpret():
        want = jax_gat_layer(*(_jax(t) for t in case), interpret=True)
    _close(layer(case, wgmma=True), _torch(want), JAX_TOL)


def test_no_neighbour_row_is_the_mean_of_h():
    case = _case(2, 26, 24, seed=5)
    x, W, bW = case[0], case[3], case[4]
    got = layer(case, wgmma=False)
    h = x[0] @ W + bW
    torch.testing.assert_close(got[0, 1], torch.relu(h.mean(dim=0)) + x[0, 1], rtol=0,
                               atol=1e-12)


def scores_bf16(k1, k2, k3, a, fma=None):
    """C's forward as gat_scores_fwd_bf16_kernel runs it: blocks of
    tile_plan(G, 2, 2), each score over the slices in order, in float64 or
    (bf16 inputs) float32, before the kernel's one rounding to bf16."""
    B, G, D = k1.shape
    acc_t = torch.float64 if k1.dtype == torch.float64 else torch.float32
    k1, k2, k3, a = (t.to(acc_t) for t in (k1, k2, k3, a))
    c = k2 + k3[:, None, :]
    plan = GS.tile_plan(G, 2, min_row_blocks=2)
    out = torch.full((B, G, G), float("nan"), dtype=acc_t)
    owners = torch.zeros((G, G), dtype=torch.int64)
    for bi in range(plan.row_blocks):
        for bj in range(plan.col_blocks):
            rows, cols = tile_indices(plan, bi * plan.R * plan.TIb, bj * plan.R * plan.TJb)
            acc = score_tile(k1, c, a, rows, cols, fma, 2)
            ri, cj = rows < G, cols < G
            out[:, rows[ri][:, None], cols[cj][None, :]] = acc[:, ri][:, :, cj]
            owners[rows[ri][:, None], cols[cj][None, :]] += 1
    assert torch.equal(owners, torch.ones_like(owners))  # every score once
    return out


def _scores_case(B, G, D, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    t = [torch.from_numpy(rng.normal(size=s) * 0.5) for s in ((B, G, D), (B, G, D), (B, D))]
    t.append(torch.from_numpy(rng.normal(size=D) * D ** -0.5))
    return t if dtype == np.float64 else [v.to(BF16) for v in t]


@pytest.mark.parametrize("B,G,D", [(3, 5, 30), (2, 26, 40), (2, 68, 24), (1, 100, 8)])
def test_c_bf16_forward_equals_the_plain_version_fp64(B, G, D):
    case = _scores_case(B, G, D, seed=G)
    torch.testing.assert_close(scores_bf16(*case), GS.gat_scores_fwd_plain(*case), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("B,G,D", [(3, 5, 30), (2, 26, 40), (2, 68, 24)])
def test_c_bf16_forward_meets_the_gate_and_jax(B, G, D):
    """fmaf in order over d, rounded once to bf16, against the plain version
    at the card's gate and against JAX's XLA scores on the upcast inputs."""
    case = _scores_case(B, G, D, seed=2 * G, dtype=np.float32)
    got = scores_bf16(*case, fma=fmaf).to(BF16)
    _close(got, GS.gat_scores_fwd_plain(*case), GATE)
    want = _scores_xla(*(_jax(t).astype(jnp.float32) for t in case)).astype(jnp.bfloat16)
    _close(got, _torch(want), JAX_TOL)


def test_c_bf16_forward_matches_the_jax_kernel_in_interpret_mode():
    case = _scores_case(3, 26, 24, seed=13, dtype=np.float32)
    with jax_interpret():
        want = interactive_gat_scores_pallas(*(_jax(t) for t in case))
    assert want.dtype == jnp.bfloat16
    _close(scores_bf16(*case, fma=fmaf).to(BF16), _torch(want), JAX_TOL)


@pytest.mark.parametrize("G,D", [(26, 40), (68, 400)])
def test_score_sums_stay_within_fp32_of_the_exact_scores(G, D):
    """The fp32 sums of (P + Q + sum a |t|) / 2 against the exact scores in
    float64: within 2^-20 of sum over d of |a| (|k1| + |c|), the scale of
    the three sums' terms (the form adds P + Q to sum a |t| where relu(t)
    is mostly 0 and they nearly cancel), far below the bf16 ulp (2^-8 of
    the score) that both kernels round to."""
    k1, k2, k3, a = (t.float() for t in _scores_case(1, G, D, seed=G))
    got = scores_bf16(k1, k2, k3, a, fma=fmaf).double()
    k1, k2, k3, a = (t.double() for t in (k1, k2, k3, a))
    c = (k2.float() + k3.float()[:, None, :]).double()  # c = fl(k2 + k3), as staged
    want = torch.einsum("bijd,d->bij", torch.relu(k1[:, None] + c[:, :, None]), a)
    scale = torch.einsum("bijd,d->bij", k1[:, None].abs() + c[:, :, None].abs(), a.abs())
    assert float(((got - want).abs() / scale).max()) <= 2.0 ** -20


@pytest.mark.parametrize("itemsize,min_rows", [(2, 2), (4, 1)])
def test_tile_plan_covers_every_graph(itemsize, min_rows):
    """For every G to 140 and a few larger: R 4 or 2, blocks of at most 320
    threads (a multiple of 32, one a thread's tile) that hold a slice's
    16-byte chunks 4 at a time, at most 24 threads' tiles along j, the row
    and column blocks covering G, at least `min_rows` row blocks where the
    graph has that many rows of tiles."""
    for G in list(range(1, 141)) + [200, 400, 1000]:
        p = GS.tile_plan(G, itemsize, min_row_blocks=min_rows)
        T = GS.tile_threads(p.R, p.TIb, p.TJb, itemsize)
        TI = math.ceil(G / p.R)
        assert p.R in (2, 4) and T % 32 == 0 and p.TIb * p.TJb <= T <= GS.TILE_THREADS
        chunks = p.R * (p.TIb + p.TJb) * (GS.TILE_SLICE * itemsize // 16)
        assert chunks <= GS.TILE_PRE * T and p.TJb <= GS.TILE_COLS
        assert (p.row_blocks - 1) * p.TIb < TI <= p.row_blocks * p.TIb
        assert (p.col_blocks - 1) * p.TJb < TI <= p.col_blocks * p.TJb
        assert p.row_blocks >= min(min_rows, TI)
        assert GS.fwd_bf16_smem_bytes(p, 400) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("D", [7, 30, 64, 398, 400])
def test_fused_plan_fits_its_block(D):
    """For every G to 140 and a few larger: the aggregation's row groups
    times its float4 columns within the block's threads, its slices covering
    D, and the block's shared memory under the card's limit."""
    for G in list(range(1, 141)) + [200, 300]:
        p = GL.fused_plan(G, D)
        groups = math.ceil(p.tile.R * p.tile.TIb / 4)
        assert p.threads == GS.tile_threads(p.tile.R, p.tile.TIb, p.tile.TJb, 4)
        assert groups * p.CG <= p.threads
        assert (p.slices - 1) * 4 * p.CG < D <= p.slices * 4 * p.CG
        assert GL.fused_smem_bytes(G, GL.padded_width(D, 8), p.tile, p.CG) <= MAX_SMEM_BYTES


def test_plans_at_the_main_shapes():
    """B at G 68 and 26 (D 400): a block a graph, 320 and 192 threads,
    60.1 KB and 26.4 KB; C at B 320: two row blocks a graph, 160 and 96
    threads, 32.9 KB and 14.7 KB (640 blocks each)."""
    assert GL.fused_plan(68, 400) == GL.FusedPlan(GS.TilePlan(4, 17, 17, 1, 1), 17, 320, 6)
    assert GL.fused_plan(26, 400) == GL.FusedPlan(GS.TilePlan(2, 13, 13, 1, 1), 25, 192, 4)
    assert GL.fused_smem_bytes(68, 400, GL.fused_plan(68, 400).tile, 17) == 61536
    assert GL.fused_smem_bytes(26, 400, GL.fused_plan(26, 400).tile, 25) == 27040
    p68, p26 = GS.tile_plan(68, 2, 2), GS.tile_plan(26, 2, 2)
    assert (p68, GS.tile_threads(4, 9, 17, 2)) == (GS.TilePlan(4, 9, 17, 2, 1), 160)
    assert (p26, GS.tile_threads(2, 7, 13, 2)) == (GS.TilePlan(2, 7, 13, 2, 1), 96)
    assert (GS.fwd_bf16_smem_bytes(p68, 400), GS.fwd_bf16_smem_bytes(p26, 400)) == (33696, 15008)
    assert GL.padded_width(398, 8) == 400 and GL.padded_width(30, 8) == 32


@pytest.mark.parametrize("ptrs,ld1,ld2,D,vector", [
    ((0, 16), 1200, 1200, 400, True), ((2, 16), 1200, 1200, 400, False),
    ((0, 16), 1194, 1200, 398, False), ((0, 16), 1204, 1200, 400, False),
    ((0, 16), 96, 96, 30, False), ((0, 16), 200, 200, 64, True)])
def test_vector_copy_rule(ptrs, ld1, ld2, D, vector):
    """16-byte copies of eight bf16 only where D, both row strides and both
    pointers allow them."""
    assert GS.bf16_vector_copies(ptrs, ld1, ld2, D) is vector
