"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA device and nvcc; every test here is marked `cuda` and skips
without a card. The machine with the card has no JAX, so run these without
the repository's conftest (which configures JAX):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|) (fp32 sums in
another order)."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from digat_tpu_torch.config import Config
from digat_tpu_torch.eval.scorer import CachedScorer
from digat_tpu_torch.models.model import Model, TrainBatch
from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables
from digat_tpu_torch.ops import dropout as DR
from digat_tpu_torch.ops import emb_grad as EG
from digat_tpu_torch.ops import gat_scores as GS
from digat_tpu_torch.ops import msa_attention as MA
from digat_tpu_torch.ops import msa_attention_grouped as MG
from digat_tpu_torch.ops import msa_encoder as ME
from digat_tpu_torch.ops.gat_layer import interactive_gat_layer_fused, interactive_gat_layer_plain
from digat_tpu_torch.ops.msa_encoder import msa_encoder_pooled, msa_encoder_pooled_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(out, ref):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * max(1.0, float(ref.abs().max())), err


def _msa_args(dev, N, Din, heads, dk, A, seed, L=32):
    g = torch.Generator().manual_seed(seed)
    D = heads * dk
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)
    x = r(N, L, Din)
    mask = (torch.rand(N, L, generator=g) < 0.75).to(dev)
    mask[0] = False  # all-pad title
    return (x, mask, r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(Din, D, sc=Din ** -0.5),
            r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(D, A, sc=D ** -0.5), r(A, sc=0.1),
            r(A, sc=A ** -0.5), heads)


def _no_bias(args):
    """The encoder's arguments with bq, bv and b1 zeroed."""
    args = list(args)
    for i in (3, 6, 8):
        args[i] = torch.zeros_like(args[i])
    return tuple(args)


# N over the product tiles' edges (N * 32 rows against 128-row tiles: 1, 2,
# 5 and 37 leave a ragged tile), the serving chunk of 1,024 titles, and a
# case without biases; titles of L 16 at the parity matrix's widths and of
# odd L 7, 20 and 1, whose N * L rows are 1, 2 or 3 past a multiple of 4
_MSA_FWD_CASES = [(37, 300, 16, 25, 256, True, 32), (5, 24, 4, 8, 16, True, 32),
                  (1, 300, 16, 25, 256, True, 32), (2, 300, 16, 25, 256, True, 32),
                  (129, 300, 16, 25, 256, True, 32), (1024, 300, 16, 25, 256, True, 32),
                  (7, 300, 16, 25, 256, False, 32), (37, 100, 10, 20, 64, True, 16),
                  (4096, 100, 10, 20, 64, True, 16), (37, 300, 16, 25, 256, True, 7),
                  (38, 100, 10, 20, 64, True, 7), (39, 100, 10, 20, 64, False, 7),
                  (129, 24, 4, 8, 16, True, 20), (3, 24, 4, 8, 16, True, 1)]


@pytest.mark.parametrize("N,Din,heads,dk,A,bias,L", _MSA_FWD_CASES)
def test_msa_encoder_kernel(cuda, N, Din, heads, dk, A, bias, L):
    """Kernel A against the plain encoder (title 0 all pad), and the same
    bits on a second run."""
    args = _msa_args(cuda, N, Din, heads, dk, A, seed=N, L=L)
    if not bias:
        args = _no_bias(args)
    before = msa_encoder_pooled.launches
    out = msa_encoder_pooled(*args)
    assert msa_encoder_pooled.launches == before + 1
    _close(out, msa_encoder_pooled_plain(*args))
    assert torch.equal(out, msa_encoder_pooled(*args))


@pytest.mark.parametrize("Din,heads,dk,A,L,match", [
    (6, 1, 4, 16, 32, "multiples of 4"), (64, 1, 68, 16, 32, "dk <= 64"),
    (64, 2, 8, 516, 32, "multiple of 4 up to 512"), (64, 2, 8, 16, 33, "length 1 to 32")])
def test_msa_encoder_kernel_refuses_shapes(cuda, Din, heads, dk, A, L, match):
    """Kernel A raises a ValueError naming the limit for a shape it does not
    take, before any launch."""
    args = _msa_args(cuda, 2, Din, heads, dk, A, seed=6, L=L)
    before = msa_encoder_pooled.launches
    with pytest.raises(ValueError, match=match):
        msa_encoder_pooled(*args)
    assert msa_encoder_pooled.launches == before


def _gat_args(dev, B, G, D, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)
    adj = (torch.rand(B, G, G, generator=g) < 0.3) | torch.eye(G, dtype=torch.bool)
    adj[0, 1] = False  # no neighbour
    return (r(B, G, D, sc=0.5), adj.to(dev), r(B, D, sc=0.5), r(D, D, sc=D ** -0.5),
            r(D, sc=0.05), r(D, D, sc=D ** -0.5), r(D, D, sc=D ** -0.5), r(D, D, sc=D ** -0.5),
            r(D, sc=0.05), r(D, sc=D ** -0.5))


@pytest.mark.parametrize("B,G,D", [(9, 6, 32), (9, 26, 400), (70, 68, 400), (3, 33, 36),
                                   (1, 6, 400), (5, 96, 400), (7, 26, 398), (4, 68, 30),
                                   (3, 5, 7), (300, 68, 400)])
def test_gat_layer_kernel(cuda, B, G, D):
    """Kernel B against the plain layer (a row with no neighbour): graphs of
    5 to 96 nodes, B G not a multiple of 4, D not a multiple of 4 (padded
    with zeros), ragged row tiles; the same bits on a second run."""
    args = _gat_args(cuda, B, G, D, seed=G)
    before = interactive_gat_layer_fused.launches
    out = interactive_gat_layer_fused(*args)
    assert interactive_gat_layer_fused.launches == before + 1
    _close(out, interactive_gat_layer_plain(*args))
    assert torch.equal(out, interactive_gat_layer_fused(*args))


def test_gat_layer_kernel_on_an_unaligned_x(cuda):
    """x a contiguous view 4 bytes into its storage: the wrapper copies it
    into an aligned buffer for the projections, the attend step reads it
    with scalar loads."""
    args = list(_gat_args(cuda, 4, 26, 400, seed=3))
    args[0] = torch.cat([torch.zeros(1, device=cuda), args[0].reshape(-1)])[1:].view(4, 26, 400)
    assert args[0].data_ptr() % 16
    _close(interactive_gat_layer_fused(*args), interactive_gat_layer_plain(*args))


def test_wrappers_raise_on_bad_input(cuda):
    args = list(_msa_args(cuda, 4, 24, 4, 8, 16, seed=1))
    args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)  # not contiguous
    with pytest.raises(ValueError):
        msa_encoder_pooled(*args)
    gat = list(_gat_args(cuda, 3, 6, 32, seed=2))
    gat[1] = gat[1].float()
    with pytest.raises(TypeError):
        interactive_gat_layer_fused(*gat)


def test_scorer_card_matches_cpu(cuda):
    cfg = Config(dataset="synthetic", vocabulary_size=300, category_num=5, word_embedding_dim=24,
                 MSA_head_num=4, MSA_head_dim=8, attention_dim=16, max_history_num=7,
                 SAG_neighbors=3, SAG_hops=2, graph_depth=2)
    rng = np.random.default_rng(0)
    n, L, Gn, H, C = 70, 32, cfg.news_graph_size, 7, 5
    tables = SimpleNamespace(
        news_title_text=rng.integers(0, 300, (n, L)), news_title_mask=rng.random((n, L)) < 0.8,
        news_node_id=rng.integers(0, n, (n, Gn)),
        news_graph=(rng.random((n, Gn, Gn)) < 0.3) | np.eye(Gn, dtype=bool),
        news_graph_mask=np.concatenate([np.zeros((n, 1), bool), rng.random((n, Gn - 1)) < .9], 1))
    hist, cat = rng.integers(1, n, (12, H)), rng.integers(0, C, (12, H))
    cat[3, 2:] = C
    imp, cand = np.repeat(np.arange(12), 4), rng.integers(1, n, 48)
    scores = {}
    for dev in (cuda, "cpu"):
        model = Model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        scores[str(dev)] = CachedScorer(model, 16).score_items(tables, hist, cat, imp, cand)
    s_gpu, s_cpu = scores[str(cuda)], scores["cpu"]
    assert np.isfinite(s_gpu).all()
    assert np.abs(s_gpu - s_cpu).max() <= 1e-4 * max(1.0, float(np.abs(s_cpu).max()))
    assert not math.isnan(float(s_gpu.sum()))


# ---------------------------------------------------------------------------
# Training kernels: A'' (dropout mask), A with dropout, A' (backward), C, D
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,cols,offset", [(37, 9600, 0), (5, 13, 3), (1000, 400, 70_000),
                                               (320 * 26, 26, 0)])
def test_keep_mask_kernel_is_bit_exact(cuda, rows, cols, offset):
    before = DR.keep_mask.launches
    got = DR.keep_mask(rows, cols, 0.2, 1234, 5, row_offset=offset, device=cuda)
    assert DR.keep_mask.launches == before + 1
    torch.cuda.synchronize()
    want = DR.keep_mask_plain(rows, cols, 0.2, 1234, 5, row_offset=offset, device=cuda)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,rate,view", [
    ((320 * 26, 400), 0.1, False), ((320, 68, 68), 0.2, False), ((5, 13), 0.3, False),
    ((320, 18, 400), 0.1, True), ((7, 3, 6), 0.2, True), ((1, 1), 0.5, False)])
def test_fused_dropout_kernel_is_bit_exact(cuda, shape, rate, view):
    """Kernel A'' as the training path's dropout: forward, and forward with
    backward, the same bits as `dropout_plain` on the card; one launch
    forward and one backward; an expanded view (the topic nodes) summed back
    into its parameter."""
    g = torch.Generator(device=cuda).manual_seed(len(shape))
    leaf = torch.randn(shape[1:] if view else shape, generator=g, device=cuda)
    as_x = (lambda t: t[None].expand(*shape)) if view else (lambda t: t)
    up = torch.randn(shape, generator=g, device=cuda)
    before = DR.dropout.launches
    got = DR.dropout(as_x(leaf), rate, 77, 3)
    assert DR.dropout.launches == before + 1
    assert torch.equal(got, DR.dropout_plain(as_x(leaf), rate, 77, 3))
    grads = []
    for fn in (DR.dropout, DR.dropout_plain):
        lg = leaf.clone().requires_grad_(True)
        (dx,) = torch.autograd.grad(fn(as_x(lg), rate, 77, 3), lg, up)
        grads.append(dx)
    assert DR.dropout.launches == before + 3
    assert torch.equal(*grads)


@pytest.mark.parametrize("N,Din,heads,dk,A,bias,L", _MSA_FWD_CASES)
def test_msa_encoder_dropout_kernel(cuda, N, Din, heads, dk, A, bias, L):
    """Kernel A at rate 0.2 equals the plain encoder on keep * x / (1 - p),
    and gives the same bits twice for one seed."""
    args = _msa_args(cuda, N, Din, heads, dk, A, seed=N + 1, L=L)
    if not bias:
        args = _no_bias(args)
    out = ME.msa_encoder_pooled(*args, dropout_rate=0.2, seed=77, site=3)
    again = ME.msa_encoder_pooled(*args, dropout_rate=0.2, seed=77, site=3)
    xd = ME.drop_titles_plain(args[0], 0.2, 77, 3)
    _close(out, msa_encoder_pooled_plain(xd, *args[1:]))
    assert torch.equal(out, again)


@pytest.mark.parametrize("N,Din,heads,dk,A,rate,bias,L", [
    (37, 300, 16, 25, 256, 0.2, True, 32), (37, 300, 16, 25, 256, 0.0, True, 32),
    (5, 24, 4, 8, 16, 0.2, True, 32), (1, 300, 16, 25, 256, 0.2, True, 32),
    (2, 300, 16, 25, 256, 0.2, True, 32), (129, 300, 16, 25, 256, 0.2, True, 32),
    (7, 300, 16, 25, 256, 0.0, False, 32), (3, 64, 2, 64, 512, 0.2, True, 32),
    (37, 100, 10, 20, 64, 0.2, True, 16), (300, 100, 10, 20, 64, 0.0, True, 16),
    (37, 300, 16, 25, 256, 0.2, True, 7), (38, 100, 10, 20, 64, 0.2, True, 7),
    (39, 100, 10, 20, 64, 0.0, False, 7), (700, 24, 4, 8, 16, 0.2, True, 7),
    (129, 24, 4, 8, 16, 0.2, True, 20), (3, 24, 4, 8, 16, 0.2, True, 1)])
def test_msa_encoder_bwd_kernel(cuda, N, Din, heads, dk, A, rate, bias, L):
    """Kernel A' (dx and the eight weight and bias gradients) against
    autograd of the plain encoder, mask applied; title 0 is all pad. N runs
    over the product tiles' edges (N * 32 rows against 128-row tiles: 1, 2,
    37 and 7 leave a ragged tile, 129 one row of titles past 4,096 rows);
    one case has no biases and no dropout. Titles of L 16, 7, 20 and 1: N * L
    rows 1, 2 and 3 past a multiple of 4 (the weight gradients sum over
    them as their K), 700 titles of 7 rows past the 4,096-row slices. Every
    output is the same bits on a second run."""
    args = list(_msa_args(cuda, N, Din, heads, dk, A, seed=N + 2, L=L))
    if not bias:
        for i in (3, 6, 8):  # bq, bv, b1
            args[i] = torch.zeros_like(args[i])
    g = torch.Generator().manual_seed(3)
    dp = torch.randn(N, heads * dk, generator=g).to(cuda)
    before = ME.msa_encoder_bwd.launches
    got = ME.msa_encoder_bwd(*args[:10], dp, heads, rate, 99, 0)
    assert ME.msa_encoder_bwd.launches == before + 1
    want = ME.msa_encoder_bwd_plain(*args[:10], dp, heads, rate, 99, 0)
    for a, b in zip(got, want):
        _close(a, b)
    again = ME.msa_encoder_bwd(*args[:10], dp, heads, rate, 99, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("Din,heads,dk,A,L,match", [
    (6, 1, 4, 16, 32, "multiples of 4"), (64, 1, 68, 16, 32, "dk <= 64"),
    (64, 2, 8, 18, 32, "multiple of 4 up to 512"),
    (64, 2, 8, 516, 32, "multiple of 4 up to 512"), (600, 1, 64, 16, 32, "shared memory"),
    (64, 2, 8, 16, 33, "length 1 to 32")])
def test_msa_encoder_bwd_kernel_refuses_shapes(cuda, Din, heads, dk, A, L, match):
    """Kernel A' raises a ValueError naming the limit for a shape it does not
    take, before any launch."""
    args = _msa_args(cuda, 2, Din, heads, dk, A, seed=5, L=L)
    dp = torch.zeros(2, heads * dk, device=cuda)
    before = ME.msa_encoder_bwd.launches
    with pytest.raises(ValueError, match=match):
        ME.msa_encoder_bwd(*args[:10], dp, heads, 0.2, 99, 0)
    assert ME.msa_encoder_bwd.launches == before


def test_msa_encoder_on_card_carries_gradients(cuda):
    """Under grad mode the kernel's output has a graph whose backward is
    kernel A'."""
    args = [t.requires_grad_(True) if isinstance(t, torch.Tensor) and t.is_floating_point()
            else t for t in _msa_args(cuda, 6, 24, 4, 8, 16, seed=8)]
    out = ME.msa_encoder_pooled(*args, dropout_rate=0.2, seed=5)
    assert out.grad_fn is not None
    before = ME.msa_encoder_bwd.launches
    out.sum().backward()
    assert ME.msa_encoder_bwd.launches == before + 1
    assert all(t.grad is not None for t in args if isinstance(t, torch.Tensor)
               and t.requires_grad)


def test_gat_layer_kernel_refuses_gradients(cuda):
    gat = list(_gat_args(cuda, 3, 6, 32, seed=4))
    gat[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="eval layer"):
        interactive_gat_layer_fused(*gat)
    with torch.no_grad():
        interactive_gat_layer_fused(*gat)


@pytest.mark.parametrize("B,G,D,strided,zero_g", [
    (9, 6, 32, False, False), (11, 26, 400, True, False), (7, 68, 400, True, False),
    (3, 33, 36, False, False), (320, 68, 400, True, False), (320, 26, 400, True, False),
    (5, 3, 400, True, False), (13, 6, 400, False, False), (6, 96, 400, True, False),
    (4, 68, 400, True, True)])
def test_gat_scores_kernel(cuda, B, G, D, strided, zero_g):
    """Kernel C forward and backward against their plain versions: graphs
    of one, two and three backward tiles (G 96 above the 72-node cap of the
    kernel this replaced), k1 and k2 strided as C' reads them, a zero score
    gradient; every output the same bits on a second run."""
    g = torch.Generator().manual_seed(G)
    r = lambda *s: (torch.randn(*s, generator=g) * 0.5).to(cuda)
    if strided:  # k1, k2 as column blocks of the fused projection y
        y = r(B, G, 3 * D)
        k1, k2 = y[..., D:2 * D], y[..., 2 * D:]
    else:
        k1, k2 = r(B, G, D), r(B, G, D)
    k3, a, gout = r(B, D), r(D), r(B, G, G)
    if zero_g:
        gout = torch.zeros_like(gout)
    before = (GS.gat_scores_fwd.launches, GS.gat_scores_bwd.launches)
    s = GS.gat_scores_fwd(k1, k2, k3, a)
    _close(s, GS.interactive_gat_scores_plain(k1, k2, k3, a))
    got = GS.gat_scores_bwd(k1, k2, k3, a, gout)
    assert (GS.gat_scores_fwd.launches, GS.gat_scores_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    want = GS.interactive_gat_scores_bwd_plain(k1, k2, k3, a, gout)
    for x, w in zip(got, want):
        _close(x, w)
        if zero_g:
            assert not x.any()
    assert torch.equal(s, GS.gat_scores_fwd(k1, k2, k3, a))
    assert all(torch.equal(x, w) for x, w in zip(got, GS.gat_scores_bwd(k1, k2, k3, a, gout)))


@pytest.mark.parametrize("V,ntok,D,skew", [(40_000, 50_000, 300, "uniform"),
                                            (120, 400, 20, "zipf"), (50, 35, 36, "uniform"),
                                            (40_000, 286_720, 300, "pad"),
                                            (1_003, 70_000, 20, "long pad"),
                                            (40_001, 50_000, 300, "uniform"),
                                            (37, 0, 4, "uniform"), (37, 1, 4, "uniform"),
                                            (600, 9_000, 512, "zipf")])
def test_emb_grad_kernel(cuda, V, ntok, D, skew):
    """Uniform tokens; Zipf-like ones; the training shape with 60 % of the
    slots on token 0, as the pad positions of real titles are; a pad run
    over more than 1,000 chunks of the sorted stream; an odd V; no token and
    one token; the widest D."""
    rng = np.random.default_rng(V)
    tok = {"uniform": lambda: rng.integers(0, V, ntok),
           "zipf": lambda: np.minimum(rng.zipf(1.3, ntok) - 1, V - 1),
           "pad": lambda: np.where(rng.random(ntok) < 0.6, 0, rng.integers(0, V, ntok)),
           "long pad": lambda: np.where(rng.random(ntok) < 0.97, 0,
                                        rng.integers(0, V, ntok))}[skew]()
    tok = torch.from_numpy(tok).to(cuda)
    gr = torch.from_numpy(rng.standard_normal((ntok, D)).astype(np.float32)).to(cuda)
    before = EG.embedding_grad.launches
    got = EG.embedding_grad(tok, gr, V)
    assert EG.embedding_grad.launches == before + 1
    _close(got, EG.embedding_grad_plain(tok, gr, V))
    assert torch.equal(got, EG.embedding_grad(tok, gr, V))


# ---------------------------------------------------------------------------
# The NRMS slice: the masked attention pair (E and F) and an NRMS-SA step
# ---------------------------------------------------------------------------
def _attention_args(dev, N, L, heads, dk, hs, seed, mask_kind="masked", offset=0):
    """q, k, v, do [N, L, heads * hs] (pad lanes zero where hs > dk), each a
    view `offset` floats into its storage, and a key mask with sequence 0
    all masked."""
    g = torch.Generator().manual_seed(seed)
    t = []
    for _ in range(4):
        x = torch.nn.functional.pad(torch.randn(N, L, heads, dk, generator=g), (0, hs - dk))
        buf = torch.zeros(offset + x.numel(), device=dev)
        buf[offset:] = x.reshape(-1).to(dev)
        t.append(buf[offset:].view(N, L, heads * hs))
    mask = None
    if mask_kind == "masked":
        mask = torch.rand(N, L, generator=g) < 0.7
        mask[:, 0] = True
        mask[0] = False
        mask = mask.to(dev)
    return t, mask


# (N, L, heads, dk, hs, mask_kind, offset): packed (hs == dk, F's layout) and
# head-padded (hs > dk, E's) at every edge of the 32-row and 32-key tiles;
# float4 loads where hs is a multiple of 4 and the views are aligned, scalar
# ones at dk 6 and 7 and on a view 1 float into its storage; the widest head
# (64) and one past it, which raises
_PAIR_CASES = [
    (37, 32, 20, 20, 20, "masked", 0), (9, 50, 20, 20, 20, "masked", 0),
    (7, 150, 20, 20, 20, "none", 0), (7, 150, 20, 20, 20, "masked", 0),
    (11, 32, 20, 20, 32, "masked", 0), (9, 50, 20, 20, 64, "masked", 0),
    (5, 12, 4, 6, 6, "none", 0), (6, 33, 3, 7, 7, "masked", 0), (4, 300, 20, 20, 20, "masked", 0),
] + [(5, L, heads, dk, hs, "masked", 0) for L in (1, 31, 32, 33, 50, 64, 65, 150, 300)
     for heads, dk, hs in ((20, 20, 20), (20, 20, 32), (6, 20, 64), (3, 6, 6), (3, 7, 7))] + [
    (6, 40, 2, 64, 64, "masked", 0), (3, 33, 2, 65, 65, "masked", 0),
    (5, 50, 20, 20, 20, "masked", 1), (5, 65, 4, 20, 32, "masked", 1),
]


@pytest.mark.parametrize("N,L,heads,dk,hs,mask_kind,offset", _PAIR_CASES)
def test_msa_attention_kernel_pair(cuda, N, L, heads, dk, hs, mask_kind, offset):
    """Forward and backward against the plain version, packed (hs == dk,
    F's layout) and head-padded (hs > dk, E's), with an all-masked sequence
    (its dq and dk rows zero); the pad lanes of every result are zero; the
    same backward bits twice."""
    (q, k, v, do), mask = _attention_args(cuda, N, L, heads, dk, hs, seed=L + hs,
                                          mask_kind=mask_kind, offset=offset)
    if dk > MA.WIDTHS[-1]:
        with pytest.raises(ValueError, match=f"widest the kernels take \\({MA.WIDTHS[-1]}\\)"):
            MA.attention_fwd(q, k, v, mask, heads, dk)
        with pytest.raises(ValueError, match="widest"):
            MA.attention_bwd(q, k, v, mask, do, heads, dk)
        return
    rs = heads * hs
    vector = offset == 0 and hs % 4 == 0
    assert MA.launch_plan([t.data_ptr() for t in (q, k, v, do)], rs, hs, dk) == (
        MA.head_width(dk), vector)
    before = (MA.attention_fwd.launches, MA.attention_bwd.launches)
    out = MA.attention_fwd(q, k, v, mask, heads, dk)
    grads = MA.attention_bwd(q, k, v, mask, do, heads, dk)
    assert (MA.attention_fwd.launches, MA.attention_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    _close(out, MA.attention_plain_strided(q, k, v, heads, dk, mask))
    for got, want in zip(grads, MA.attention_bwd_plain(q, k, v, mask, do, heads, dk)):
        _close(got, want)
    for t in (out, *grads):
        assert not t.reshape(N, L, heads, hs)[..., dk:].any()
    if mask is not None:
        assert not grads[0][0].any() and not grads[1][0].any()
    again = MA.attention_bwd(q, k, v, mask, do, heads, dk)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_msa_attention_entry_points_on_card(cuda):
    """`msa_attention` and `msa_attention_grouped` run the pair through
    autograd; the caps hold L 300 at dk 20 and the backward runs at its
    cap; a sequence beyond the cap raises."""
    (q, k, v, do), mask = _attention_args(cuda, 8, 32, 20, 20, 20, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = MA.attention_bwd.launches
    MA.msa_attention(*leaves, 20, mask).backward(do)
    assert MA.attention_bwd.launches == before + 1
    for leaf, want in zip(leaves, MA.attention_bwd_plain(q, k, v, mask, do, 20, 20)):
        _close(leaf.grad, want)
    (qp, kp, vp, dop), _ = _attention_args(cuda, 8, 32, 20, 20, 32, seed=2)
    _close(MG.msa_attention_grouped(qp, kp, vp, 20, 20, mask),
           MA.attention_plain_strided(qp, kp, vp, 20, 20, mask))
    assert 314 <= MA.max_length(20) < 894 <= MA.max_length(20, backward=False)
    (q, k, v, do), _ = _attention_args(cuda, 1, MA.max_length(20), 20, 20, 20, seed=3)
    for got, want in zip(MA.attention_bwd(q, k, v, None, do, 20, 20),
                         MA.attention_bwd_plain(q, k, v, None, do, 20, 20)):
        _close(got, want)
    long = torch.zeros(1, MA.max_length(20) + 1, 400, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        MA.attention_bwd(long, long, long, None, long, 20, 20)


def test_nrms_sa_step_card_matches_cpu(cuda):
    """One NRMS-SA training step (dropout 0.2) on the card and on the CPU
    from the same weights, batch and seed: 4 forward and 4 backward
    attention launches, 7 dropouts forward and backward (14 launches of
    kernel A''), the same loss and gradients
    within the training limit (1e-3 of each tensor's max |cpu|)."""
    cfg = Config(dataset="synthetic", model_family="nrms", vocabulary_size=300,
                 category_num=4, word_embedding_dim=24, nrms_head_num=4, nrms_head_dim=6,
                 nrms_attention_dim=16, max_title_length=12, max_history_num=10,
                 augmented_news_num=3, dropout_rate=0.2)
    rng = np.random.default_rng(0)
    n, L = 60, 12
    arrays = SimpleNamespace(news_title_text=rng.integers(1, 300, (n, L)),
                             news_title_mask=np.arange(L)[None] < rng.integers(0, L + 1, (n, 1)),
                             augmented_news=rng.integers(0, n, (n, 3)))
    hist = rng.integers(0, n, (8, 10))
    hist[0] = 0
    batch = TrainBatch(history_idx=torch.from_numpy(hist), cat_idx=torch.zeros(8, 10).long(),
                       sample_idx=torch.from_numpy(rng.integers(1, n, (8, 5))),
                       weight=torch.ones(8))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = NRMSModel(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        counts = (MA.attention_fwd.launches, MA.attention_bwd.launches, DR.dropout.launches)
        loss = model.loss(NRMSTables.from_arrays(arrays, dev),
                          TrainBatch(*(t.to(dev) for t in batch)), seed=11)
        loss.backward()
        if dev.type == "cuda":
            assert (MA.attention_fwd.launches - counts[0], MA.attention_bwd.launches - counts[1],
                    DR.dropout.launches - counts[2]) == (4, 4, 14)
        out[dev.type] = (float(loss.detach()),
                         {k: p.grad.cpu() for k, p in model.named_parameters()})
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-3 * max(1.0, abs(l_cpu))
    for name, g in g_cpu.items():
        assert float((g_gpu[name] - g).abs().max()) <= 1e-3 * float(g.abs().max()), name
