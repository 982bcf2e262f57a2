"""The bf16 instances of kernels A, A', B (bf16 weights, and bf16
activations), C's forward, A'' and the attention pair against their plain
versions on the card (`compute_dtype` bfloat16), C's backward at the ReLU
kink, and bf16 models card against CPU (MSA-DIGAT, CNN-DIGAT, NRMS-SA).

Needs a CUDA device and nvcc; every test here is marked `cuda` and skips
without a card. Run as `tests/test_torch_cuda.py`:

    python -m pytest tests/test_torch_cuda_bf16.py -q --noconftest -p no:cacheprovider

Tolerances: fp32 outputs max |kernel - plain| <= 1e-4 * max(1, max |plain|);
a bf16 output (A''s dx, the pair's, B's with bf16 activations, C's scores)
within one bf16 ulp of each plain element plus that bound (both round fp32
sums that differ in their order); A'' bf16 bit for bit."""

import numpy as np
import pytest
import torch

from digat_tpu_torch.config import Config
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.eval.scorer import CachedScorer
from digat_tpu_torch.models.model import CorpusTables, Model
from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables
from digat_tpu_torch.ops import dropout as DR
from digat_tpu_torch.ops import gat_layer as GL
from digat_tpu_torch.ops import gat_scores as GS
from digat_tpu_torch.ops import msa_attention as MA
from digat_tpu_torch.ops import msa_encoder as ME
from digat_tpu_torch.train.optimizer import Adam
from digat_tpu_torch.train.train_step import train_step
from tests.test_torch_cuda import _close, _gat_args, _msa_args, cuda  # noqa: F401

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16


def _ulp(t):
    a = t.float().abs().clamp(min=2.0 ** -126)
    _, e = torch.frexp(a)
    return torch.ldexp(torch.ones_like(a), e - 8)


def _bf16_args(args):
    """x and every weight of the encoder's arguments in bf16 (the compute
    copy), the mask and heads as they are."""
    return tuple(t.to(BF16) if isinstance(t, torch.Tensor) and t.is_floating_point() else t
                 for t in args)


_CASES = [(37, 300, 16, 25, 256, 32), (1024, 300, 16, 25, 256, 32), (5, 24, 4, 8, 16, 32),
          (37, 100, 10, 20, 64, 16), (37, 300, 16, 25, 256, 7), (5, 300, 16, 25, 256, 33),
          (3, 300, 16, 25, 256, 128), (6, 64, 2, 80, 32, 32)]


# A's bf16 instance also at one, two and 129 titles, L 7 to 128, Din a
# multiple of 8 (x read in place by the TMA) and not (x copied to 16-byte
# rows where there is no dropout), heads of dk 30 and 32 in groups of four
# with a partial last group, dk 64 (the attention stage's wide instance),
# 63 (a head row past 16 float4s at its shift: the long unit) and 128 (the
# long unit, h's planes by a split pass)
_FWD_CASES = _CASES + [(1, 300, 16, 25, 256, 32), (2, 300, 16, 25, 256, 20),
                       (129, 300, 16, 25, 256, 16), (9, 304, 16, 25, 256, 32),
                       (7, 300, 16, 25, 256, 48), (5, 300, 6, 30, 64, 20),
                       (3, 64, 2, 32, 32, 32), (11, 256, 4, 64, 128, 32),
                       (3, 64, 4, 63, 64, 20), (4, 256, 2, 128, 128, 32)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("N,Din,heads,dk,A,L", _FWD_CASES)
def test_msa_encoder_bf16_kernel(cuda, N, Din, heads, dk, A, L, rate):
    """A's bf16 instance (its own counter; the fp32 one not launched)
    against the plain version on the same bf16 inputs; fp32 out; the same
    bits twice."""
    args = _bf16_args(_msa_args(cuda, N, Din, heads, dk, A, seed=N + L, L=L))
    before = (ME.msa_encoder_pooled.launches, ME.msa_encoder_pooled.launches_bf16)
    out = ME.msa_encoder_pooled(*args, dropout_rate=rate, seed=7, site=2)
    assert (ME.msa_encoder_pooled.launches, ME.msa_encoder_pooled.launches_bf16) == \
        (before[0], before[1] + 1)
    assert out.dtype == torch.float32
    _close(out, ME.msa_encoder_pooled_plain(*args, dropout_rate=rate, seed=7, site=2))
    assert torch.equal(out, ME.msa_encoder_pooled(*args, dropout_rate=rate, seed=7, site=2))


# A''s bf16 instance also at the edges of its wgmma products' tiles (128
# rows, 128 or 152 columns, 64-deep k-tiles): M = N L not a multiple of 128
# (N 37 at L 32 above; N 29 at L 33), K 300 and 1,200 (D 300 and Din
# 1,200: u's and dx's K against the k-tile, dO's N 300), one title, dk 128
_BWD_CASES = _CASES + [(29, 300, 16, 25, 256, 33), (9, 1200, 12, 25, 256, 32),
                       (1, 300, 16, 25, 256, 32), (3, 300, 4, 128, 256, 32)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("N,Din,heads,dk,A,L", _BWD_CASES)
def test_msa_encoder_bwd_bf16_kernel(cuda, N, Din, heads, dk, A, L, rate):
    """A''s bf16 instance: dx bf16 within one ulp of the plain dx plus the
    fp32 bound, the eight weight and bias gradients fp32 within it; the same
    bits twice."""
    args = _bf16_args(_msa_args(cuda, N, Din, heads, dk, A, seed=N + L + 1, L=L))
    dp = torch.randn(N, heads * dk, generator=torch.Generator().manual_seed(4)).to(cuda)
    before = (ME.msa_encoder_bwd.launches, ME.msa_encoder_bwd.launches_bf16)
    got = ME.msa_encoder_bwd(*args[:10], dp, heads, rate, 99, 0)
    assert (ME.msa_encoder_bwd.launches, ME.msa_encoder_bwd.launches_bf16) == \
        (before[0], before[1] + 1)
    want = ME.msa_encoder_bwd_plain(*args[:10], dp, heads, rate, 99, 0)
    torch.cuda.synchronize()
    assert got[0].dtype == BF16 and all(g.dtype == torch.float32 for g in got[1:])
    dx, ref = got[0].float(), want[0].float()
    bound = _ulp(ref) + 1e-4 * max(1.0, float(ref.abs().max()))
    assert ((dx - ref).abs() <= bound).all(), float((dx - ref).abs().max())
    for a, b in zip(got[1:], want[1:]):
        _close(a, b)
    again = ME.msa_encoder_bwd(*args[:10], dp, heads, rate, 99, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# B's bf16-weight instance (x's planes, the wgmma projections, the fused
# step on fp32 x): the serving graphs, D 398, 30 and 7 (padded to 400, 32
# and 8), graphs of 5 and 6 nodes (R 2), G 96 and 100 (two column tiles),
# B not a multiple of any tile; x at an offset of one element (its planes
# from a padded copy, the fused kernel's element path)
@pytest.mark.parametrize("B,G,D,offset", [
    (9, 26, 400, 0), (70, 68, 400, 0), (7, 26, 398, 0), (3, 5, 7, 0), (1024, 68, 400, 0),
    (9, 6, 32, 0), (4, 68, 30, 0), (5, 96, 400, 0), (3, 100, 64, 0), (9, 26, 400, 1),
    (7, 6, 30, 1)])
def test_gat_layer_bf16_weights_kernel(cuda, B, G, D, offset):
    """B with fp32 x and query and bf16 weights (its own counter) against
    the plain layer, which forms every product in fp32 from the bf16 values
    (a row with no neighbour: uniform); the same bits twice."""
    args = list(_gat_args(cuda, B, G, D, seed=G + 1))
    args[3:] = [t.to(BF16) for t in args[3:]]
    if offset:  # x a contiguous view `offset` elements past an aligned start
        buf = torch.empty(B * G * D + offset, device=cuda)
        buf[offset:] = args[0].flatten()
        args[0] = buf[offset:].view(B, G, D)
        assert args[0].data_ptr() % 16
    fused = GL.interactive_gat_layer_fused
    before = (fused.launches, fused.launches_bf16, fused.launches_bf16_act)
    out = fused(*args)
    assert (fused.launches, fused.launches_bf16, fused.launches_bf16_act) == \
        (before[0], before[1] + 1, before[2])
    assert out.dtype == torch.float32
    _close(out, GL.interactive_gat_layer_plain(*args))
    assert torch.equal(out, fused(*args))


def test_bf16_instances_refuse_mixed_inputs(cuda):
    """A bf16 x with fp32 weights, or a bf16 x into B, raises: a CUDA bf16
    tensor never reaches an fp32 kernel."""
    args = list(_bf16_args(_msa_args(cuda, 4, 24, 4, 8, 16, seed=1)))
    args[2] = args[2].float()
    with pytest.raises(ValueError):
        ME.msa_encoder_pooled(*args)
    gat = list(_gat_args(cuda, 3, 6, 32, seed=2))
    gat[0] = gat[0].to(BF16)
    with pytest.raises(TypeError):
        GL.interactive_gat_layer_fused(*gat)


def _small_cfg(**over):
    return Config(dataset="synthetic", vocabulary_size=300, category_num=5,
                  word_embedding_dim=24, MSA_head_num=4, MSA_head_dim=8, attention_dim=16,
                  max_history_num=7, SAG_neighbors=3, SAG_hops=2, graph_depth=2,
                  compute_dtype="bfloat16", **over)


def _tables(cfg, n, rng):
    from types import SimpleNamespace
    L, Gn = cfg.max_title_length, cfg.news_graph_size
    return SimpleNamespace(
        news_title_text=rng.integers(0, 300, (n, L)), news_title_mask=rng.random((n, L)) < 0.8,
        news_node_id=rng.integers(0, n, (n, Gn)),
        news_graph=(rng.random((n, Gn, Gn)) < 0.3) | np.eye(Gn, dtype=bool),
        news_graph_mask=np.concatenate([np.zeros((n, 1), bool), rng.random((n, Gn - 1)) < .9],
                                       1))


def test_bf16_scorer_card_matches_cpu(cuda):
    """The cached scorer at bf16: stage 1 launches A's bf16 instance, stage 2
    B's, and the scores match the CPU's."""
    cfg = _small_cfg()
    rng = np.random.default_rng(0)
    tables = _tables(cfg, 70, rng)
    hist, cat = rng.integers(1, 70, (12, 7)), rng.integers(0, 5, (12, 7))
    imp, cand = np.repeat(np.arange(12), 4), rng.integers(1, 70, 48)
    scores = {}
    for dev in (cuda, "cpu"):
        model = Model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        a, b = ME.msa_encoder_pooled.launches_bf16, GL.interactive_gat_layer_fused.launches_bf16
        scores[str(dev)] = CachedScorer(model, 16).score_items(tables, hist, cat, imp, cand)
        if dev != "cpu":
            assert ME.msa_encoder_pooled.launches_bf16 - a == 5  # 70 news in chunks of 16
            assert GL.interactive_gat_layer_fused.launches_bf16 - b == 3 * 2 * 2
    s_gpu, s_cpu = scores[str(cuda)], scores["cpu"]
    assert np.isfinite(s_gpu).all()
    assert np.abs(s_gpu - s_cpu).max() <= 1e-4 * max(1.0, float(np.abs(s_cpu).max()))


def test_bf16_train_step_card_matches_cpu(cuda):
    """One bf16 training step (dedup, dropout 0.2) on the card and the CPU
    from the same weights and seed: A's and A''s bf16 instances launched
    once each, the loss within 1e-3, every gradient fp32 and within
    max(1e-3 * max |cpu|, one bf16 ulp of the element; of the tensor's
    largest element for the contexts' weights, as chip_smoke.py holds
    them)."""
    cfg = _small_cfg(dropout_rate=0.2)
    rng = np.random.default_rng(1)
    tables = _tables(cfg, 60, rng)
    hist, cat = rng.integers(1, 60, (20, 7)), rng.integers(0, 5, (20, 7))
    neg = sampling.sample_negatives(rng.integers(1, 60, 200), np.arange(0, 201, 5), 4,
                                    np.random.default_rng(2))
    batch = next(batching.train_batches(hist, cat, rng.integers(0, 20, 40),
                                        rng.integers(1, 60, 40).astype(np.int32), neg, 8,
                                        epoch_seed=0, news_node_id=tables.news_node_id,
                                        dedup_titles=512))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = Model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        opt = Adam(model.named_parameters(), 0.0, 1.0)
        counts = (ME.msa_encoder_pooled.launches_bf16, ME.msa_encoder_bwd.launches_bf16)
        loss = train_step(model, opt, CorpusTables.from_arrays(tables, dev),
                          batching.to_device(batch, dev), 5, 0.0)
        if dev.type == "cuda":
            assert (ME.msa_encoder_pooled.launches_bf16 - counts[0],
                    ME.msa_encoder_bwd.launches_bf16 - counts[1]) == (1, 1)
        out[dev.type] = (float(loss), {k: p.grad.cpu() for k, p in model.named_parameters()})
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-3 * max(1.0, abs(l_cpu))
    for name, g in g_cpu.items():
        assert g_gpu[name].dtype == torch.float32
        # a context weight, used at every depth, sums its uses' bf16
        # gradients in bf16: one ulp of the tensor's largest element there
        ulp = _ulp(g.abs().max() if ".candidate_attention." in f".{name}" or any(
            k in name for k in ("news_graph_W", "user_news_", "featureAffine",
                                "userAttention")) else g)
        limit = torch.maximum(ulp, torch.full_like(g, 1e-3 * float(g.abs().max())))
        assert ((g_gpu[name] - g).abs() <= limit).all(), name


def _close_bf16(out, ref):
    """out (bf16) within one bf16 ulp of each element of ref plus 1e-4 *
    max(1, max |ref|)."""
    torch.cuda.synchronize()
    assert out.dtype == BF16 and torch.isfinite(out.float()).all()
    d = ((out.double() - ref.double()).abs() - _ulp(ref).double()).clamp(min=0)
    assert float(d.max()) <= 1e-4 * max(1.0, float(ref.double().abs().max())), float(d.max())


# (N, L, heads, hs, dk): the NRMS title and user shapes, L 160, an odd L and
# odd head widths (element copies), the E layout (hs > dk), the wide instance
# (dk 65-128; at L <= 16, in the E layout, past the simple wide kernel's L 185);
# dk 25 at L 33 (groups of 8 heads, 400 bytes, in the long backward), three
# heads of 25 (no group of 8 divides them) and odd head counts at dk 20
# (element copies), the E layout at dkp 32 and 64 (16-byte copies of one
# head), dk 64 and dk 48 (the widest tiles)
_PAIR = [(37, 32, 20, 20, 20), (9, 50, 20, 20, 20), (5, 160, 16, 25, 25), (7, 13, 3, 7, 7),
         (6, 12, 4, 8, 6), (4, 33, 2, 80, 80), (3, 64, 2, 128, 128), (2, 150, 4, 25, 25),
         (2, 186, 1, 128, 128), (2, 300, 2, 128, 128), (5, 12, 2, 100, 100),
         (3, 40, 2, 128, 100), (4, 33, 16, 25, 25), (5, 40, 3, 25, 25), (3, 32, 3, 25, 25),
         (6, 32, 5, 20, 20), (4, 50, 7, 20, 20), (6, 32, 20, 32, 20), (4, 50, 20, 64, 20),
         (5, 17, 2, 64, 64), (3, 70, 3, 48, 40)]


@pytest.mark.parametrize("N,L,heads,hs,dk", _PAIR)
def test_attention_pair_bf16_kernel(cuda, N, L, heads, hs, dk):
    """The pair's bf16 instance, forward and backward (bf16 q, k, v, do and
    outputs, its own counters; the fp32 instance not launched), against the
    plain version, with an all-masked sequence; pad lanes zero; the same
    bits twice."""
    g = torch.Generator().manual_seed(N + L + hs)
    pad = lambda t: torch.nn.functional.pad(t, (0, hs - dk))
    q, k, v, do = (pad(torch.randn(N, L, heads, dk, generator=g)).reshape(N, L, heads * hs)
                   .to(BF16).to(cuda) for _ in range(4))
    mask = torch.rand(N, L, generator=g) < 0.7
    mask[:, 0] = True
    mask[0] = False
    mask = mask.to(cuda)
    wide = "_wide" if MA.head_width(dk) == MA.WIDE else ""
    counts = lambda: (MA.attention_fwd.launches, MA.attention_bwd.launches,
                      MA.attention_fwd.launches_wide, MA.attention_bwd.launches_wide,
                      getattr(MA.attention_fwd, f"launches{wide}_bf16"),
                      getattr(MA.attention_bwd, f"launches{wide}_bf16"))
    before = counts()
    out = MA.attention_fwd(q, k, v, mask, heads, dk)
    grads = MA.attention_bwd(q, k, v, mask, do, heads, dk)
    assert counts() == (*before[:4], before[4] + 1, before[5] + 1)
    _close_bf16(out, MA.attention_plain_strided(q, k, v, heads, dk, mask))
    for got, want in zip(grads, MA.attention_bwd_plain(q, k, v, mask, do, heads, dk)):
        _close_bf16(got, want)
    for t in (out, *grads):
        assert not t.reshape(N, L, heads, hs)[..., dk:].any()
    assert torch.equal(out, MA.attention_fwd(q, k, v, mask, heads, dk))
    assert all(torch.equal(a, b) for a, b in zip(grads, MA.attention_bwd(q, k, v, mask, do,
                                                                          heads, dk)))


@pytest.mark.parametrize("L", [32, 50])
def test_attention_pair_bf16_misaligned_rows(cuda, L):
    """q, k, v and do one element past a 16-byte boundary (contiguous views
    of a larger buffer): the bf16 register-row instance takes element copies
    (`launch_plan`) and gives the aligned inputs' bits."""
    N, heads, dk = 9, 20, 20
    g = torch.Generator().manual_seed(L)
    views, plain = [], []
    for _ in range(4):
        x = torch.randn(N, L, heads * dk, generator=g).to(BF16).to(cuda)
        buf = torch.empty(x.numel() + 1, dtype=BF16, device=cuda)
        buf[1:] = x.reshape(-1)
        views.append(buf[1:].view(N, L, heads * dk))
        plain.append(x)
    mask = torch.rand(N, L, generator=g) < 0.7
    mask[:, 0] = True
    mask[0] = False
    mask = mask.to(cuda)
    q, k, v, do = views
    assert MA.launch_plan([t.data_ptr() for t in views], heads * dk, dk, dk, 2) == (32, False)
    assert MA.launch_plan([t.data_ptr() for t in plain], heads * dk, dk, dk, 2) == (32, True)
    out = MA.attention_fwd(q, k, v, mask, heads, dk)
    grads = MA.attention_bwd(q, k, v, mask, do, heads, dk)
    _close_bf16(out, MA.attention_plain_strided(q, k, v, heads, dk, mask))
    for got, want in zip(grads, MA.attention_bwd_plain(q, k, v, mask, do, heads, dk)):
        _close_bf16(got, want)
    assert torch.equal(out, MA.attention_fwd(*plain[:3], mask, heads, dk))
    assert all(torch.equal(a, b) for a, b in zip(grads, MA.attention_bwd(*plain[:3], mask,
                                                                          plain[3], heads, dk)))


def test_attention_pair_bf16_through_autograd(cuda):
    """`msa_attention` on bf16 leaves: bf16 output and gradients, as the
    plain version's autograd gives them."""
    g = torch.Generator().manual_seed(3)
    leaves = [torch.randn(11, 20, 24, generator=g).to(BF16).to(cuda).requires_grad_(True)
              for _ in range(3)]
    w = torch.randn(11, 20, 24, generator=g).to(BF16).to(cuda)
    mask = (torch.rand(11, 20, generator=g) < 0.8).to(cuda)
    (MA.msa_attention(*leaves, 4, mask) * w).float().sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in leaves]
    (MA._attention_plain(*ref, 4, mask) * w).float().sum().backward()
    for a, b in zip(leaves, ref):
        assert a.grad.dtype == BF16
        _close_bf16(a.grad, b.grad)


# rows spanning many blocks at cols % 8 == 0 (16-byte accesses), cols 300
# (a multiple of 4, not of 8: group pairs straddle rows), odd cols (the row
# kernel), and views 2 and 8 bytes past an aligned start (the row kernel,
# 8-byte accesses); `offset` in elements
@pytest.mark.parametrize("rows,cols,rate,offset", [
    (1000, 300, 0.2, 0), (333, 7, 0.1, 0), (64, 400, 0.5, 0), (5001, 400, 0.2, 0),
    (2049, 300, 0.2, 0), (77, 333, 0.2, 0), (300, 300, 0.2, 1), (300, 300, 0.2, 4),
    (129, 8, 0.3, 4)])
def test_dropout_bf16_kernel_bit_for_bit(cuda, rows, cols, rate, offset):
    """The bf16 instance of A'' (x * fp32(1 / bf16(keep)), rounded once):
    the plain version's bits (x / bf16(keep)) forward and on the gradient,
    counted on `launches_bf16`."""
    x = (torch.randn(rows, cols, generator=torch.Generator().manual_seed(rows)) * 4).to(BF16)
    if offset:  # a contiguous view `offset` elements past an aligned start
        buf = torch.empty(rows * cols + offset, dtype=BF16, device=cuda)
        buf[offset:] = x.flatten().to(cuda)
        x = buf[offset:].view(rows, cols)
        assert x.data_ptr() % 16 == 2 * offset % 16
    x = x.to(cuda).requires_grad_(True)
    before = (DR.dropout.launches, DR.dropout.launches_bf16)
    out = DR.dropout(x, rate, 123, 9)
    gout = torch.randn(rows, cols, generator=torch.Generator().manual_seed(1)).to(BF16).to(cuda)
    out.backward(gout)
    assert (DR.dropout.launches, DR.dropout.launches_bf16) == (before[0], before[1] + 2)
    ref = x.detach().clone().requires_grad_(True)
    want = DR.dropout_plain(ref, rate, 123, 9)
    want.backward(gout)
    assert out.dtype == BF16 and torch.equal(out, want) and torch.equal(x.grad, ref.grad)


# B's bf16-activation instance: the serving graphs, D 398 and 30 (padded to
# 400 and 32), graphs of 5 and 7 nodes (R 2, one thread tile row), G 96 (one
# tile of 24 columns) and 100 (two column tiles in one block), B not a
# multiple of any tile; x at an offset of one element (the projection's copy
# to 16-byte rows, the fused kernel's element path)
@pytest.mark.parametrize("B,G,D,offset", [
    (9, 26, 400, 0), (70, 68, 400, 0), (7, 26, 398, 0), (3, 5, 7, 0), (1024, 68, 400, 0),
    (13, 68, 30, 0), (5, 7, 398, 0), (11, 96, 400, 0), (3, 100, 64, 0), (9, 26, 400, 1),
    (7, 5, 30, 1)])
def test_gat_layer_bf16_activations_kernel(cuda, B, G, D, offset):
    """B with bf16 x, query and weights (its own counter): a bf16 result
    within one ulp of the plain layer's, which computes in fp32 and rounds
    once (a row with no neighbour: uniform); the same bits twice."""
    args = [t.to(BF16) if t.is_floating_point() else t for t in _gat_args(cuda, B, G, D,
                                                                          seed=G + 2)]
    if offset:  # x a contiguous view `offset` elements past an aligned start
        buf = torch.empty(B * G * D + offset, dtype=BF16, device=cuda)
        buf[offset:] = args[0].flatten()
        args[0] = buf[offset:].view(B, G, D)
        assert args[0].data_ptr() % 16
    fused = GL.interactive_gat_layer_fused
    before = (fused.launches, fused.launches_bf16, fused.launches_bf16_act)
    out = fused(*args)
    assert (fused.launches, fused.launches_bf16, fused.launches_bf16_act) == \
        (*before[:2], before[2] + 1)
    _close_bf16(out, GL.interactive_gat_layer_plain(*args))
    assert torch.equal(out, fused(*args))


# C's bf16 forward: the training graphs, D 398 and 30, graphs of 5 and 7
# nodes, G 100 (two column blocks), B not a multiple of any tile; k1 and k2
# column blocks of a y whose row stride (3 D + 8) or offset (one element
# further) break 16 bytes or not: the 16-byte copies and the element copies
@pytest.mark.parametrize("B,G,D,shift", [
    (320, 68, 400, 0), (320, 26, 400, 0), (5, 7, 30, 0), (7, 5, 398, 0), (13, 68, 30, 0),
    (3, 100, 64, 0), (9, 26, 400, 1), (11, 68, 398, 1), (320, 68, 400, 1)])
def test_gat_scores_fwd_bf16_kernel(cuda, B, G, D, shift):
    """C's forward on bf16 k1, k2 (column blocks of a bf16 y), k3 and a:
    bf16 scores within one ulp of the plain version's; the same bits twice."""
    g = torch.Generator().manual_seed(G + D)
    y = (torch.randn(B, G, 3 * D + 8, generator=g) * 0.3).to(BF16).to(cuda)
    k3 = (torch.randn(B, D, generator=g) * 0.3).to(BF16).to(cuda)
    a = (torch.randn(D, generator=g) * D ** -0.5).to(BF16).to(cuda)
    k1, k2 = y[..., D + shift:2 * D + shift], y[..., 2 * D + shift:3 * D + shift]
    vector = GS.bf16_vector_copies((k1.data_ptr(), k2.data_ptr()), k1.stride(1), k2.stride(1), D)
    assert vector == (D % 8 == 0 and shift == 0)
    before = (GS.gat_scores_fwd.launches, GS.gat_scores_fwd.launches_bf16)
    out = GS.gat_scores_fwd(k1, k2, k3, a)
    assert (GS.gat_scores_fwd.launches, GS.gat_scores_fwd.launches_bf16) == \
        (before[0], before[1] + 1)
    _close_bf16(out, GS.gat_scores_fwd_plain(k1, k2, k3, a))
    assert torch.equal(out, GS.gat_scores_fwd(k1, k2, k3, a))


def test_gat_scores_bwd_takes_the_float64_side_at_the_kink(cuda):
    """k1 = -1, k2 = 1, k3 = 2^-25 at one (i, j, d): the fp32 sum is 0, the
    exact one positive. The card's backward counts g there as the plain
    version does (both decide by the float64 sum), so the two agree to fp32
    rounding where an fp32 mask would leave out a whole a g term."""
    B, G, D = 2, 40, 64
    g = torch.Generator().manual_seed(7)
    k1, k2 = torch.randn(B, G, D, generator=g), torch.randn(B, G, D, generator=g)
    k3, a = torch.randn(B, D, generator=g), torch.randn(D, generator=g)
    go = torch.randn(B, G, G, generator=g)
    k1[1, 37, 5], k2[1, 2, 5], k3[1, 5] = -1.0, 1.0, 2.0 ** -25
    got = GS.gat_scores_bwd(*(t.to(cuda) for t in (k1, k2, k3, a, go)))
    want = GS.interactive_gat_scores_bwd_plain(k1, k2, k3, a, go)
    for x, w in zip(got, want):
        _close(x.cpu(), w)
    term = abs(float(a[5] * go[1, 2, 37]))
    assert abs(float(got[0][1, 37, 5].cpu() - want[0][1, 37, 5])) < 1e-3 * term


@pytest.mark.parametrize("G", [26, 40, 68])
def test_gat_scores_bwd_takes_the_plain_side_at_many_kinks(cuda, G):
    """Every row of k1 the negated k2 + k3 of a row of k2, moved by 0 to 2
    fp32 ulps, so thousands of sums are 0 or within an ulp of it (one tile
    at G 26, several at 40 and 68): the kernel's per-row rule takes the
    plain version's side at every term, so gk1 and gk2 agree to fp32
    rounding where a single other side would move an element by a whole
    a g term."""
    B, D = 3, 96
    gen = torch.Generator().manual_seed(G)
    k2, k3 = torch.randn(B, G, D, generator=gen), torch.randn(B, D, generator=gen)
    k3[1] *= 2.0 ** -24
    k1 = -(k2 + k3[:, None, :])[:, torch.randperm(G, generator=gen)]
    for _ in range(2):
        n = torch.randint(-1, 2, k1.shape, generator=gen)
        k1 = torch.where(n != 0, torch.nextafter(k1, n.float() * torch.inf), k1)
    a, go = torch.randn(D, generator=gen), torch.randn(B, G, G, generator=gen)
    t = k1[:, None] + (k2[:, :, None] + k3[:, None, None])
    assert int((t == 0).sum()) > 100
    got = GS.gat_scores_bwd(*(x.to(cuda) for x in (k1, k2, k3, a, go)))
    want = GS.interactive_gat_scores_bwd_plain(k1, k2, k3, a, go)
    for x, w in zip(got, want):
        _close(x.cpu(), w)
    # where the float64 side differs from the fp32 t's, gk1 moves by the
    # sum of the flipped a g terms: the card must sit on the float64 side
    fp32_side = torch.where(t > 0, go[..., None], torch.zeros(())).sum(dim=1) * a
    moved = (want[0] - fp32_side).abs()
    at = moved > 1e-3
    assert int(at.sum()) > 10
    assert bool(((got[0].cpu() - want[0]).abs()[at] < 0.1 * moved[at]).all())


def test_cnn_bf16_scorer_card_matches_cpu(cuda):
    """CNN-DIGAT at bf16: stage 2 launches B's bf16-activation instance only,
    and the scores match the CPU's within 1e-4 of their scale."""
    cfg = _small_cfg(news_encoder="CNN", cnn_kernel_num=32)
    rng = np.random.default_rng(2)
    tables = _tables(cfg, 70, rng)
    hist, cat = rng.integers(1, 70, (12, 7)), rng.integers(0, 5, (12, 7))
    imp, cand = np.repeat(np.arange(12), 4), rng.integers(1, 70, 48)
    scores = {}
    fused = GL.interactive_gat_layer_fused
    for dev in (cuda, "cpu"):
        model = Model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        b = (fused.launches, fused.launches_bf16, fused.launches_bf16_act)
        scores[str(dev)] = CachedScorer(model, 16).score_items(tables, hist, cat, imp, cand)
        if dev != "cpu":
            assert (fused.launches, fused.launches_bf16, fused.launches_bf16_act) == \
                (b[0], b[1], b[2] + 3 * 2 * 2)
    s_gpu, s_cpu = scores[str(cuda)], scores["cpu"]
    assert np.isfinite(s_gpu).all()
    assert np.abs(s_gpu - s_cpu).max() <= 1e-4 * max(1.0, float(np.abs(s_cpu).max()))


def test_nrms_sa_bf16_train_step_card_matches_cpu(cuda):
    """One NRMS-SA bf16 step (dropout 0.2): the title tower's pair and word
    dropouts on their bf16 instances, the user tower's pair on the fp32
    one; the loss within 1e-3 and every gradient within max(1e-3 * max
    |cpu|, one bf16 ulp of the tensor's largest |cpu| element)."""
    from types import SimpleNamespace

    cfg = Config(dataset="synthetic", model_family="nrms", vocabulary_size=300,
                 word_embedding_dim=24, nrms_head_num=4, nrms_head_dim=6,
                 nrms_attention_dim=16, max_title_length=12, max_history_num=10,
                 augmented_news_num=3, dropout_rate=0.2, compute_dtype="bfloat16")
    rng = np.random.default_rng(3)
    n = 50
    arrays = SimpleNamespace(news_title_text=rng.integers(1, 300, (n, 12)),
                             news_title_mask=np.arange(12)[None, :] < rng.integers(1, 13, (n, 1)),
                             augmented_news=rng.integers(1, n, (n, 3)))
    batch = batching.TrainBatch(history_idx=rng.integers(1, n, (8, 10)),
                                cat_idx=np.zeros((8, 10), np.int64),
                                sample_idx=rng.integers(1, n, (8, 5)),
                                weight=np.ones(8, np.float32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = NRMSModel(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        opt = Adam(model.named_parameters(), 0.0, 1.0)
        c = (MA.attention_fwd.launches, MA.attention_fwd.launches_bf16,
             DR.dropout.launches_bf16)
        loss = train_step(model, opt, NRMSTables.from_arrays(arrays, dev),
                          batching.to_device(batch, dev), 5, 0.0)
        if dev.type == "cuda":
            # three title-tower calls on the bf16 pair, the user tower on the
            # fp32 one; the three word dropouts bf16, forward and backward
            assert (MA.attention_fwd.launches - c[0], MA.attention_fwd.launches_bf16 - c[1],
                    DR.dropout.launches_bf16 - c[2]) == (1, 3, 6)
        out[dev.type] = (float(loss), {k: p.grad.cpu() for k, p in model.named_parameters()})
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-3 * max(1.0, abs(l_cpu))
    for name, g in g_cpu.items():
        limit = max(float(_ulp(g.abs().max())), 1e-3 * float(g.abs().max()))
        assert float((g_gpu[name] - g).abs().max()) <= limit, name
