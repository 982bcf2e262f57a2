"""The bf16 instances of kernels A, A' and B against their plain versions on
the card (`compute_dtype` bfloat16), and a bf16 model card against CPU.

Needs a CUDA device and nvcc; every test here is marked `cuda` and skips
without a card. Run as `tests/test_torch_cuda.py`:

    python -m pytest tests/test_torch_cuda_bf16.py -q --noconftest -p no:cacheprovider

Tolerances: fp32 outputs max |kernel - plain| <= 1e-4 * max(1, max |plain|);
A''s bf16 dx within one bf16 ulp of each plain element plus that bound."""

import numpy as np
import pytest
import torch

from digat_tpu_torch.config import Config
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.eval.scorer import CachedScorer
from digat_tpu_torch.models.model import CorpusTables, Model
from digat_tpu_torch.ops import gat_layer as GL
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


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("N,Din,heads,dk,A,L", _CASES)
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


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("N,Din,heads,dk,A,L", _CASES)
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


@pytest.mark.parametrize("B,G,D", [(9, 26, 400), (70, 68, 400), (7, 26, 398), (3, 5, 7),
                                   (1024, 68, 400)])
def test_gat_layer_bf16_weights_kernel(cuda, B, G, D):
    """B with bf16 weights (its own counter) against the plain layer, which
    forms every product in fp32 from the bf16 values; the same bits twice."""
    args = list(_gat_args(cuda, B, G, D, seed=G + 1))
    args[3:] = [t.to(BF16) for t in args[3:]]
    before = (GL.interactive_gat_layer_fused.launches, GL.interactive_gat_layer_fused.launches_bf16)
    out = GL.interactive_gat_layer_fused(*args)
    assert (GL.interactive_gat_layer_fused.launches,
            GL.interactive_gat_layer_fused.launches_bf16) == (before[0], before[1] + 1)
    _close(out, GL.interactive_gat_layer_plain(*args))
    assert torch.equal(out, GL.interactive_gat_layer_fused(*args))


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
