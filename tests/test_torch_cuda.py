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
from digat_tpu_torch.models.model import Model
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


def _msa_args(dev, N, Din, heads, dk, A, seed):
    g = torch.Generator().manual_seed(seed)
    D = heads * dk
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)
    x = r(N, 32, Din)
    mask = (torch.rand(N, 32, generator=g) < 0.75).to(dev)
    mask[0] = False  # all-pad title
    return (x, mask, r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(Din, D, sc=Din ** -0.5),
            r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(D, A, sc=D ** -0.5), r(A, sc=0.1),
            r(A, sc=A ** -0.5), heads)


@pytest.mark.parametrize("N,Din,heads,dk,A", [(37, 300, 16, 25, 256), (5, 24, 4, 8, 16)])
def test_msa_encoder_kernel(cuda, N, Din, heads, dk, A):
    args = _msa_args(cuda, N, Din, heads, dk, A, seed=N)
    before = msa_encoder_pooled.launches
    out = msa_encoder_pooled(*args)
    assert msa_encoder_pooled.launches == before + 1
    _close(out, msa_encoder_pooled_plain(*args))


def _gat_args(dev, B, G, D, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)
    adj = (torch.rand(B, G, G, generator=g) < 0.3) | torch.eye(G, dtype=torch.bool)
    adj[0, 1] = False  # no neighbour
    return (r(B, G, D, sc=0.5), adj.to(dev), r(B, D, sc=0.5), r(D, D, sc=D ** -0.5),
            r(D, sc=0.05), r(D, D, sc=D ** -0.5), r(D, D, sc=D ** -0.5), r(D, D, sc=D ** -0.5),
            r(D, sc=0.05), r(D, sc=D ** -0.5))


@pytest.mark.parametrize("B,G,D", [(9, 6, 32), (9, 26, 400), (70, 68, 400), (3, 33, 36)])
def test_gat_layer_kernel(cuda, B, G, D):
    args = _gat_args(cuda, B, G, D, seed=G)
    before = interactive_gat_layer_fused.launches
    out = interactive_gat_layer_fused(*args)
    assert interactive_gat_layer_fused.launches == before + 1
    _close(out, interactive_gat_layer_plain(*args))


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
