"""Port ops and the user graph against `digat_tpu` (CPU, fp32, 1e-5;
the user graph bit-exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.data.user_graph import build_user_graph as jax_build_user_graph
from digat_tpu.ops.gat import interactive_gat_scores_xla
from digat_tpu.ops.segment import segment_softmax_sum as jax_segment_softmax_sum
from digat_tpu_torch.data.user_graph import build_user_graph
from digat_tpu_torch.ops import gat as torch_gat
from digat_tpu_torch.ops.gat import interactive_gat_scores
from digat_tpu_torch.ops.segment import segment_softmax_sum
from tests.test_torch_support import MODULE_TOL


def test_segment_softmax_sum_with_empty_segments():
    rng = np.random.default_rng(0)
    B, H, D, S = 4, 9, 5, 6
    scores = rng.normal(size=(B, H)).astype(np.float32) * 2
    values = rng.normal(size=(B, H, D)).astype(np.float32)
    seg = rng.integers(0, 3, (B, H))  # segments 3..5 stay empty
    seg[1] = 5  # one row with a single segment
    a_want, s_want = jax_segment_softmax_sum(jnp.asarray(scores), jnp.asarray(values),
                                             jnp.asarray(seg), S)
    a_got, s_got = segment_softmax_sum(torch.from_numpy(scores), torch.from_numpy(values),
                                       torch.from_numpy(seg), S)
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_want), **MODULE_TOL)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), **MODULE_TOL)
    assert not s_got[0, 3:].any()  # empty segments give zero rows


@pytest.mark.parametrize("B,G,D", [(3, 6, 16), (2, 14, 32)])
def test_interactive_gat_scores(B, G, D, monkeypatch):
    rng = np.random.default_rng(1)
    k1, k2 = (rng.normal(size=(B, G, D)).astype(np.float32) for _ in range(2))
    k3 = rng.normal(size=(B, D)).astype(np.float32)
    a = rng.normal(size=D).astype(np.float32)
    want = np.asarray(interactive_gat_scores_xla(*(jnp.asarray(t) for t in (k1, k2, k3, a))))
    got = interactive_gat_scores(*(torch.from_numpy(t) for t in (k1, k2, k3, a)))
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)
    # the batch-chunked evaluation (one graph per chunk) gives the same result
    monkeypatch.setattr(torch_gat, "_MAX_ELEMENTS", G * G * D)
    small = interactive_gat_scores(*(torch.from_numpy(t) for t in (k1, k2, k3, a)))
    np.testing.assert_allclose(small.numpy(), got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("H,C", [(6, 4), (50, 18)])
def test_build_user_graph_bit_exact(H, C):
    rng = np.random.default_rng(2)
    cat = rng.integers(0, C, (7, H))
    for r, n in enumerate(rng.integers(0, H + 1, 7)):
        cat[r, n:] = C  # padded slots
    cat[0] = C  # empty history
    g_want, m_want = jax_build_user_graph(jnp.asarray(cat), H, C)
    g_got, m_got = build_user_graph(torch.from_numpy(cat), H, C)
    assert g_got.dtype == torch.bool and m_got.dtype == torch.bool
    np.testing.assert_array_equal(g_got.numpy(), np.asarray(g_want))
    np.testing.assert_array_equal(m_got.numpy(), np.asarray(m_want))
