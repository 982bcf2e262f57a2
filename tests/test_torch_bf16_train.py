"""One training step of MSA-DIGAT at `compute_dtype` bfloat16 against the JAX
train step on its kernel path (Pallas in interpret mode; dedup batch with
the sorted embedding-gradient metadata, kernel D; dropout 0; CPU), and the
dtypes at every kernel's boundary.

Master weights stay fp32 and every forward computes on bf16 copies, so:
  * the loss agrees within 1e-5 relative;
  * every gradient is fp32, and every one but the word table's holds bf16
    values (the cast's transpose rounds it), on both sides;
  * the word table's gradient is not rounded (kernel D sums fp32 rows of
    the bf16 dx) and agrees within 1e-5 of its scale on 99 % of its
    elements: each token's dx is rounded to bf16 on both sides from fp32
    values that differ below 1e-6, so where one lies at a rounding boundary
    a row takes that term one ulp apart (measured: 0.14 % of the elements,
    2 ulps of the element at most), the limit on all of them;
  * every other gradient agrees within max(1e-5 * max |jax|, one bf16 ulp
    of the element), but for the parameters used more than once: the
    context attentions and gates (`news_ctx`, `user_ctx`, at every depth)
    sum their uses' bf16 gradients in bf16 on both sides, and where those
    sums cancel, an fp32 difference below 1e-6 in one use rounds a partial
    sum the other way (measured: up to 4 ulps of an element, 2.1e-5 of the
    tensor's scale at an element near 0). They are held to that limit on
    99 % of their elements and to one bf16 ulp of their largest element on
    all;
  * the topic-node embeddings' gradient agrees within four bf16 ulps of its
    largest element: JAX's CPU backend sums the batch's bf16 gradients of
    the broadcast nodes in bf16, the port in fp32 before one rounding
    (measured: 1-2 ulps).

The dtypes at each kernel's boundary are in tests/test_torch_bf16_dtypes.py,
five Adam steps in tests/test_torch_bf16_steps.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu_torch.interop import params_from_model
from tests.test_torch_support import bf16_step_case, bf16_ulp, jax_interpret, one_thread  # noqa

pytestmark = pytest.mark.usefixtures("one_thread")

@pytest.fixture(scope="module")
def step():
    jm, params, pm, jt, jb, pt, pb = bf16_step_case()
    with jax_interpret():
        loss_j, g_j = jax.value_and_grad(jm.loss)(params, jt, jb, jax.random.PRNGKey(0))
    loss_p = pm.loss(pt, pb, 1)
    loss_p.backward()
    return float(loss_j), g_j, float(loss_p.detach()), pm


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _port_grads(pm):
    """The port's gradients as the JAX tree's leaves (params_from_model of a
    model holding them)."""
    import copy

    gm = copy.deepcopy(pm)
    with torch.no_grad():
        for p, q in zip(gm.parameters(), pm.parameters()):
            p.copy_(q.grad)
    return [np.asarray(v) for v in jax.tree.leaves(params_from_model(gm))]


def _bf16_valued(a):
    return np.array_equal(np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)), a)


def test_loss_matches_jax(step):
    loss_j, _, loss_p, _ = step
    assert abs(loss_p - loss_j) <= 1e-5 * abs(loss_j)


def test_gradients_are_fp32_masters_rounded_as_jax_rounds_them(step):
    _, g_j, _, pm = step
    assert all(p.grad.dtype == torch.float32 for p in pm.parameters())
    for (name, want), got in zip(_leaves(g_j), _port_grads(pm)):
        assert want.dtype == np.float32 and got.dtype == np.float32
        if "word_embedding" in name:
            assert not _bf16_valued(want) and not _bf16_valued(got)
            err = np.abs(got - want)
            floor = 1e-5 * max(1.0, float(np.abs(want).max()))
            assert float((err > floor).mean()) <= 0.01
            ulp = bf16_ulp(torch.from_numpy(np.array(want))).numpy()
            assert (err <= np.maximum(floor, 2 * ulp)).all()
            continue
        assert _bf16_valued(want) and _bf16_valued(got), name
        err = torch.from_numpy(np.abs(got - want))
        limit = torch.clamp(bf16_ulp(torch.from_numpy(np.array(want))),
                            min=1e-5 * float(np.abs(want).max()))
        top = float(bf16_ulp(torch.tensor(float(np.abs(want).max()))))
        if "topic_node_embedding" in name:
            assert float(err.max()) <= 4 * top, name
        elif "_ctx" in name:
            assert float((err > limit).float().mean()) <= 0.01 and float(err.max()) <= top, name
        else:
            assert (err <= limit).all(), name
