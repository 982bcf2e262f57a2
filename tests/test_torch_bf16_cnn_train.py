"""CNN-DIGAT training at `compute_dtype` bfloat16 against `digat_tpu` (B, C
and D on its kernel path, Pallas in interpret mode), on the CPU, at the
small widths of tests/test_torch_support.py (D 32); the eval side is
tests/test_torch_bf16_cnn.py, whose docstring says where the port rounds.

  * one training step (dedup batch with the sorted embedding metadata,
    dropout 0, op by op): the loss within 1e-4 relative; each gradient
    within four bf16 ulps of its tensor's largest |JAX| element, a bias's
    within eight (measured at most 3 and 6): the two autograds round the
    bf16 backward's intermediates at different places, and JAX's CPU
    backend sums a bias's bf16 cotangent over the rows in bf16;
  * five Adam steps against JAX's jitted train step: each loss within 2e-2
    relative (measured at most 1.5e-2, at step 5). Not closer: Adam's first
    steps move every weight by about lr whatever its gradient's size, so
    each element of a bf16 gradient near 0 that the two sides round to
    opposite signs moves its weight 2 lr apart, step after step; and XLA's
    jit keeps some bf16 intermediates in fp32. Step 1 itself agrees within
    1e-4 (above)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.models.model import CorpusTables as JaxTables
from digat_tpu.models.model import DedupTrainBatch as JaxDedupBatch
from digat_tpu.ops.pallas.emb_grad import build_sorted_emb_meta
from digat_tpu.train import optimizer as jax_optimizer
from digat_tpu.train.train_step import make_train_step
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.interop import params_from_model
from digat_tpu_torch.models.model import CorpusTables
from digat_tpu_torch.train.optimizer import Adam
from digat_tpu_torch.train.train_step import train_step
from tests.test_torch_support import (BATCH_FIELDS, bf16_models, bf16_step_case,  # noqa: F401
                                      bf16_ulp, jax_interpret, one_thread, train_corpus)

pytestmark = pytest.mark.usefixtures("one_thread")

CNN = dict(news_encoder="CNN", cnn_kernel_num=32)


def _port_grads(pm):
    gm = copy.deepcopy(pm)
    with torch.no_grad():
        for p, q in zip(gm.parameters(), pm.parameters()):
            p.copy_(q.grad)
    return jax.tree.leaves(params_from_model(gm))


def test_one_training_step_matches_jax():
    jm, params, pm, jt, jb, pt, pb = bf16_step_case(seed=1, **CNN)
    with jax_interpret():
        loss_j, g_j = jax.value_and_grad(jm.loss)(params, jt, jb, jax.random.PRNGKey(0))
    loss_p = pm.loss(pt, pb, 1)
    loss_p.backward()
    assert abs(float(loss_p.detach()) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(g_j), _port_grads(pm)):
        want, got = np.asarray(want), np.asarray(got)
        assert got.dtype == np.float32 and got.shape == want.shape
        top = float(bf16_ulp(torch.tensor(float(np.abs(want).max()))))
        bias = jax.tree_util.keystr(path).endswith("['b']")
        assert float(np.abs(got - want).max()) <= (8 if bias else 4) * top, \
            jax.tree_util.keystr(path)


def test_five_adam_steps_match_jax():
    jm, params, pm = bf16_models(seed=3, dropout_rate=0.0, **CNN)
    cfg = jm.config
    corpus = train_corpus(np.random.default_rng(7), cfg, 40, 30, 80)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(7))
    split = corpus.splits["train"]
    batches = list(batching.train_batches(
        split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg, 8,
        epoch_seed=0, news_node_id=corpus.news_node_id, dedup_titles=512))[:5]
    assert len(batches) == 5
    raw = corpus.tables()
    jt = JaxTables(*(jnp.asarray(getattr(raw, f)) for f in BATCH_FIELDS))
    pt = CorpusTables.from_arrays(raw, "cpu")
    titles = np.asarray(raw.news_title_text)
    tx = jax_optimizer.make_optimizer(0.0, 1.0, params)
    state = tx.init(params)
    opt = Adam(pm.named_parameters(), 0.0, 1.0)
    jax_loss, port_loss = [], []
    with jax_interpret():
        step = make_train_step(jm, tx)
        p = params
        for b in batches:
            emb = build_sorted_emb_meta(titles[np.asarray(b.uniq_ids)], cfg.vocabulary_size,
                                        ship_sort_arrays=False)
            p, state, loss = step(p, state, jt, JaxDedupBatch(*map(jnp.asarray, b), emb=emb),
                                  jax.random.PRNGKey(0), 1e-3)
            jax_loss.append(float(loss))
            port_loss.append(float(train_step(pm, opt, pt, batching.to_device(b, "cpu"), 1,
                                              1e-3)))
    jax_loss, port_loss = np.array(jax_loss), np.array(port_loss)
    assert (np.abs(port_loss - jax_loss) <= 2e-2 * np.abs(jax_loss)).all(), (port_loss, jax_loss)
