"""Five Adam steps of MSA-DIGAT at `compute_dtype` bfloat16 (dedup batches
with the sorted embedding-gradient metadata, dropout 0, clip 1.0, lr 1e-3):
the port's `train_step` against the JAX train step on its kernel path
(Pallas in interpret mode), from the same weights, on the CPU. The fp32
masters and Adam's state follow bf16-rounded gradients that agree as
tests/test_torch_bf16_train.py holds them, and each loss stays within
1e-3 relative of JAX's. Not 1e-4: Adam's first steps move every weight by
about lr whatever its gradient's size, so a gradient element within
rounding of 0 that the two sides round to opposite signs (the topic-node
embeddings, which JAX's CPU backend sums over the batch in bf16) puts
that weight 2 lr apart after one step (measured: 0.002 after step 1, the
loss 2.2e-4 relative apart after step 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digat_tpu.models.model import CorpusTables as JaxTables
from digat_tpu.models.model import DedupTrainBatch as JaxDedupBatch
from digat_tpu.ops.pallas.emb_grad import build_sorted_emb_meta
from digat_tpu.train import optimizer as jax_optimizer
from digat_tpu.train.train_step import make_train_step
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.models.model import CorpusTables
from digat_tpu_torch.train.optimizer import Adam
from digat_tpu_torch.train.train_step import train_step
from tests.test_torch_support import (BATCH_FIELDS, bf16_models, jax_interpret,  # noqa: F401
                                      one_thread, train_corpus)

pytestmark = pytest.mark.usefixtures("one_thread")


def test_five_adam_steps_match_jax():
    jm, params, pm = bf16_models(seed=3, dropout_rate=0.0)
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
    assert (np.abs(port_loss - jax_loss) <= 1e-3 * np.abs(jax_loss)).all(), (port_loss, jax_loss)
