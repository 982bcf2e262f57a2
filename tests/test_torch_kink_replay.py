"""The kink replay of `chip_smoke.py`'s training gate (`KinkReplay`: the
Eq. (8) sums of C's backward, the model's ReLUs and leaky ReLUs) and
the control of its phase-21 gate (`k3_left_out`), on the CPU at the small
widths of tests/test_torch_support.py, for MSA-DIGAT at fp32 and CNN-DIGAT
at bf16 (dropout 0.2).

  * A run replayed against its own record takes every recorded mask, in
    order, counts no flip, and gives the same gradients bit for bit.
  * A record taken on inputs that round otherwise (the word table scaled
    by 1 + 2^-10) differs from the replaying run's own masks at a few
    terms, which the replay counts and takes.
  * The control moves the step's gradients far past the gate's 1e-3.
  * Under each patch the kernels' wrappers keep their launch counters."""

import numpy as np
import pytest
import torch

import chip_smoke
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.models.model import CorpusTables, Model
from digat_tpu_torch.ops import gat_scores as GS
from tests.test_torch_support import one_thread, port_config, train_corpus  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CASES = {"MSA fp32": dict(), "CNN bf16": dict(news_encoder="CNN", cnn_kernel_num=32,
                                              compute_dtype="bfloat16")}


def _step(cfg, scale: float = 1.0):
    """One step's loss and gradients from seeded weights on a seeded batch."""
    corpus = train_corpus(np.random.default_rng(4), cfg, 40, 30, 40)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(4))
    split = corpus.splits["train"]
    b = next(batching.train_batches(split.history_idx, split.cat_idx, corpus.train_behavior_row,
                                    corpus.train_pos, neg, 8, epoch_seed=0,
                                    news_node_id=corpus.news_node_id, dedup_titles=512))
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.news_encoder.word_embedding.weight.mul_(scale)
    loss = model.loss(CorpusTables.from_arrays(corpus.tables(), "cpu"),
                      batching.to_device(b, "cpu"), 11)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_of_its_own_record_changes_nothing(case):
    cfg = port_config(dropout_rate=0.2, **CASES[case])
    kinks = chip_smoke.KinkReplay(torch)
    with kinks.record():
        loss_a, grads_a = _step(cfg)
    assert kinks.masks
    with kinks.replay():
        loss_b, grads_b = _step(cfg)
    assert sum(kinks.flips.values()) == 0
    for kind in kinks.KINDS:
        assert kinks.terms[kind] == sum(m.numel() for m in kinks.masks[kind]) > 0, kind
        assert not kinks.pending[kind], kind
    assert loss_a == loss_b
    for n, g in grads_a.items():
        assert torch.equal(g, grads_b[n]), n


def test_replay_counts_and_takes_the_recorded_side():
    cfg = port_config(dropout_rate=0.2, **CASES["CNN bf16"])
    kinks = chip_smoke.KinkReplay(torch)
    with kinks.record():
        _step(cfg, 1.0 + 2.0 ** -10)
    with kinks.replay():
        _, replayed = _step(cfg)
    _, own = _step(cfg)
    flips, terms = sum(kinks.flips.values()), sum(kinks.terms.values())
    assert 0 < flips < 1e-2 * terms
    assert any(not torch.equal(g, own[n]) for n, g in replayed.items())


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_fails_the_gate(case):
    cfg = port_config(dropout_rate=0.2, **CASES[case])
    _, sound = _step(cfg)
    with chip_smoke.k3_left_out():
        _, faulty = _step(cfg)
    worst = max(float((faulty[n] - g).abs().max()) / max(float(g.abs().max()), 1e-12)
                for n, g in sound.items())
    assert worst > 10 * chip_smoke.TRAIN_RTOL


def test_patches_keep_the_wrappers_and_their_counters():
    kinks = chip_smoke.KinkReplay(torch)
    wrappers = (GS.gat_scores_fwd, GS.gat_scores_bwd)
    for patch in (kinks.record(), kinks.replay(), chip_smoke.k3_left_out()):
        with patch:
            assert (GS.gat_scores_fwd, GS.gat_scores_bwd) == wrappers
            assert all(isinstance(w.launches, int) for w in wrappers)
