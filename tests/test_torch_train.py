"""The port's training slice against `digat_tpu` on the CPU.

  * optimizer: steps against the optax chain of `make_optimizer`, with the
    clip engaged and not, decay on and off, optax's clip and the
    torch-compatible one (fp64, rtol 1e-12: in fp32 the
    JAX side rounds its bias correction 1 - 0.999^t to fp32);
  * batching: index blocks identical to `digat_tpu.data.batching` for the
    same seeds, dedup on and off;
  * dedup: the same logits and gradients as the plain batch (fp64, 1e-12);
  * the slice: a 30-step fp64, dropout-off training trajectory of the
    port's plain path against `digat_tpu.train.train_step.make_train_step`
    under `jax.enable_x64(True)`: per-step loss <= 1e-9 relative, final
    parameters <= 1e-7 absolute;
  * the `Trainer`: two epochs on seeded arrays, the loss falls, and a run
    resumed from the epoch-1 checkpoint continues bit for bit;
  * the two faults this slice repaired: the CUDA path of the encoder goes
    through its autograd Function, and kernel B refuses to run where a
    gradient is wanted (both reached with the device dispatch
    monkeypatched)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from digat_tpu.data import batching as jax_batching
from digat_tpu.data import sampling as jax_sampling
from digat_tpu.train import optimizer as jax_optimizer
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.models.model import CorpusTables, Model, TrainBatch
from digat_tpu_torch.ops import build
from digat_tpu_torch.ops import gat_layer as GL
from digat_tpu_torch.ops import msa_encoder as ME
from digat_tpu_torch.train import optimizer
from digat_tpu_torch.train.train_step import step_seed
from digat_tpu_torch.train.trainer import Trainer
from tests.test_torch_support import (fp64_trajectory, jax_config, models, port_config,
                                      train_corpus)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
OPTIMIZER_CASES = [
    pytest.param(clip, decay, compat,
                 id="-".join([*(["torch_compat_clip"] if compat else []), decay_id, clip_id]))
    for compat in (False, True)
    for decay, decay_id in ((0.0, "no_decay"), (0.01, "decay"))
    for clip, clip_id in ((1.0, "clip_engaged"), (50.0, "clip_idle"))]


@pytest.mark.parametrize("clip,decay,torch_compat_clip", OPTIMIZER_CASES)
def test_optimizer_matches_optax(clip, decay, torch_compat_clip):
    rng = np.random.default_rng(0)
    shapes = {"news_encoder.W_Q.weight": (6, 5), "news_encoder.W_Q.bias": (6,),
              "news_encoder.word_embedding.weight": (9, 4),
              "graph_encoder.gate.weight": (3, 3)}
    init = {k: rng.normal(size=s) for k, s in shapes.items()}
    tree = lambda d: {"news_encoder": {"W_Q": {"w": d["news_encoder.W_Q.weight"],
                                               "b": d["news_encoder.W_Q.bias"]},
                                       "word_embedding": d["news_encoder.word_embedding.weight"]},
                      "graph_encoder": {"gate": {"w": d["graph_encoder.gate.weight"]}}}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = optimizer.Adam(params.items(), weight_decay=decay, gradient_clip_norm=clip,
                         torch_compat_clip=torch_compat_clip)
    with jax.enable_x64(True):
        jp = jax.tree.map(jnp.asarray, tree(init))
        tx = jax_optimizer.make_optimizer(decay, clip, jp,
                                          torch_compat_clip=torch_compat_clip)
        state = tx.init(jp)
        for step in range(6):
            grads = {k: rng.normal(size=s) * 0.7 for k, s in shapes.items()}
            for k, p in params.items():
                p.grad = torch.from_numpy(grads[k])
            lr = optimizer.lr_at_epoch(1e-2, step, 3)
            opt.step(lr)
            updates, state = tx.update(jax.tree.map(jnp.asarray, tree(grads)), state, jp)
            jp = optax.apply_updates(jp, jax.tree.map(lambda u: -lr * u, updates))
            got = tree({k: p.detach().numpy() for k, p in params.items()})
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-14)
    assert opt.count == 6
    if clip == 1.0:  # the clip engaged: the gradients' norm was above it
        assert float(torch.sqrt(sum((p.grad ** 2).sum() for p in params.values()))) > clip


def test_schedules_match_jax():
    for epochs in (1, 2, 7, 16, 25):
        cfg = port_config(epoch_override=epochs)
        assert cfg.lr_decay_epoch == jax_config(epoch_override=epochs).lr_decay_epoch
        for e in range(1, epochs + 1):
            assert optimizer.lr_at_epoch(1e-4, e, cfg.lr_decay_epoch) == \
                jax_optimizer.lr_at_epoch(1e-4, e, cfg.lr_decay_epoch)
    for k in range(3):
        a, b = step_seed(7, 3, k), step_seed(7, 3, k + 1)
        assert 0 <= a < 2**32 and a != b and a == step_seed(7, 3, k)


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus():
    cfg = port_config()
    return train_corpus(np.random.default_rng(0), cfg, 60, 14, 75)


def test_negatives_and_capacity_match_jax(corpus):
    for seed in (0, 3):
        args = (corpus.train_neg_flat, corpus.train_neg_offsets, 4)
        np.testing.assert_array_equal(
            sampling.sample_negatives(*args, np.random.default_rng(seed)),
            jax_sampling.sample_negatives(*args, np.random.default_rng(seed)))
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    args = (corpus.splits["train"].history_idx, corpus.train_behavior_row, corpus.train_pos,
            neg, corpus.news_node_id, 8)
    assert batching.estimate_dedup_capacity(*args, seed=2) == \
        jax_batching.estimate_dedup_capacity(*args, seed=2)


@pytest.mark.parametrize("dedup", [0, 512, 59], ids=["plain", "dedup", "dedup_overflow"])
def test_train_batches_match_jax(corpus, dedup):
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    args = (corpus.splits["train"].history_idx, corpus.splits["train"].cat_idx,
            corpus.train_behavior_row, corpus.train_pos, neg, 8)
    kw = dict(epoch_seed=11, news_node_id=corpus.news_node_id if dedup else None,
              dedup_titles=dedup)
    got = list(batching.train_batches(*args, **kw))
    want = list(jax_batching.train_batches(*args, **kw))
    assert len(got) == len(want) == 10  # 75 samples: 9 full batches and a padded tail
    kinds = set()
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        kinds.add(type(g).__name__)
        for name in g._fields:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
    assert got[-1].weight[3:].sum() == 0 and got[-1].weight[:3].sum() == 3
    assert kinds == ({"TrainBatch"} if dedup == 0 else
                     {"DedupTrainBatch"} if dedup == 512 else {"TrainBatch", "DedupTrainBatch"})


def test_prefetcher_yields_device_batches_in_order(corpus):
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    args = (corpus.splits["train"].history_idx, corpus.splits["train"].cat_idx,
            corpus.train_behavior_row, corpus.train_pos, neg, 8)
    want = list(batching.train_batches(*args, epoch_seed=3))
    got = list(batching.Prefetcher(batching.train_batches(*args, epoch_seed=3), "cpu", depth=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.history_idx.dtype == torch.int64 and g.weight.dtype == torch.float32
        for name in g._fields:
            np.testing.assert_array_equal(getattr(g, name).numpy(), getattr(w, name))
    early = batching.Prefetcher(batching.train_batches(*args, epoch_seed=3), "cpu", depth=1)
    next(early)
    early.close()
    assert not early._thread.is_alive()

    def broken():
        yield want[0]
        raise RuntimeError("assembly failed")

    it = batching.Prefetcher(broken(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="assembly failed"):
        next(it)


# ---------------------------------------------------------------------------
# model: dedup against the plain batch; the fp64 trajectory against JAX
# ---------------------------------------------------------------------------
def _tables(corpus, device="cpu"):
    return CorpusTables.from_arrays(corpus.tables(), device)


def test_dedup_batch_gives_the_plain_logits_and_gradients(corpus):
    _, _, pm = models(seed=1, dropout_rate=0.0)
    pm = pm.double()
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(2))
    plain = next(batching.train_batches(
        corpus.splits["train"].history_idx, corpus.splits["train"].cat_idx,
        corpus.train_behavior_row, corpus.train_pos, neg, 8, epoch_seed=5))
    dedup = batching.dedup_batch(plain, corpus.news_node_id, 256)
    tables = _tables(corpus)
    out = []
    for b in (plain, dedup):
        pm.zero_grad()
        logits = pm.forward_indexed(tables, batching.to_device(b, "cpu"), seed=9)
        logits.sum().backward()
        out.append((logits.detach(), {n: p.grad.clone() for n, p in pm.named_parameters()}))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-12, atol=1e-12)
    for n, g in out[0][1].items():
        torch.testing.assert_close(g, out[1][1][n], rtol=1e-12, atol=1e-12, msg=n)


def test_fp64_training_trajectory_matches_jax(corpus):
    """30 steps of the port's plain training path (fp64, dropout off,
    clip 1.0, lr 1e-3, dedup batches) against the JAX train step on the same
    batches (`test_torch_support.fp64_trajectory`)."""
    rel, param_err, first, last = fp64_trajectory(corpus)
    assert rel <= 1e-9
    assert param_err <= 1e-7
    assert last < first  # the trajectory went somewhere


def test_train_step_is_seeded_and_finite_with_dropout(corpus):
    """Dropout 0.2 on the CPU plain path: the same seed gives the same loss
    and gradients, another seed another loss."""
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    batch = batching.to_device(next(batching.train_batches(
        corpus.splits["train"].history_idx, corpus.splits["train"].cat_idx,
        corpus.train_behavior_row, corpus.train_pos, neg, 8, epoch_seed=1,
        news_node_id=corpus.news_node_id, dedup_titles=512)), "cpu")
    tables = _tables(corpus)
    losses, grads = [], []
    for seed in (5, 5, 6):
        pm = Model(port_config(), device="cpu", generator=torch.Generator().manual_seed(0))
        loss = pm.loss(tables, batch, seed)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append(torch.cat([p.grad.reshape(-1) for p in pm.parameters()]))
    assert np.isfinite(losses).all() and bool(torch.isfinite(grads[0]).all())
    assert losses[0] == losses[1] and torch.equal(grads[0], grads[1])
    assert losses[2] != losses[0]


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------
def test_trainer_two_epochs_then_resume(tmp_path):
    cfg = dict(epoch_override=2, lr=2e-3, batch_size=8)
    data = train_corpus(np.random.default_rng(4), port_config(), 50, 10, 40)

    def run(run_dir, **over):
        model = Model(port_config(**{**cfg, **over}), device="cpu",
                      generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, model.config, data, str(run_dir), verbose=False)
        return trainer.train(), model

    full, model_full = run(tmp_path / "full")
    assert [h["epoch"] for h in full] == [1, 2]
    assert full[1]["loss"] < full[0]["loss"]
    assert all(np.isfinite(h["step_losses"]).all() for h in full)
    assert len(full[0]["step_ms"]) == len(full[0]["step_losses"]) == 5
    assert (tmp_path / "full" / "best.ckpt").exists()
    assert (tmp_path / "full" / "dev-epoch2.txt").exists()
    # stop after epoch 1 (early stopping with patience -1), then resume
    first, _ = run(tmp_path / "first", early_stopping_epoch=-1)
    assert [h["epoch"] for h in first] == [1]
    assert first[0]["step_losses"] == full[0]["step_losses"]
    resumed, model_resumed = run(tmp_path / "resumed",
                                 resume=str(tmp_path / "first" / "best.ckpt"))
    assert [h["epoch"] for h in resumed] == [2]
    assert resumed[0]["step_losses"] == full[1]["step_losses"]
    for (n, a), b in zip(model_full.state_dict().items(), model_resumed.state_dict().values()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# the faults repaired in this slice
# ---------------------------------------------------------------------------
def test_encoder_cuda_path_goes_through_its_autograd_function(monkeypatch):
    """The kernel writes into a fresh tensor with no graph. Its CUDA path
    must go through MSAEncoderFunction so the gradient reaches the weights:
    with the dispatch sent down that path and the two launches replaced by
    the plain computations (run without a graph, as a launch is), the
    result carries a graph whose backward is kernel A'."""
    launched = []

    def forward_launch(*args):
        launched.append("A")
        with torch.no_grad():
            return ME.msa_encoder_pooled_plain(*args)

    def backward_launch(*args):
        launched.append("A'")
        return ME.msa_encoder_bwd_plain(*args)

    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    monkeypatch.setattr(ME, "_forward_kernel", forward_launch)
    monkeypatch.setattr(ME, "msa_encoder_bwd", backward_launch)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 32, 8, generator=g)
    mask = torch.rand(5, 32, generator=g) < 0.7
    w = [torch.randn(*s, generator=g).requires_grad_(True)
         for s in ((8, 8), (8,), (8, 8), (8, 8), (8,), (8, 6), (6,), (6,))]
    out = ME.msa_encoder_pooled(x, mask, *w, 2, dropout_rate=0.2, seed=3)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert launched == ["A", "A'"]
    ref = [t.detach().requires_grad_(True) for t in w]
    ME.msa_encoder_pooled_plain(x, mask, *ref, 2, 0.2, 3, 0).square().sum().backward()
    for a, b in zip(w, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


def test_gat_layer_kernel_refuses_gradients(monkeypatch):
    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    g = torch.Generator().manual_seed(1)
    B, G, D = 2, 5, 8
    args = [torch.randn(B, G, D, generator=g).requires_grad_(True),
            torch.ones(B, G, G, dtype=torch.bool), torch.randn(B, D, generator=g)] + \
        [torch.randn(*s, generator=g) for s in ((D, D), (D,), (D, D), (D, D), (D, D), (D,), (D,))]
    with pytest.raises(RuntimeError, match="eval layer"):
        GL.interactive_gat_layer_fused(*args)


def test_training_layer_uses_kernel_c_and_eval_uses_kernel_b(corpus, monkeypatch):
    """Training GAT layers run Eq. (8) through kernel C's autograd Function,
    reading k1 and k2 from the fused projection y (the C' entry point); eval
    layers through kernel B, as `_gat_layer` picks the fused kernel only
    when not training."""
    from digat_tpu_torch.models import graph_encoders as GE

    calls = {"B": 0, "C": 0}
    real_b, real_c = GE.interactive_gat_layer_fused, GE.interactive_gat_scores_fused_y

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(GE, "interactive_gat_layer_fused", count("B", real_b))
    monkeypatch.setattr(GE, "interactive_gat_scores_fused_y", count("C", real_c))
    pm = Model(port_config(), device="cpu", generator=torch.Generator().manual_seed(0))
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    batch = batching.to_device(next(batching.train_batches(
        corpus.splits["train"].history_idx, corpus.splits["train"].cat_idx,
        corpus.train_behavior_row, corpus.train_pos, neg, 8, epoch_seed=1)), "cpu")
    assert isinstance(batch, TrainBatch)
    pm.loss(_tables(corpus), batch, seed=4).backward()
    depth = pm.config.graph_depth
    assert calls == {"B": 0, "C": 2 * depth}
    with torch.inference_mode():
        pm.forward_indexed(_tables(corpus), batch)
    assert calls == {"B": 2 * depth, "C": 2 * depth}
