"""Shared set-up for the port's CPU tests (no tests of its own).

Builds one small MSA-DIGAT configuration in both packages, the JAX
parameters from a seed, and the port model carrying those parameters via
`digat_tpu_torch.interop.load_jax_params`. Small widths keep every test
well under a minute: D 32, L 8, depth 2, Gn 6, H 6."""

import contextlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from digat_tpu.config import Config as JaxConfig
from digat_tpu.models.model import Model as JaxModel
from digat_tpu_torch.config import Config
from digat_tpu_torch.interop import load_jax_params
from digat_tpu_torch.models.model import Model

GEO = dict(
    dataset="synthetic", vocabulary_size=60, category_num=4, word_embedding_dim=24,
    MSA_head_num=4, MSA_head_dim=8, attention_dim=16, max_title_length=8,
    max_history_num=6, SAG_neighbors=3, SAG_hops=2, graph_depth=2,
)

@pytest.fixture
def one_thread():
    """One torch thread for the test, restored after: the suite runs its
    files in parallel processes, whose thread pools would otherwise
    oversubscribe the cores (two CLI runs side by side took 4.5 min each
    against 25 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element's magnitude: 2^(e - 8) for |t| in
    [2^(e-1), 2^e) (8 significant bits); an element of 0 takes that of the
    smallest normal."""
    a = t.float().abs().clamp(min=2.0 ** -126)
    _, e = torch.frexp(a)
    return torch.ldexp(torch.ones_like(a), e - 8)


# fp32 tolerances: one module against its JAX counterpart, and the whole
# two-stage scorer, where depth-2/3 compounding of summation order adds up
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)


def jax_config(**over):
    return JaxConfig(**{"use_pallas": False, **GEO, **over}).validate()


def port_config(**over):
    return Config(**{**GEO, **over}).validate()


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def models(seed: int = 0, **over):
    """(jax_model, jax_params, port_model on the CPU with the same params);
    `use_pallas` in `over` reaches the JAX model only."""
    jm = JaxModel(jax_config(**over))
    over.pop("use_pallas", None)
    params = jm.init(jax.random.PRNGKey(seed))
    # O(1)-scale embeddings like GloVe rows; topic embeddings nonzero so
    # the topic nodes take part in the user graph
    rng = np.random.default_rng(seed)
    params["graph_encoder"]["topic_node_embedding"] = rng.normal(
        size=params["graph_encoder"]["topic_node_embedding"].shape).astype(np.float32) * 0.5
    params = to_numpy(params)
    pm = load_jax_params(Model(port_config(**over), device="cpu"), params)
    return jm, params, pm


# ---------------------------------------------------------------------------
# compute_dtype bfloat16: the JAX package's kernel path (its Pallas kernels in
# interpret mode, as the TPU runs the kernels) against the port
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def jax_interpret():
    """The JAX package's Pallas kernels in interpret mode for the block, the
    flag restored after."""
    from digat_tpu.ops.pallas import runtime

    before = runtime.INTERPRET
    runtime.set_interpret(True)
    try:
        yield
    finally:
        runtime.set_interpret(before)


def bf16_models(seed: int = 0, **over):
    """`models` at compute_dtype bfloat16 with the JAX model on its kernel
    path (use_pallas; call it under `jax_interpret`): (jax_model, its fp32
    params as numpy, the port model with the same params)."""
    return models(seed, **{"compute_dtype": "bfloat16", "use_pallas": True, **over})


def corpus_arrays(rng, news_num: int, cfg):
    """Seeded corpus tables as numpy arrays (same layout as bench.py's)."""
    L, Gn = cfg.max_title_length, cfg.news_graph_size
    mask = rng.random((news_num, L)) < 0.8
    mask[1] = False  # an all-pad title
    return dict(
        news_title_text=rng.integers(0, cfg.vocabulary_size, (news_num, L)).astype(np.int32),
        news_title_mask=mask,
        news_node_id=rng.integers(0, news_num, (news_num, Gn)).astype(np.int32),
        news_graph=(rng.random((news_num, Gn, Gn)) < 0.3) | np.eye(Gn, dtype=bool),
        news_graph_mask=np.concatenate(
            [np.zeros((news_num, 1), bool), rng.random((news_num, Gn - 1)) < 0.9], axis=1),
    )


def impressions(rng, news_num: int, cfg, n_imp: int, per_imp: int):
    """Seeded histories (varying valid lengths, pads = news 0 / category C),
    candidates and 0/1 labels with a positive and a negative per impression."""
    H, C = cfg.max_history_num, cfg.category_num
    hist = rng.integers(1, news_num, (n_imp, H)).astype(np.int32)
    cat = rng.integers(0, C, (n_imp, H)).astype(np.int32)
    nvalid = rng.integers(0, H + 1, n_imp)
    for r, n in enumerate(nvalid):
        hist[r, n:] = 0
        cat[r, n:] = C
    imp_index = np.repeat(np.arange(n_imp), per_imp)
    cand = rng.integers(0, news_num, n_imp * per_imp).astype(np.int32)
    labels = (rng.random(n_imp * per_imp) < 0.3).astype(np.float32)
    labels[0::per_imp] = 1.0
    labels[1::per_imp] = 0.0
    return hist, cat, imp_index, cand, labels


def train_corpus(rng, cfg, news_num: int, rows: int, samples: int, dev_imps: int = 6):
    """A seeded corpus with the fields `digat_tpu_torch.train.trainer.Trainer`
    reads (those of `digat_tpu.data.corpus.Corpus`): the tables, a train
    split of `rows` behaviours with `samples` clicks and ragged non-clicks,
    and a dev split of `dev_imps` impressions of 4 candidates."""
    from types import SimpleNamespace

    arrays = corpus_arrays(rng, news_num, cfg)
    hist, cat, _, _, _ = impressions(rng, news_num, cfg, rows, 1)
    dev_hist, dev_cat, dev_imp, dev_cand, dev_labels = impressions(rng, news_num, cfg,
                                                                   dev_imps, 4)
    neg_len = rng.integers(1, 9, samples)
    return SimpleNamespace(
        tables=lambda: SimpleNamespace(**arrays),
        news_node_id=arrays["news_node_id"],
        splits={"train": SimpleNamespace(history_idx=hist, cat_idx=cat),
                "dev": SimpleNamespace(history_idx=dev_hist, cat_idx=dev_cat)},
        train_behavior_row=rng.integers(0, rows, samples),
        train_pos=rng.integers(1, news_num, samples).astype(np.int32),
        train_neg_flat=rng.integers(1, news_num, int(neg_len.sum())).astype(np.int32),
        train_neg_offsets=np.concatenate([[0], np.cumsum(neg_len)]),
        dev_imp_index=dev_imp, dev_cand=dev_cand, dev_labels=dev_labels,
    )


# ---------------------------------------------------------------------------
# the NRMS family: 4 heads of width 6 (D 24), L 12, history 10, M 3
# ---------------------------------------------------------------------------
NRMS_GEO = dict(
    dataset="synthetic", model_family="nrms", vocabulary_size=60, category_num=4,
    word_embedding_dim=24, nrms_head_num=4, nrms_head_dim=6, nrms_attention_dim=16,
    max_title_length=12, max_history_num=10, augmented_news_num=3,
)


def nrms_models(seed: int = 0, use_pallas: bool = False, **over):
    """(jax NRMSModel, its params as numpy, the port NRMSModel on the CPU
    with the same params)."""
    from digat_tpu.models.nrms import NRMSModel as JaxNRMS
    from digat_tpu_torch.models.nrms import NRMSModel

    geo = {**NRMS_GEO, **over}
    jm = JaxNRMS(JaxConfig(use_pallas=use_pallas, **geo).validate())
    params = to_numpy(jm.init(jax.random.PRNGKey(seed)))
    pm = load_jax_params(NRMSModel(Config(**geo).validate(), device="cpu"), params)
    return jm, params, pm


def nrms_arrays(rng, news_num: int, cfg):
    """Seeded NRMS tables as numpy arrays: news 0 the all-pad news, title
    lengths 0..L as valid prefixes, M augmented neighbours (0 = pad)."""
    L, M = cfg.max_title_length, cfg.augmented_news_num
    mask = np.arange(L)[None, :] < rng.integers(0, L + 1, (news_num, 1))
    mask[0] = False
    aug = rng.integers(0, news_num, (news_num, M)).astype(np.int32)
    aug[rng.random((news_num, M)) < 0.2] = 0
    return dict(
        news_title_text=rng.integers(1, cfg.vocabulary_size, (news_num, L)).astype(np.int32),
        news_title_mask=mask, augmented_news=aug)


def nrms_train_corpus(rng, cfg, news_num: int, rows: int, samples: int, dev_imps: int = 6):
    """`train_corpus` with the NRMS tables (`nrms_tables()`) beside the
    graph ones; every fifth history is all pad (a cold user)."""
    from types import SimpleNamespace

    corpus = train_corpus(rng, cfg, news_num, rows, samples, dev_imps)
    for split in corpus.splits.values():
        split.history_idx[::5] = 0
        split.cat_idx[::5] = cfg.category_num
    arrays = nrms_arrays(rng, news_num, cfg)
    corpus.nrms_tables = lambda: SimpleNamespace(**arrays)
    return corpus


def fp64_trajectory(corpus, steps: int = 30, lr: float = 1e-3, **over):
    """`steps` fp64, dropout-off training steps (clip 1.0, dedup batches) of
    the port's plain path and of the JAX train step from the same weights,
    for the model of `port_config(**over)` -> (max loss relative error, max
    parameter absolute error after the last step, mean of the first five
    losses, mean of the last five)."""
    import jax.numpy as jnp

    from digat_tpu.models.model import CorpusTables as JaxTables
    from digat_tpu.models.model import DedupTrainBatch as JaxDedupBatch
    from digat_tpu.train import optimizer as jax_optimizer
    from digat_tpu.train.train_step import make_train_step
    from digat_tpu_torch.data import batching, sampling
    from digat_tpu_torch.interop import params_from_model
    from digat_tpu_torch.models.model import CorpusTables
    from digat_tpu_torch.train.optimizer import Adam
    from digat_tpu_torch.train.train_step import train_step

    jm, params, pm = models(seed=0, dropout_rate=0.0, **over)
    pm = pm.double()
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    batches = [b for e in range(4) for b in batching.train_batches(
        corpus.splits["train"].history_idx, corpus.splits["train"].cat_idx,
        corpus.train_behavior_row, corpus.train_pos, neg, 8, epoch_seed=e,
        news_node_id=corpus.news_node_id, dedup_titles=512)][:steps]
    assert len(batches) == steps
    assert all(type(b).__name__ == "DedupTrainBatch" for b in batches)
    opt = Adam(pm.named_parameters(), 0.0, 1.0)
    raw = corpus.tables()
    tables = CorpusTables.from_arrays(raw, "cpu")
    fields = ("news_title_text", "news_title_mask", "news_node_id", "news_graph",
              "news_graph_mask")
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
        tx = jax_optimizer.make_optimizer(0.0, 1.0, p64)
        state = tx.init(p64)
        step = make_train_step(jm, tx)
        jt = JaxTables(*(jnp.asarray(getattr(raw, f)) for f in fields))
        jax_loss, port_loss = [], []
        for b in batches:
            p64, state, loss = step(p64, state, jt, JaxDedupBatch(*map(jnp.asarray, b)),
                                    jax.random.PRNGKey(0), lr)
            jax_loss.append(float(loss))
            port_loss.append(float(train_step(pm, opt, tables, batching.to_device(b, "cpu"),
                                              1, lr)))
        p64 = jax.tree.map(np.asarray, p64)
    jax_loss, port_loss = np.array(jax_loss), np.array(port_loss)
    rel = float((np.abs(port_loss - jax_loss) / np.abs(jax_loss)).max())
    param_err = max(float(np.abs(a - b).max()) for a, b in
                    zip(jax.tree.leaves(params_from_model(pm)), jax.tree.leaves(p64)))
    print(f"fp64 trajectory {over}: max loss rel {rel:.3e}, max param abs {param_err:.3e}, "
          f"loss {jax_loss[0]:.6f} -> {jax_loss[-1]:.6f}")
    return rel, param_err, float(jax_loss[:5].mean()), float(jax_loss[-5:].mean())


def bf16_eval_logits(seed: int = 0, xla: bool = False, **over):
    """Eval logits [B, 1 + K] of one seeded batch at compute_dtype bfloat16:
    (port, JAX kernel path, JAX XLA path or None). The JAX models compute on
    `cast_params`, the port on its compute copy."""
    import jax.numpy as jnp

    from digat_tpu.models.model import CorpusTables as JaxTables
    from digat_tpu.models.model import Model as JaxModel
    from digat_tpu.models.model import TrainBatch as JaxBatch
    from digat_tpu_torch.models.model import CorpusTables, TrainBatch

    jm, params, pm = bf16_models(seed, **over)
    cfg = jm.config
    rng = np.random.default_rng(seed + 5)
    arrays = corpus_arrays(rng, 30, cfg)
    B, H, C = 5, cfg.max_history_num, cfg.category_num
    hist = rng.integers(1, 30, (B, H)).astype(np.int32)
    cat = rng.integers(0, C, (B, H)).astype(np.int32)
    hist[0, 2:], cat[0, 2:] = 0, C
    sample = rng.integers(0, 30, (B, 1 + cfg.negative_sample_num)).astype(np.int32)
    weight = np.ones(B, np.float32)
    jt = JaxTables(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jb = JaxBatch(*map(jnp.asarray, (hist, cat, sample, weight)))
    key = jax.random.PRNGKey(0)
    with jax_interpret():
        want = np.asarray(jm.forward_indexed(jm.cast_params(params), jt, jb, key, train=False))
    xla_logits = None
    if xla:
        jx = JaxModel(jax_config(compute_dtype="bfloat16", **over))
        xla_logits = np.asarray(jx.forward_indexed(jx.cast_params(params), jt, jb, key,
                                                   train=False))
    pt = CorpusTables.from_arrays(SimpleNamespace(**arrays), "cpu")
    pb = TrainBatch(*(torch.from_numpy(a).long() for a in (hist, cat, sample)),
                    torch.from_numpy(weight))
    with torch.no_grad():
        got = pm.computing(pm.forward_indexed, pt, pb).numpy()
    return got, want, xla_logits


BATCH_FIELDS = ("news_title_text", "news_title_mask", "news_node_id", "news_graph",
                "news_graph_mask")


def bf16_step_case(seed: int = 0, **over):
    """One training step's inputs at compute_dtype bfloat16 and dropout 0:
    (jax model, its fp32 params, port model, JAX tables, JAX dedup batch
    with the sorted embedding-gradient metadata, port tables, port batch)."""
    import jax.numpy as jnp

    from digat_tpu.models.model import CorpusTables as JaxTables
    from digat_tpu.models.model import DedupTrainBatch as JaxDedupBatch
    from digat_tpu.ops.pallas.emb_grad import build_sorted_emb_meta
    from digat_tpu_torch.data import batching, sampling
    from digat_tpu_torch.models.model import CorpusTables

    jm, params, pm = bf16_models(seed, dropout_rate=0.0, **over)
    cfg = jm.config
    corpus = train_corpus(np.random.default_rng(seed + 1), cfg, 40, 30, 40)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(seed + 1))
    split = corpus.splits["train"]
    b = next(batching.train_batches(split.history_idx, split.cat_idx, corpus.train_behavior_row,
                                    corpus.train_pos, neg, 8, epoch_seed=0,
                                    news_node_id=corpus.news_node_id, dedup_titles=512))
    raw = corpus.tables()
    jt = JaxTables(*(jnp.asarray(getattr(raw, f)) for f in BATCH_FIELDS))
    emb = build_sorted_emb_meta(np.asarray(raw.news_title_text)[np.asarray(b.uniq_ids)],
                                cfg.vocabulary_size, ship_sort_arrays=False)
    jb = JaxDedupBatch(*map(jnp.asarray, b), emb=emb)
    return jm, params, pm, jt, jb, CorpusTables.from_arrays(raw, "cpu"), \
        batching.to_device(b, "cpu")
