"""Shared set-up for the port's CPU tests (no tests of its own).

Builds one small MSA-DIGAT configuration in both packages, the JAX
parameters from a seed, and the port model carrying those parameters via
`digat_tpu_torch.interop.load_jax_params`. Small widths keep every test
well under a minute: D 32, L 8, depth 2, Gn 6, H 6."""

import jax
import numpy as np

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

# fp32 tolerances: one module against its JAX counterpart, and the whole
# two-stage scorer, where depth-2/3 compounding of summation order adds up
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)


def jax_config(**over):
    return JaxConfig(use_pallas=False, **{**GEO, **over}).validate()


def port_config(**over):
    return Config(**{**GEO, **over}).validate()


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def models(seed: int = 0, **over):
    """(jax_model, jax_params, port_model on the CPU with the same params)."""
    jm = JaxModel(jax_config(**over))
    params = jm.init(jax.random.PRNGKey(seed))
    # O(1)-scale embeddings like GloVe rows; topic embeddings nonzero so
    # the topic nodes take part in the user graph
    rng = np.random.default_rng(seed)
    params["graph_encoder"]["topic_node_embedding"] = rng.normal(
        size=params["graph_encoder"]["topic_node_embedding"].shape).astype(np.float32) * 0.5
    params = to_numpy(params)
    pm = load_jax_params(Model(port_config(**over), device="cpu"), params)
    return jm, params, pm


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
