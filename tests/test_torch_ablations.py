"""The five DIGAT ablations and the vanilla GAT against `digat_tpu` on the CPU.

For each of wo_SA, Seq_SA, wo_interaction, news_graph_wo_inter and
user_graph_wo_inter (depth 2, D 32, on weights carried across by the
port's interop):

  * the parameter tree: the reference `state_dict` names (JAX's
    `torch_to_params` reads the port model back to the JAX tree exactly),
    `params_from_model` gives the same tree, and `load_jax_params` is
    strict;
  * fp64 eval logits of the dense forward within 1e-12 of the JAX model's;
  * the two-stage cached scorer in fp64: stage 1 (news reps and c_n0,
    node 0 for wo_SA) within 1e-12, stage 2's scores (both sides round them
    to fp32) within 1e-6 relative and in the same rank order;
  * the vanilla GAT layer alone (the additive a1 + a2 scores) in fp64
    within 1e-12, and its dropout sites (p/2 on x, p on alpha);
  * a 30-step fp64, dropout-off training trajectory against the JAX train
    step for wo_interaction and wo_SA: loss <= 1e-9 relative, parameters
    <= 1e-7 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import interop as jax_interop
from digat_tpu.eval.scorer import CachedScorer as JaxCachedScorer
from digat_tpu.models import graph_encoders as JG
from digat_tpu.models.model import CorpusTables as JaxTables
from digat_tpu.models.model import TrainBatch as JaxTrainBatch
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.eval.scorer import CachedScorer
from digat_tpu_torch.interop import load_jax_params, params_from_model
from digat_tpu_torch.layers import DropoutSites
from digat_tpu_torch.models.model import CorpusTables, Model
from tests.test_torch_support import (  # noqa: F401 (one_thread: the fixture)
    corpus_arrays, fp64_trajectory, impressions, models, one_thread, port_config, train_corpus)

pytestmark = pytest.mark.usefixtures("one_thread")

ABLATIONS = ("wo_SA", "Seq_SA", "wo_interaction", "news_graph_wo_inter", "user_graph_wo_inter")
TABLE_FIELDS = ("news_title_text", "news_title_mask", "news_node_id", "news_graph",
                "news_graph_mask")


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.fixture(scope="module")
def corpus():
    return train_corpus(np.random.default_rng(0), port_config(), 60, 14, 75)


@pytest.mark.parametrize("variant", ABLATIONS)
def test_parameter_tree_and_interop_both_ways(variant):
    jm, params, pm = models(seed=2, graph_encoder=variant)
    names = set(pm.state_dict())
    g = "graph_encoder"
    assert (f"{g}.candidate_attention.K.weight" in names) == (variant != "wo_SA")
    assert (f"{g}.news_graph_attention_W.0.weight" in names) == (variant not in ("wo_SA",
                                                                                 "Seq_SA"))
    vanilla_user = variant in ("wo_interaction", "user_graph_wo_inter")
    assert (f"{g}.user_graph_attention_a1.1.weight" in names) == vanilla_user
    assert (f"{g}.user_graph_attention_ffn3.1.bias" in names) == (not vanilla_user)
    for back in (jax_interop.torch_to_params(pm.state_dict(), jm.config),
                 params_from_model(pm)):
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(a, b)
    extra = jax.tree.map(np.array, params)
    extra["graph_encoder"]["news_ctx_unused"] = {"w": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError):
        load_jax_params(Model(port_config(graph_encoder=variant), device="cpu"), extra)


@pytest.mark.parametrize("variant", ABLATIONS)
def test_fp64_eval_logits_match_jax(variant, corpus):
    jm, params, pm = models(seed=3, graph_encoder=variant)
    pm = pm.double()
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    batch = next(batching.train_batches(
        corpus.splits["train"].history_idx, corpus.splits["train"].cat_idx,
        corpus.train_behavior_row, corpus.train_pos, neg, 8, epoch_seed=3))
    raw = corpus.tables()
    with torch.inference_mode():
        got = pm.forward_indexed(CorpusTables.from_arrays(raw, "cpu"),
                                 batching.to_device(batch, "cpu")).numpy()
    with jax.enable_x64(True):
        jt = JaxTables(*(jnp.asarray(getattr(raw, f)) for f in TABLE_FIELDS))
        want = np.asarray(jm.forward_indexed(_f64(params), jt,
                                             JaxTrainBatch(*map(jnp.asarray, batch)),
                                             jax.random.PRNGKey(0), False))
    assert got.shape == want.shape == (8, 5) and want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("variant", ABLATIONS)
def test_cached_scorer_stages_match_jax(variant):
    jm, params, pm = models(seed=4, graph_encoder=variant)
    pm = pm.double()
    cfg = jm.config
    rng = np.random.default_rng(12)
    arrays = corpus_arrays(rng, 37, cfg)
    hist, cat, imp_index, cand, _ = impressions(rng, 37, cfg, 9, 3)
    scorer = CachedScorer(pm, 8)
    with jax.enable_x64(True):
        jt = JaxTables(**{k: jnp.asarray(v) for k, v in arrays.items()})
        jscorer = JaxCachedScorer(jm, 8, mesh=False)
        p64 = _f64(params)
        j_reps, j_c0 = (np.asarray(a) for a in jscorer.cache_news(p64, jt))
        want = jscorer.score_items(p64, jt, hist, cat, imp_index, cand)
    reps, c0 = scorer.cache_news(jt)
    np.testing.assert_allclose(reps.numpy(), j_reps, rtol=0, atol=1e-12)
    np.testing.assert_allclose(c0.numpy(), j_c0, rtol=0, atol=1e-12)
    if variant == "wo_SA":  # c_n0 is the candidate's own representation
        np.testing.assert_array_equal(c0.numpy(), reps[torch.from_numpy(
            arrays["news_node_id"][:, 0].astype(np.int64))].numpy())
    got = scorer.score_items(jt, hist, cat, imp_index, cand)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    order = lambda s: [np.argsort(-g, kind="stable") for g in
                       np.split(s, np.flatnonzero(np.diff(imp_index)) + 1)]
    for a, b in zip(order(got), order(want)):
        np.testing.assert_array_equal(a, b)


def test_vanilla_gat_layer_matches_jax():
    """The vanilla layer alone in fp64 (news graph of wo_interaction): the
    additive scores, leaky ReLU, masked softmax over neighbours, relu of
    the aggregate and the residual; a row with no neighbour."""
    jm, params, pm = models(seed=5, graph_encoder="wo_interaction")
    pm = pm.double()
    rng = np.random.default_rng(6)
    B, G, D = 4, 7, jm.config.news_embedding_dim
    x = rng.normal(size=(B, G, D)) * 0.5
    adj = (rng.random((B, G, G)) < 0.4) | np.eye(G, dtype=bool)
    adj[1, 2] = False
    with torch.inference_mode():
        got = pm.graph_encoder.gat_layer("news_graph_attention", 1, torch.from_numpy(x),
                                         torch.from_numpy(adj), None).numpy()
    with jax.enable_x64(True):
        want = np.asarray(JG._gat_layer(_f64(params)["graph_encoder"]["news_gat"], 1,
                                        jm.graph_st, jax.random.PRNGKey(0), False,
                                        jnp.asarray(x), jnp.asarray(adj), None))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_vanilla_gat_layer_dropout_sites():
    """In training the vanilla layer draws two dropout sites, x at p/2 then
    alpha at p, as the interactive layer does; the same seed gives the same
    result."""
    _, _, pm = models(seed=5, graph_encoder="wo_interaction", dropout_rate=0.2)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 6, 32)).astype(np.float32))
    adj = torch.ones(3, 6, 6, dtype=torch.bool)
    outs = []
    for _ in range(2):
        drop = DropoutSites(11, 5)
        outs.append(pm.graph_encoder.gat_layer("user_graph_attention", 0, x, adj, None, drop))
        assert drop.next_site == 7
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with torch.inference_mode():
        plain = pm.graph_encoder.gat_layer("user_graph_attention", 0, x, adj, None)
    assert not torch.allclose(outs[0], plain)


@pytest.mark.parametrize("variant", ["wo_interaction", "wo_SA"])
def test_fp64_training_trajectory_matches_jax(variant, corpus):
    """30 steps (fp64, dropout off, clip 1.0, lr 1e-3, dedup batches) of the
    port's plain training path against the JAX train step."""
    rel, param_err, first, last = fp64_trajectory(corpus, graph_encoder=variant)
    assert rel <= 1e-9
    assert param_err <= 1e-7
    assert last < first  # the trajectory went somewhere


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ablations_cli"))


@pytest.mark.parametrize("variant", ABLATIONS)
def test_cli_trains_and_rescores_each_variant(cli_root, variant):
    """`digat_tpu_torch.cli --graph_encoder <variant>` on the CPU: one epoch
    on the synthetic corpus, the run's files under MSA-<variant>, and
    best.ckpt scored again by `--mode test` to the auto-test's metrics."""
    import os

    from digat_tpu_torch import cli
    from tests.test_torch_cli import _flags

    flags = _flags(cli_root, "--epoch", "1", "--graph_encoder", variant)
    rec = cli.main(flags)
    name = f"MSA-{variant}"
    assert rec["run_dir"] == os.path.join(cli_root, "runs", "synthetic", name, "#1")
    assert os.path.exists(os.path.join(cli_root, "runs", "results", "synthetic", name,
                                       "#1-test"))
    assert np.isfinite(rec["history"][0]["loss"]) and all(np.isfinite(rec["test"]))
    again = cli.main(flags + ["--mode", "test", "--test_model_path",
                              os.path.join(rec["run_dir"], "best.ckpt")])
    assert again == rec["test"]
