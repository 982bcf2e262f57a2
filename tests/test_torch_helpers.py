"""The port's smaller helpers against `digat_tpu` on the CPU:

  * `interop.load_torch_checkpoint` on a reference checkpoint file
    (`{model_name: state_dict}`), against `digat_tpu.interop.
    load_torch_checkpoint` on the same file: the fp64 eval logits of the two
    models within 1e-12 for MSA-DIGAT, and fp32 within 1e-5 of their scale
    for NRMS-SA (whose JAX model casts its logits to float32; its file also
    holds the reference's aliased `user_encoder.news_encoder.*` copies,
    dropped by both); a bare state_dict loads; a stray or missing tensor raises;
  * `data.sag.visualize_graph` writes the same bytes as the JAX package's;
  * `sorted_emb_grad=False`: a training step through `F.embedding` (the
    library's scatter-add for the word table's gradient) against the step
    through kernel D's route from the same weights, batch and seed: the
    same loss and every gradient within 1e-6 of its tensor's max (the
    word table's: the same sums in another order), kernel D's wrapper
    never called; and `--sorted_emb_grad false` parses into the field."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import interop as jax_interop
from digat_tpu.data import sag as jax_sag
from digat_tpu.models.model import CorpusTables as JaxTables
from digat_tpu.models.model import TrainBatch as JaxTrainBatch
from digat_tpu.models.nrms import NRMSTables as JaxNRMSTables
from digat_tpu_torch.config import Config
from digat_tpu_torch.data import batching, sag, sampling
from digat_tpu_torch.interop import NRMS_ALIAS, load_torch_checkpoint
from digat_tpu_torch.models.model import CorpusTables, Model
from digat_tpu_torch.models.nrms import NRMSTables
from digat_tpu_torch.ops import emb_grad as EG
from digat_tpu_torch.train.optimizer import Adam
from digat_tpu_torch.train.train_step import train_step
from tests.test_torch_support import (  # noqa: F401 (one_thread: the fixture)
    NRMS_GEO, models, nrms_arrays, nrms_models, one_thread, port_config, train_corpus)

pytestmark = pytest.mark.usefixtures("one_thread")

FIELDS = ("news_title_text", "news_title_mask", "news_node_id", "news_graph", "news_graph_mask")


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.fixture(scope="module")
def corpus():
    return train_corpus(np.random.default_rng(0), port_config(), 60, 14, 75)


def _batch(corpus, cfg, B=8, dedup=0, seed=3):
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                    cfg.negative_sample_num, np.random.default_rng(1))
    split = corpus.splits["train"]
    return next(batching.train_batches(
        split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg, B,
        epoch_seed=seed, news_node_id=corpus.news_node_id if dedup else None,
        dedup_titles=dedup))


def _checkpoint(path, name, state_dict, extra=None):
    torch.save({name: {**{k: v.clone() for k, v in state_dict.items()}, **(extra or {})}}, path)


def test_msa_digat_checkpoint_gives_the_jax_loaders_logits(tmp_path, corpus):
    jm, _, pm = models(seed=5)
    path = str(tmp_path / "ref.pt")
    _checkpoint(path, pm.config.model_name, pm.state_dict())
    params = jax_interop.load_torch_checkpoint(path, jm.config)
    got_model = load_torch_checkpoint(path, port_config(), device="cpu").double()
    batch = _batch(corpus, pm.config)
    raw = corpus.tables()
    with torch.inference_mode():
        got = got_model.forward_indexed(CorpusTables.from_arrays(raw, "cpu"),
                                        batching.to_device(batch, "cpu")).numpy()
    with jax.enable_x64(True):
        jt = JaxTables(*(jnp.asarray(getattr(raw, f)) for f in FIELDS))
        want = np.asarray(jm.forward_indexed(_f64(params), jt,
                                             JaxTrainBatch(*map(jnp.asarray, batch)),
                                             jax.random.PRNGKey(0), False))
    assert got.shape == want.shape == (8, 5) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # a bare state_dict loads into a given model; a stray or missing tensor raises
    bare = str(tmp_path / "bare.pt")
    torch.save(pm.state_dict(), bare)
    other = Model(port_config(), device="cpu", generator=torch.Generator().manual_seed(1))
    assert load_torch_checkpoint(bare, other) is other
    for k, v in pm.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    _checkpoint(path, pm.config.model_name, pm.state_dict(), {"news_encoder.extra": torch.ones(2)})
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_torch_checkpoint(path, port_config(), device="cpu")
    short = {k: v for k, v in pm.state_dict().items() if not k.endswith("user_news_Q.bias")}
    torch.save({pm.config.model_name: short}, path)
    with pytest.raises(RuntimeError, match="Missing"):
        load_torch_checkpoint(path, port_config(), device="cpu")


def test_nrms_sa_checkpoint_drops_the_aliased_keys(tmp_path):
    jm, _, pm = nrms_models(seed=6)
    sd = pm.state_dict()
    alias = {NRMS_ALIAS + k[len("news_encoder."):]: v for k, v in sd.items()
             if k.startswith("news_encoder.")}
    assert alias and not any(k.startswith(NRMS_ALIAS) for k in sd)
    path = str(tmp_path / "nrms.pt")
    _checkpoint(path, "NRMS-SA", sd, alias)
    params = jax_interop.load_torch_checkpoint(path, jm.config)
    cfg = Config(**NRMS_GEO).validate()
    got_model = load_torch_checkpoint(path, cfg, device="cpu")
    arrays = nrms_arrays(np.random.default_rng(2), 40, cfg)
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 40, (6, cfg.max_history_num)).astype(np.int32)
    batch = JaxTrainBatch(history_idx=hist, cat_idx=np.zeros_like(hist),
                          sample_idx=rng.integers(0, 40, (6, 5)).astype(np.int32),
                          weight=np.ones(6, np.float32))
    with torch.inference_mode():
        got = got_model.forward_indexed(NRMSTables.from_arrays(SimpleNamespace(**arrays), "cpu"),
                                        batching.to_device(batch, "cpu")).numpy()
    jt = JaxNRMSTables(*(jnp.asarray(arrays[f]) for f in JaxNRMSTables._fields))
    want = np.asarray(jm.forward_indexed(params, jt, JaxTrainBatch(*map(jnp.asarray, batch)),
                                         jax.random.PRNGKey(0), False))
    assert got.shape == want.shape == (6, 5) and np.abs(want).max() > 1e-3
    # fp32 (the JAX NRMS model casts its logits to float32): the module tolerance
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, float(np.abs(want).max()))


def test_visualize_graph_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(4)
    n, G = 6, 7
    node_id = rng.integers(0, n, (n, G)).astype(np.int32)
    graph = rng.random((n, G, G)) < 0.4
    titles = {i: f"title {i} é\tx" for i in range(1, n)}  # node 0 has none
    for index in (0, 3):
        sag.visualize_graph(str(tmp_path / "port.txt"), index, node_id, graph, titles)
        jax_sag.visualize_graph(str(tmp_path / "jax.txt"), index, node_id, graph, titles)
        assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("dedup", [0, 400], ids=["plain", "dedup"])
def test_scatter_add_word_gradient_step_equals_the_sorted_one(corpus, monkeypatch, dedup):
    calls = []
    plain = EG.embedding_grad
    monkeypatch.setattr(EG, "embedding_grad", lambda *a: calls.append(1) or plain(*a))
    cfg = port_config(dropout_rate=0.2)
    batch = batching.to_device(_batch(corpus, cfg, dedup=dedup), "cpu")
    tables = CorpusTables.from_arrays(corpus.tables(), "cpu")
    out = {}
    for sorted_grad in (True, False):
        model = Model(Config(**{**vars(cfg), "sorted_emb_grad": sorted_grad}), device="cpu",
                      generator=torch.Generator().manual_seed(7))
        assert model.news_encoder.sorted_emb_grad is sorted_grad
        opt = Adam(model.named_parameters(), cfg.weight_decay, cfg.gradient_clip_norm)
        before = len(calls)
        loss = float(train_step(model, opt, tables, batch, 11, cfg.lr))
        out[sorted_grad] = (loss, {n: p.grad.clone() for n, p in model.named_parameters()},
                            len(calls) - before)
    (l_d, g_d, n_d), (l_s, g_s, n_s) = out[True], out[False]
    # D once a news-encoder call (history and candidates apart, or the unique
    # titles once); the scatter-add route never
    assert (n_d, n_s) == ({0: 2, 400: 1}[dedup], 0)
    assert l_s == l_d
    for n, g in g_d.items():
        err = float((g_s[n] - g).abs().max())
        assert err <= 1e-6 * max(1.0, float(g.abs().max())), (n, err)
    assert float(g_d["news_encoder.word_embedding.weight"].abs().max()) > 0


def test_sorted_emb_grad_flag_parses_into_the_field():
    assert Config.from_args(["--sorted_emb_grad", "false"]).sorted_emb_grad is False
    assert Config.from_args([]).sorted_emb_grad is True
