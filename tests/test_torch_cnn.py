"""CNN-DIGAT against `digat_tpu` on the CPU: the convolution bank, the CNN
news encoder, the model's eval logits and its training trajectory.

  * the bank (`layers.ConvBank`) against `digat_tpu.layers.conv1d_bank` in
    fp64 within 1e-12 for naive (window 3, and an even window 4), group3
    (widths 1, 3, 5) and group5 (1 to 5: even widths take one more zero
    frame on the right), on kernels carried by the interop;
  * the CNN news encoder (word embedding, bank, ReLU, masked pool) in fp64
    within 1e-12, an all-pad title among them;
  * CNN-DIGAT's parameter tree both ways (the reference names
    `news_encoder.conv.conv*`) and its fp64 eval logits within 1e-12;
  * the configuration: the news vector is cnn_kernel_num wide, and the JAX
    package's checks of the method and of the width's divisibility;
  * a 30-step fp64, dropout-off training trajectory of CNN-DIGAT (dedup
    batches, so the embedding gradient is kernel D's plain version)
    against the JAX train step: loss <= 1e-9 relative, parameters <= 1e-7
    absolute;
  * in training the encoder draws two dropout sites (words, then the
    bank's output) with the same bits for the same seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import interop as jax_interop
from digat_tpu import layers as JL
from digat_tpu.models import news_encoders as JN
from digat_tpu.models.model import CorpusTables as JaxTables
from digat_tpu.models.model import TrainBatch as JaxTrainBatch
from digat_tpu_torch.config import Config
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.interop import params_from_model
from digat_tpu_torch.layers import ConvBank
from digat_tpu_torch.models import news_encoders as PN
from digat_tpu_torch.models.model import CorpusTables
from tests.test_torch_support import (fp64_trajectory, models, one_thread,  # noqa: F401
                                      port_config, train_corpus)

pytestmark = pytest.mark.usefixtures("one_thread")

CNN = dict(news_encoder="CNN", cnn_kernel_num=30)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.mark.parametrize("method,window", [("naive", 3), ("naive", 4), ("group3", 3),
                                           ("group5", 3)])
def test_conv_bank_matches_jax(method, window):
    rng = np.random.default_rng(len(method) + window)
    jp = JL.conv1d_bank_init(jax.random.PRNGKey(window), method, 12, 30, window)
    bank = ConvBank(method, 12, 30, window, torch.Generator().manual_seed(0)).double()
    with torch.no_grad():
        for name, conv in zip(bank.names, jp["convs"]):
            getattr(bank, name).weight.copy_(torch.from_numpy(np.asarray(conv["w"]).T.copy()))
            getattr(bank, name).bias.copy_(torch.from_numpy(np.array(conv["b"])))
    x = rng.normal(size=(5, 9, 12))
    with jax.enable_x64(True):
        want = np.asarray(JL.conv1d_bank(_f64(jp), jnp.asarray(x), method, window))
    got = bank(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (5, 9, 30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    x2 = rng.normal(size=(2, 3, 9, 12))  # any leading shape
    np.testing.assert_allclose(bank(torch.from_numpy(x2)).detach().numpy().reshape(6, 9, 30),
                               bank(torch.from_numpy(x2.reshape(6, 9, 12))).detach().numpy(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("method", ["naive", "group3", "group5"])
def test_cnn_news_encoder_matches_jax(method):
    jm, params, pm = models(seed=1, cnn_method=method, **CNN)
    pm = pm.double()
    cfg = jm.config
    rng = np.random.default_rng(2)
    text = rng.integers(0, cfg.vocabulary_size, (3, 4, cfg.max_title_length)).astype(np.int32)
    mask = rng.random(text.shape) < 0.7
    mask[0, 0] = False  # an all-pad title
    with jax.enable_x64(True):
        want = np.asarray(JN.encode(_f64(params)["news_encoder"], jm.news_st,
                                    jax.random.PRNGKey(0), False, jnp.asarray(text),
                                    jnp.asarray(mask)))
    with torch.inference_mode():
        got = pm.news_encoder(torch.from_numpy(text.astype(np.int64)),
                              torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (3, 4, 30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["naive", "group5"])
def test_cnn_digat_tree_and_eval_logits(method):
    jm, params, pm = models(seed=3, cnn_method=method, **CNN)
    names = set(pm.state_dict())
    conv = ["conv"] if method == "naive" else [f"conv{i}" for i in range(1, 6)]
    assert {f"news_encoder.conv.{c}.weight" for c in conv} <= names
    assert not any("multiheadSelfattention" in n for n in names)
    for back in (jax_interop.torch_to_params(pm.state_dict(), jm.config),
                 params_from_model(pm)):
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(a, b)
    pm = pm.double()
    corpus = train_corpus(np.random.default_rng(4), port_config(**CNN), 50, 10, 16)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    batch = next(batching.train_batches(
        corpus.splits["train"].history_idx, corpus.splits["train"].cat_idx,
        corpus.train_behavior_row, corpus.train_pos, neg, 8, epoch_seed=1))
    raw = corpus.tables()
    with torch.inference_mode():
        got = pm.forward_indexed(CorpusTables.from_arrays(raw, "cpu"),
                                 batching.to_device(batch, "cpu")).numpy()
    fields = ("news_title_text", "news_title_mask", "news_node_id", "news_graph",
              "news_graph_mask")
    with jax.enable_x64(True):
        jt = JaxTables(*(jnp.asarray(getattr(raw, f)) for f in fields))
        want = np.asarray(jm.forward_indexed(_f64(params), jt,
                                             JaxTrainBatch(*map(jnp.asarray, batch)),
                                             jax.random.PRNGKey(0), False))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_cnn_config():
    cfg = Config(news_encoder="CNN", cnn_kernel_num=400)
    assert cfg.news_embedding_dim == 400 and cfg.model_name == "CNN-DIGAT"
    assert Config().news_embedding_dim == 16 * 25
    for method, width in (("group3", 400), ("group5", 402)):
        with pytest.raises(ValueError, match="divisible"):
            Config(news_encoder="CNN", cnn_method=method, cnn_kernel_num=width).check_options()
    Config(news_encoder="CNN", cnn_method="group3", cnn_kernel_num=399).check_options()
    with pytest.raises(ValueError, match="cnn_method"):
        Config(news_encoder="CNN", cnn_method="group7").check_options()
    with pytest.raises(ValueError, match="news_encoder"):
        Config(news_encoder="LSTM").check_options()


def test_cnn_dropout_sites():
    """Training draws the words' mask under (seed, site) and the bank
    output's under (seed, site + CONV_SITE): the same seed gives the same
    bits, and dropout changes the result."""
    _, _, pm = models(seed=5, dropout_rate=0.2, **CNN)
    rng = np.random.default_rng(8)
    text = torch.from_numpy(rng.integers(0, 60, (6, 8)))
    mask = torch.from_numpy(rng.random((6, 8)) < 0.8)
    calls = []
    real = PN.dropout

    def recording(x, rate, seed, site):
        calls.append((tuple(x.shape), rate, seed, site))
        return real(x, rate, seed, site)

    PN.dropout = recording
    try:
        a = pm.news_encoder(text, mask, seed=7, site=1)
        b = pm.news_encoder(text, mask, seed=7, site=1)
    finally:
        PN.dropout = real
    assert calls[:2] == [((6, 8, 24), 0.2, 7, 1), ((6, 8, 30), 0.2, 7, 1 + PN.CONV_SITE)]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.inference_mode():
        assert not torch.allclose(a, pm.news_encoder(text, mask))


def test_fp64_training_trajectory_matches_jax():
    corpus = train_corpus(np.random.default_rng(0), port_config(**CNN), 60, 14, 75)
    rel, param_err, first, last = fp64_trajectory(corpus, **CNN)
    assert rel <= 1e-9
    assert param_err <= 1e-7
    assert last < first


def test_cli_trains_and_rescores_cnn_digat(tmp_path):
    """`digat_tpu_torch.cli --news_encoder CNN` on the CPU: one epoch on the
    synthetic corpus, the run under CNN-DIGAT, best.ckpt scored again by
    `--mode test` to the auto-test's metrics."""
    import os

    from digat_tpu_torch import cli
    from tests.test_torch_cli import _flags

    flags = _flags(str(tmp_path), "--epoch", "1", "--news_encoder", "CNN", "--cnn_kernel_num",
                   "30", "--cnn_method", "group3")
    rec = cli.main(flags)
    assert rec["run_dir"].endswith(os.path.join("synthetic", "CNN-DIGAT", "#1"))
    assert np.isfinite(rec["history"][0]["loss"]) and all(np.isfinite(rec["test"]))
    again = cli.main(flags + ["--mode", "test", "--test_model_path",
                              os.path.join(rec["run_dir"], "best.ckpt")])
    assert again == rec["test"]
