"""The port's MPNet sentence encoder (`digat_tpu_torch.plm.mpnet`) against
`digat_tpu.plm.mpnet` and HuggingFace's `MPNetModel` on the CPU, at 3
layers, 4 heads, hidden 48 (FFN 96, vocabulary 120, 40 positions), B 5,
L 17, titles of mixed length:

  * `encode` against the JAX `encode` on the same numpy weights carried
    across (`state_dict_from_jax`): fp32 within 2e-5 (the JAX suite's own
    tolerance against HuggingFace, tests/test_mpnet.py), and at
    compute_dtype bfloat16 within 2^-8 of the unit-norm embeddings (one
    bf16 ulp of an element below 1: a bf16 product may round to the
    neighbouring value where the two sum in another order);
  * `relative_position_bucket` equal to JAX's over relative positions
    -513 ... 513 (every bucket boundary of 514 positions);
  * a random `MPNetModel` state dict loads strictly (a stray or missing key
    raises; the pooler may be dropped) and the port's last hidden states
    match HuggingFace's within 2e-5;
  * the weight conversions both ways, and the embedder: routed by
    `data.sag.get_embedder("jax_mpnet", directory)` with the tokenizer
    stubbed, batch-size invariant, and an ImportError naming
    `transformers` where the package is missing."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.plm import mpnet as J
from digat_tpu_torch.data import sag
from digat_tpu_torch.plm import mpnet as P

CFG = P.MPNetConfig(vocab_size=120, hidden_size=48, num_layers=3, num_heads=4,
                    intermediate_size=96, max_position_embeddings=40)
BF16_TOL = 2.0 ** -8


def _weights(seed=0):
    """A HuggingFace-named state dict with every tensor random (biases and
    LayerNorms too, so that each term of the forward shows)."""
    rng = np.random.default_rng(seed)
    sd = P.random_state_dict(CFG, seed)
    for k, v in sd.items():
        if k.endswith("bias") or "LayerNorm" in k:
            sd[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
        else:
            sd[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return sd


def _batch(seed=1, B=5, L=17, vocab=120):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, L + 1, B)
    lengths[0] = L  # one title fills every position
    ids = rng.integers(4, vocab, (B, L)).astype(np.int64)
    mask = np.zeros((B, L), np.int64)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
        ids[i, n:] = P.PADDING_IDX
    return ids, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    params = J.convert_hf_state_dict(_weights())
    ids, mask = _batch()
    with jax.disable_jit():  # the op-by-op program: each op rounds at bf16
        want = np.asarray(J.encode(params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                                   compute_dtype=getattr(jnp, dtype)))
    got = P.encode(P.state_dict_from_jax(params), ids, mask, compute_dtype=dtype,
                   device="cpu").numpy()
    assert got.shape == (5, 48) and got.dtype == np.float32
    tol = 2e-5 if dtype == "float32" else BF16_TOL
    assert np.abs(got - want).max() <= tol
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_relative_position_bucket_equals_jax():
    rel = np.arange(-513, 514).reshape(1, -1)
    want = np.asarray(J.relative_position_bucket(jnp.asarray(rel)))
    got = P.relative_position_bucket(torch.tensor(rel)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == set(range(32)) - {16}  # n = 0 takes bucket 0


def test_weight_trees_convert_both_ways():
    sd = _weights(2)
    params = J.convert_hf_state_dict(sd)
    mine = P.convert_hf_state_dict(sd)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    back = P.state_dict_from_jax(params)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v)
    assert P.config_from_params(params) == P.config_from_state_dict(sd)
    assert vars(P.config_from_params(params)) == vars(J.config_from_params(params))


def _hf_model(seed=0, eps=CFG.layer_norm_eps):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.MPNetConfig(
        vocab_size=CFG.vocab_size, hidden_size=CFG.hidden_size,
        num_hidden_layers=CFG.num_layers, num_attention_heads=CFG.num_heads,
        intermediate_size=CFG.intermediate_size,
        max_position_embeddings=CFG.max_position_embeddings, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=eps)
    return transformers.MPNetModel(cfg, add_pooling_layer=True).eval()


def test_hf_state_dict_loads_strictly_and_matches_hf():
    hf = _hf_model()
    sd = hf.state_dict()
    assert any(k.startswith("pooler.") for k in sd)  # dropped, as it may be
    model = P.MPNet.from_state_dict(sd, device="cpu")
    assert model.config == CFG
    ids, mask = _batch(3)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)
                  ).last_hidden_state.numpy()
    got = P.hidden_states(model, ids, mask).numpy()
    assert np.abs(got - want).max() <= 2e-5
    with pytest.raises(RuntimeError, match="Unexpected"):
        P.MPNet(CFG, device="cpu").load_checkpoint({**sd, "encoder.extra": torch.zeros(2)})
    short = {k: v for k, v in sd.items() if k != "encoder.layer.1.output.dense.bias"}
    with pytest.raises(RuntimeError, match="Missing"):
        P.MPNet(CFG, device="cpu").load_checkpoint(short)


class StubTokenizer:
    """A tokenizer double: words -> ids from their text, padded to
    max_length with the pad id, as a HuggingFace tokenizer returns them."""

    def __call__(self, texts, padding=None, truncation=None, max_length=None,
                 return_tensors=None):
        assert padding == "max_length" and truncation and return_tensors == "np"
        ids = np.full((len(texts), max_length), P.PADDING_IDX, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            words = t.split()[:max_length] or ["<empty>"]
            ids[i, :len(words)] = [4 + sum(map(ord, w)) % 100 for w in words]
            mask[i, :len(words)] = 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.mark.parametrize("eps", [1e-5, 1e-12], ids=["all-mpnet-base-v2", "hf-default"])
def test_get_embedder_routes_jax_mpnet(tmp_path, monkeypatch, eps):
    """The checkpoint directory's model through the embedder equals
    HuggingFace's sentence embeddings (its LayerNorm eps read from the
    checkpoint)."""
    transformers = pytest.importorskip("transformers")
    hf = _hf_model(1, eps)
    hf.save_pretrained(tmp_path)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path: StubTokenizer()))
    embed = sag.get_embedder("jax_mpnet", str(tmp_path), device="cpu")
    texts = ["hello world", "breaking news story", "x", "a much longer title " * 4]
    out = embed(texts)
    assert out.shape == (4, 48) and out.dtype == np.float32
    toks = StubTokenizer()(texts, "max_length", True, 128, "np")
    with torch.no_grad():
        h = hf(input_ids=torch.tensor(toks["input_ids"]),
               attention_mask=torch.tensor(toks["attention_mask"])).last_hidden_state.numpy()
    m = toks["attention_mask"][:, :, None].astype(np.float64)
    pooled = (h * m).sum(1) / m.sum(1)
    pooled /= np.linalg.norm(pooled, axis=1, keepdims=True)
    assert np.abs(out - pooled).max() <= 2e-5


def test_mpnet_embedder_batches_and_lengths():
    model = P.MPNet.from_state_dict(_weights(4), device="cpu")
    texts = [" ".join(f"w{j}" for j in range(i % 9 + 1)) for i in range(11)]
    whole = P.mpnet_embedder(model, StubTokenizer(), max_length=12, batch_size=256)(texts)
    parts = P.mpnet_embedder(model, StubTokenizer(), max_length=12, batch_size=4)(texts)
    assert whole.shape == (11, 48)
    np.testing.assert_allclose(parts, whole, atol=1e-6)
    assert P.mpnet_embedder(model, StubTokenizer())([]).shape == (0, 48)


def test_loader_without_transformers_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        sag.get_embedder("jax_mpnet", "/nonexistent/checkpoint", device="cpu")


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.MPNet(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.encode(_weights(), *_batch())


def test_random_state_dict_follows_hf_init():
    sd = P.random_state_dict(P.MPNetConfig(vocab_size=2000, num_layers=1), seed=0)
    w = sd["encoder.layer.0.intermediate.dense.weight"]
    assert w.shape == (3072, 768) and abs(w.std() - 0.02) < 2e-4 and abs(w.mean()) < 1e-4
    assert not sd["embeddings.word_embeddings.weight"][P.PADDING_IDX].any()
    assert (sd["encoder.layer.0.output.LayerNorm.weight"] == 1).all()
    assert not sd["encoder.layer.0.attention.attn.q.bias"].any()
    np.testing.assert_array_equal(P.random_state_dict(CFG, 5)["embeddings.LayerNorm.weight"],
                                  np.ones(48, np.float32))
