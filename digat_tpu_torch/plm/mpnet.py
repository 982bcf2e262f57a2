"""The MPNet sentence encoder behind the pretrained SAG embedders.

Counterpart of `digat_tpu/plm/mpnet.py`: the frozen `all-mpnet-base-v2`
encoder that the reference mines the semantic-augmented news graph with,
as an `nn.Module` (`MPNet`) whose `state_dict` keeps HuggingFace's names,
so that a `transformers.MPNetModel` checkpoint loads into it directly, and
the sentence-transformers recipe on top (mean pool over the mask, then an
L2 normalisation). `encode` follows the JAX forward op by op:

  * RoBERTa position ids from `input_ids != 1` (the pad id), not from the
    mask: real tokens take cumsum + 1, pads stay at 1;
  * one relative-attention bias table [heads, L, L] shared by every layer,
    from T5-style bidirectional buckets (32 buckets, max distance 128);
  * the additive key mask (1 - mask) * finfo(float32).min, added in fp32
    after the scores;
  * post-LayerNorm residual blocks, erf GELU.

At `compute_dtype` bfloat16 it rounds where the JAX forward rounds: x after
each LayerNorm, the weights, each product of a bf16 x with a bf16 weight,
and the attention probabilities; the biases stay fp32, so every sum with
one is fp32, as JAX's type promotion makes it.

The products are plain `F.linear` and `einsum`: the JAX forward is plain
`jnp` and reaches no Pallas kernel. The entry points run on CUDA unless the
caller passes `device="cpu"` (TF32 off on the card). `transformers` is
imported only by `load_pretrained`, which reads a local checkpoint
directory; nothing is downloaded.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from digat_tpu_torch.runtime import exact_fp32, resolve_device

PADDING_IDX = 1  # MPNet's pad_token_id
NUM_BUCKETS = 32
MAX_DISTANCE = 128
INIT_STD = 0.02  # HuggingFace's initializer_range for MPNet
# the checkpoint keys that MPNet has no place for and may drop: the pooler
# (sentence-transformers pools itself) and the position-ids buffer
DROPPABLE = ("pooler.", "embeddings.position_ids")


@dataclass(frozen=True)
class MPNetConfig:
    vocab_size: int = 30527
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    layer_norm_eps: float = 1e-5


def _linear(d_in: int, d_out: int, device) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, d_in, d_out, device=device)


class _Attn(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.q, self.k, self.v, self.o = (_linear(d, d, device) for _ in range(4))


class _Attention(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.attn = _Attn(d, device)
        self.LayerNorm = nn.LayerNorm(d, device=device)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, device, layer_norm: bool = False):
        super().__init__()
        self.dense = _linear(d_in, d_out, device)
        if layer_norm:
            self.LayerNorm = nn.LayerNorm(d_out, device=device)


class _Layer(nn.Module):
    def __init__(self, cfg: MPNetConfig, device):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.attention = _Attention(d, device)
        self.intermediate = _Dense(d, f, device)
        self.output = _Dense(f, d, device, layer_norm=True)


class _Embeddings(nn.Module):
    def __init__(self, cfg: MPNetConfig, device):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.utils.skip_init(nn.Embedding, cfg.vocab_size, d, device=device)
        self.position_embeddings = nn.utils.skip_init(nn.Embedding, cfg.max_position_embeddings,
                                                      d, device=device)
        self.LayerNorm = nn.LayerNorm(d, device=device)


class _Encoder(nn.Module):
    def __init__(self, cfg: MPNetConfig, device):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg, device) for _ in range(cfg.num_layers))
        self.relative_attention_bias = nn.utils.skip_init(nn.Embedding, NUM_BUCKETS,
                                                          cfg.num_heads, device=device)


class MPNet(nn.Module):
    """The MPNet encoder's weights under HuggingFace's `MPNetModel` names
    (`embeddings.word_embeddings.weight`, `encoder.layer.{i}.attention.
    attn.q.weight`, ..., `encoder.relative_attention_bias.weight`). Built
    uninitialised on `device` (CUDA unless the caller names one): fill it
    with `load_checkpoint` or build it with `from_state_dict`."""

    def __init__(self, cfg: MPNetConfig = MPNetConfig(), device=None):
        super().__init__()
        device = resolve_device(device)
        if device.type == "cuda":
            exact_fp32()
        self.config = cfg
        self.embeddings = _Embeddings(cfg, device)
        self.encoder = _Encoder(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embeddings.word_embeddings.weight.device

    def load_checkpoint(self, state_dict: Mapping) -> "MPNet":
        """Load an `MPNetModel` state dict (tensors or numpy arrays) with
        strict accounting: every parameter filled, and nothing left over
        but the pooler and the position-ids buffer."""
        sd = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
              for k, v in state_dict.items() if not k.startswith(DROPPABLE)}
        self.load_state_dict(sd, strict=True)
        return self

    @classmethod
    def from_state_dict(cls, state_dict: Mapping, device=None,
                        layer_norm_eps: float = MPNetConfig.layer_norm_eps) -> "MPNet":
        """An MPNet of the state dict's widths holding its weights."""
        cfg = replace(config_from_state_dict(state_dict), layer_norm_eps=layer_norm_eps)
        return cls(cfg, device).load_checkpoint(state_dict)


# ---------------------------------------------------------------------------
# Weights: HuggingFace state dict <-> the JAX package's parameter tree
# ---------------------------------------------------------------------------

def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def config_from_state_dict(state_dict: Mapping) -> MPNetConfig:
    """The widths of an `MPNetModel` state dict."""
    shape = lambda k: tuple(state_dict[k].shape)
    depth = 0
    while f"encoder.layer.{depth}.attention.attn.q.weight" in state_dict:
        depth += 1
    V, D = shape("embeddings.word_embeddings.weight")
    return MPNetConfig(
        vocab_size=V, hidden_size=D, num_layers=depth,
        num_heads=shape("encoder.relative_attention_bias.weight")[1],
        intermediate_size=shape("encoder.layer.0.intermediate.dense.weight")[0],
        max_position_embeddings=shape("embeddings.position_embeddings.weight")[0])


# (JAX tree name, HuggingFace prefix of layer i) for the per-layer stacks
_LAYER_LINEARS = (("q", "attention.attn.q"), ("k", "attention.attn.k"),
                  ("v", "attention.attn.v"), ("o", "attention.attn.o"),
                  ("ffn1", "intermediate.dense"), ("ffn2", "output.dense"))
_LAYER_NORMS = (("attn_ln", "attention.LayerNorm"), ("out_ln", "output.LayerNorm"))


def convert_hf_state_dict(state: Mapping) -> dict:
    """HuggingFace `MPNetModel.state_dict()` -> the JAX package's parameter
    tree (numpy): linear weights transposed to [d_in, d_out], per-layer
    tensors stacked on a leading depth axis."""
    g = {k: _numpy(v) for k, v in state.items()}
    depth = config_from_state_dict(g).num_layers
    stack = lambda key: np.stack([g[key.format(i)] for i in range(depth)])
    layers = {}
    for name, prefix in _LAYER_LINEARS:
        layers[name] = {"w": np.stack([g[f"encoder.layer.{i}.{prefix}.weight"].T
                                       for i in range(depth)]),
                        "b": stack(f"encoder.layer.{{}}.{prefix}.bias")}
    for name, prefix in _LAYER_NORMS:
        layers[name] = {"scale": stack(f"encoder.layer.{{}}.{prefix}.weight"),
                        "bias": stack(f"encoder.layer.{{}}.{prefix}.bias")}
    return {
        "word_embeddings": g["embeddings.word_embeddings.weight"].copy(),
        "position_embeddings": g["embeddings.position_embeddings.weight"].copy(),
        "emb_ln": {"scale": g["embeddings.LayerNorm.weight"].copy(),
                   "bias": g["embeddings.LayerNorm.bias"].copy()},
        "rel_bias": g["encoder.relative_attention_bias.weight"].copy(),
        "layers": layers,
    }


def state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's parameter tree (numpy arrays) -> a HuggingFace-named
    state dict: the [d_in, d_out] weights transposed back and the depth
    axis unstacked."""
    p = lambda x: np.asarray(x)
    sd = {"embeddings.word_embeddings.weight": p(params["word_embeddings"]),
          "embeddings.position_embeddings.weight": p(params["position_embeddings"]),
          "embeddings.LayerNorm.weight": p(params["emb_ln"]["scale"]),
          "embeddings.LayerNorm.bias": p(params["emb_ln"]["bias"]),
          "encoder.relative_attention_bias.weight": p(params["rel_bias"])}
    lp = params["layers"]
    depth = np.shape(lp["q"]["w"])[0]
    for i in range(depth):
        for name, prefix in _LAYER_LINEARS:
            sd[f"encoder.layer.{i}.{prefix}.weight"] = p(lp[name]["w"][i]).T.copy()
            sd[f"encoder.layer.{i}.{prefix}.bias"] = p(lp[name]["b"][i])
        for name, prefix in _LAYER_NORMS:
            sd[f"encoder.layer.{i}.{prefix}.weight"] = p(lp[name]["scale"][i])
            sd[f"encoder.layer.{i}.{prefix}.bias"] = p(lp[name]["bias"][i])
    return sd


def config_from_params(params: Mapping) -> MPNetConfig:
    """The widths of the JAX package's parameter tree."""
    V, D = np.shape(params["word_embeddings"])
    depth, _, _ = np.shape(params["layers"]["q"]["w"])
    return MPNetConfig(
        vocab_size=V, hidden_size=D, num_layers=depth,
        num_heads=np.shape(params["rel_bias"])[1],
        intermediate_size=np.shape(params["layers"]["ffn1"]["w"])[2],
        max_position_embeddings=np.shape(params["position_embeddings"])[0])


def random_state_dict(cfg: MPNetConfig = MPNetConfig(), seed: int = 0) -> Dict[str, np.ndarray]:
    """A HuggingFace-named state dict of random weights at HuggingFace's
    initial law (weights and embeddings N(0, 0.02), the pad row 0, biases
    0, LayerNorms 1 and 0), drawn with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    normal = lambda *shape: (rng.standard_normal(shape, np.float32) * np.float32(INIT_STD))
    D, Fd = cfg.hidden_size, cfg.intermediate_size
    word = normal(cfg.vocab_size, D)
    word[PADDING_IDX] = 0.0
    sd = {"embeddings.word_embeddings.weight": word,
          "embeddings.position_embeddings.weight": normal(cfg.max_position_embeddings, D),
          "embeddings.LayerNorm.weight": np.ones(D, np.float32),
          "embeddings.LayerNorm.bias": np.zeros(D, np.float32),
          "encoder.relative_attention_bias.weight": normal(NUM_BUCKETS, cfg.num_heads)}
    shapes = {"q": (D, D), "k": (D, D), "v": (D, D), "o": (D, D), "ffn1": (Fd, D),
              "ffn2": (D, Fd)}
    for i in range(cfg.num_layers):
        for name, prefix in _LAYER_LINEARS:
            out, inp = shapes[name]
            sd[f"encoder.layer.{i}.{prefix}.weight"] = normal(out, inp)
            sd[f"encoder.layer.{i}.{prefix}.bias"] = np.zeros(out, np.float32)
        for _, prefix in _LAYER_NORMS:
            sd[f"encoder.layer.{i}.{prefix}.weight"] = np.ones(D, np.float32)
            sd[f"encoder.layer.{i}.{prefix}.bias"] = np.zeros(D, np.float32)
    return sd


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = NUM_BUCKETS,
                             max_distance: int = MAX_DISTANCE) -> torch.Tensor:
    """T5-style bidirectional bucketing (HuggingFace's
    `MPNetEncoder.relative_position_bucket`, JAX's `mpnet.py:119-135`). The
    log is taken in float32, as both take it: a bucket boundary (|n| 16,
    32, 64, 128) moves if it is taken in float64. |n| below max_exact is
    clamped before the log, so that log(0) never reaches the integer cast
    (its bucket is |n| itself)."""
    n = -relative_position
    num_buckets //= 2
    ret = (n < 0).to(torch.long) * num_buckets
    n = n.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = n.clamp(min=max_exact).to(torch.float32)
    val_if_large = max_exact + (torch.log(large / max_exact) / math.log(max_distance / max_exact)
                                * (num_buckets - max_exact)).to(torch.long)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def position_bias(model: MPNet, L: int) -> torch.Tensor:
    """The relative-attention bias [heads, L, L] that every layer adds. The
    buckets are computed on the CPU, so that the card and the CPU take the
    same float32 logs."""
    pos = torch.arange(L)
    bucket = relative_position_bucket(pos[None, :] - pos[:, None])  # memory - context
    table = model.encoder.relative_attention_bias.weight
    return table[bucket.to(table.device)].permute(2, 0, 1)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * ln.weight + ln.bias


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """x @ W.astype(dtype) + b as JAX forms it: the product in the dtype x
    and the cast weight promote to (a bf16 x with a bf16 weight rounds to
    bf16), then the fp32 bias added (the sum fp32)."""
    w = lin.weight.to(dtype)
    common = torch.promote_types(x.dtype, w.dtype)
    return F.linear(x.to(common), w.to(common)) + lin.bias


def _promoted(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a and b in their promoted dtype, as JAX's einsum promotes them."""
    common = torch.promote_types(a.dtype, b.dtype)
    return a.to(common), b.to(common)


def _as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _as_model(model_or_state_dict, device) -> MPNet:
    if isinstance(model_or_state_dict, MPNet):
        return model_or_state_dict
    return MPNet.from_state_dict(model_or_state_dict, device)


def _as_tensor(x, dev, dtype) -> torch.Tensor:
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x)).to(dev, dtype)


@torch.no_grad()
def hidden_states(model: MPNet, input_ids, attention_mask,
                  compute_dtype: Union[str, torch.dtype] = torch.float32) -> torch.Tensor:
    """The last layer's states [B, L, hidden] in `compute_dtype` (every
    position, pads included), on the model's device: input_ids [B, L] int,
    attention_mask [B, L] {0, 1}."""
    cfg, dev, dtype = model.config, model.device, _as_dtype(compute_dtype)
    eps, H = cfg.layer_norm_eps, cfg.num_heads
    Dh = cfg.hidden_size // H
    ids = _as_tensor(input_ids, dev, torch.long)
    mask = _as_tensor(attention_mask, dev, torch.float32)
    B, L = ids.shape

    # RoBERTa position ids: pads stay at the padding index
    m = (ids != PADDING_IDX).to(torch.long)
    pos_ids = torch.cumsum(m, dim=1) * m + PADDING_IDX
    emb = model.embeddings
    x = emb.word_embeddings.weight[ids] + emb.position_embeddings.weight[pos_ids]
    x = _layer_norm(emb.LayerNorm, x, eps).to(dtype)

    # the additive key mask, HuggingFace's (1 - mask) * finfo.min, beside the bias
    neg = torch.finfo(torch.float32).min
    extra = (position_bias(model, L)[None] + (1.0 - mask)[:, None, None, :] * neg).float()

    for layer in model.encoder.layer:
        att = layer.attention.attn
        q, k, v = (_dense(x, lin, dtype).reshape(B, L, H, Dh) for lin in (att.q, att.k, att.v))
        s = torch.einsum("bqhd,bkhd->bhqk", *_promoted(q, k)) / math.sqrt(Dh)
        a = torch.softmax(s.float() + extra, dim=-1).to(dtype)
        c = torch.einsum("bhqk,bkhd->bqhd", *_promoted(a, v)).reshape(B, L, H * Dh)
        o = _dense(c, att.o, dtype)
        x = _layer_norm(layer.attention.LayerNorm, (o + x).float(), eps).to(dtype)
        h = F.gelu(_dense(x, layer.intermediate.dense, dtype), approximate="none")
        y = _dense(h, layer.output.dense, dtype)
        x = _layer_norm(layer.output.LayerNorm, (y + x).float(), eps).to(dtype)
    return x


@torch.no_grad()
def encode(model_or_state_dict, input_ids, attention_mask,
           compute_dtype: Union[str, torch.dtype] = torch.float32, device=None) -> torch.Tensor:
    """input_ids [B, L] int, attention_mask [B, L] {0, 1} -> L2-normalised
    sentence embeddings [B, hidden] float32 (the sentence-transformers mean
    pool over the mask and normalisation), on the model's device.
    `model_or_state_dict`: an `MPNet`, or a HuggingFace-named state dict
    (`state_dict_from_jax` makes one of the JAX package's tree), loaded onto
    `device` (CUDA unless the caller names one)."""
    model = _as_model(model_or_state_dict, device)
    x = hidden_states(model, input_ids, attention_mask, compute_dtype).float()
    mask = _as_tensor(attention_mask, model.device, torch.float32)
    summed = torch.einsum("bld,bl->bd", x, mask)
    counts = mask.sum(dim=1, keepdim=True).clamp(min=1e-9)
    pooled = summed / counts
    return pooled / pooled.norm(dim=1, keepdim=True).clamp(min=1e-12)


# ---------------------------------------------------------------------------
# Corpus-sweep embedder (the SAG miner's `jax_mpnet` route)
# ---------------------------------------------------------------------------

def mpnet_embedder(model: MPNet, tokenizer: Callable, max_length: int = 128,
                   batch_size: int = 256,
                   compute_dtype: Union[str, torch.dtype] = torch.float32) -> Callable:
    """An embedder over `model` on its device: texts -> [n, hidden] float32
    numpy embeddings, `batch_size` texts a batch, each tokenised by
    `tokenizer` (a HuggingFace tokenizer or any callable of its signature)
    to `max_length` tokens, padded to it and truncated."""

    def embed(texts: Sequence[str], dim: int = 0) -> np.ndarray:
        texts = list(texts)
        out = [np.zeros((0, model.config.hidden_size), np.float32)]
        for lo in range(0, len(texts), batch_size):
            toks = tokenizer(texts[lo:lo + batch_size], padding="max_length", truncation=True,
                             max_length=max_length, return_tensors="np")
            out.append(encode(model, toks["input_ids"], toks["attention_mask"],
                              compute_dtype).cpu().numpy())
        return np.concatenate(out, axis=0)

    return embed


def load_pretrained(model_path: str, device=None) -> Tuple[MPNet, Callable]:
    """(MPNet, tokenizer) from a local HuggingFace checkpoint directory
    (config, weights and tokenizer; nothing is downloaded), the weights on
    `device` (CUDA unless the caller names one). `transformers` only reads
    the checkpoint; it is imported here and nowhere else in the package."""
    try:
        from transformers import AutoTokenizer, MPNetModel
    except ImportError as e:
        raise ImportError(
            f"sag_embedder='jax_mpnet' reads the MPNet checkpoint {model_path} through the "
            f"transformers package, which is not installed; install it or use "
            f"sag_embedder='hash'") from e
    tokenizer = AutoTokenizer.from_pretrained(model_path)
    hf = MPNetModel.from_pretrained(model_path)
    # the checkpoint's own LayerNorm eps (all-mpnet-base-v2's is 1e-5, which
    # the JAX package takes for every checkpoint)
    model = MPNet.from_state_dict(hf.state_dict(), device, hf.config.layer_norm_eps)
    del hf
    return model, tokenizer


def pretrained_embedder(model_path: str, max_length: int = 128, batch_size: int = 256,
                        compute_dtype: Union[str, torch.dtype] = torch.float32,
                        device=None) -> Callable:
    """The `jax_mpnet` embedder: `load_pretrained` then `mpnet_embedder`."""
    model, tokenizer = load_pretrained(model_path, device)
    return mpnet_embedder(model, tokenizer, max_length, batch_size, compute_dtype)
