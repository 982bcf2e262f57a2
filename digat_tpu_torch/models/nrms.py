"""NRMS / NRMS-SA model family (the reference's Appendix-B capability).

Counterpart of `digat_tpu.models.nrms` (`NRMSModel._encode_titles`,
`_fuse_sa`, `encode_news`, `encode_user`, `forward_indexed`, `loss_parts`,
`loss`, and `NRMSTables`): the semantic-augmentation strategy on a pure
sequence model, no graphs.

  * title tower: word embedding -> dropout -> masked multi-head
    self-attention -> dropout -> masked tanh-MLP attention pool;
  * NRMS-SA: the same tower also encodes the M augmented neighbour titles
    of each news, attends over them with the news's own representation as
    the query, and fuses both through a sigmoid gate (dropout p/2 on the
    gate logits);
  * user tower: masked multi-head self-attention over the H history
    representations, then an unmasked attention pool, as the reference;
  * dot-product logits and the listwise loss of the DIGAT family.

Both attentions run the kernel pair of `ops.msa_attention` (`layers.mha`).
Parameters keep the reference's `state_dict` names (`news_encoder.
word_embedding`, `news_encoder.multiheadAttention.W_{Q,K,V}`,
`news_encoder.attention.affine{1,2}`, `user_encoder.multiheadAttention`,
`user_encoder.attention`, `news_encoder.SA_attention.{K,Q}`,
`news_encoder.SA_transformation`), so `digat_tpu.interop.
torch_to_nrms_params` reads a port model directly. With a `seed` the
forward is the training forward: dropout at 7 sites for NRMS-SA (word
embedding and attention output of each of the three title-tower calls, and
the gate logits) and 4 for NRMS, each under its own site number.

At `compute_dtype` bfloat16 the loss and both scorer stages run on a bf16
compute copy of the weights (`ComputeCopy`, as the DIGAT family's `Model`),
the word table kept fp32 and its gathered rows cast to bf16, as the JAX
model's cast table gives them. The title tower then runs in bf16 up to the
attention pair: the word dropout (A''s bf16 instance), the projections
(`layers.linear`) and the pair's bf16 instance, whose output is cast to
fp32 (`layers.mha`) for the second dropout and the pool. The fusion and the
user tower take fp32 representations times bf16 weights, promoted to fp32,
so the user tower runs the fp32 pair, as in the JAX package."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from digat_tpu_torch.config import Config
from digat_tpu_torch.layers import (
    EVAL,
    AttentionPool,
    DropoutSites,
    MultiHeadAttention,
    ScaledDotProductAttention,
    attn_pool,
    linear,
    make_linear,
    sdp_attn,
)
from digat_tpu_torch.models.model import ComputeCopy, as_device_tensor, set_word_embedding
from digat_tpu_torch.parallel.sharded_table import lookup, shard_word_table
from digat_tpu_torch.runtime import exact_fp32, resolve_device


class NRMSTables(NamedTuple):
    """Corpus arrays of the NRMS family on the model's device."""

    news_title_text: torch.Tensor  # [news_num, L] int64
    news_title_mask: torch.Tensor  # [news_num, L] bool
    augmented_news: torch.Tensor  # [news_num, M] int64 (0-padded)

    @classmethod
    def from_arrays(cls, tables, device) -> "NRMSTables":
        """Any object with the three fields (numpy arrays or tensors) ->
        NRMSTables on `device`. Raises without `augmented_news`, as the JAX
        corpus does."""
        if getattr(tables, "augmented_news", None) is None:
            raise ValueError("augmented-news artifact missing; preprocess with "
                             "model_family='nrms'")

        put = lambda x, dtype: as_device_tensor(x, device, dtype)
        return cls(news_title_text=put(tables.news_title_text, torch.int64),
                   news_title_mask=put(tables.news_title_mask, torch.bool),
                   augmented_news=put(tables.augmented_news, torch.int64))


class NRMSNewsEncoder(nn.Module):
    def __init__(self, vocab_size: int, word_dim: int, heads: int, head_dim: int,
                 attention_dim: int, sa: bool, generator: torch.Generator):
        super().__init__()
        g = generator
        dim = heads * head_dim
        self.word_embedding = nn.utils.skip_init(nn.Embedding, vocab_size, word_dim)
        with torch.no_grad():
            self.word_embedding.weight.normal_(generator=g)
        self.multiheadAttention = MultiHeadAttention(heads, word_dim, head_dim, head_dim, g)
        self.attention = AttentionPool(dim, attention_dim, g)
        if sa:
            self.SA_attention = ScaledDotProductAttention(dim, dim, dim, g)
            self.SA_transformation = make_linear(2 * dim, dim, g, init="xavier",
                                                 bias_init="zeros")


class NRMSUserEncoder(nn.Module):
    def __init__(self, heads: int, head_dim: int, attention_dim: int,
                 generator: torch.Generator):
        super().__init__()
        dim = heads * head_dim
        self.multiheadAttention = MultiHeadAttention(heads, dim, head_dim, head_dim, generator)
        self.attention = AttentionPool(dim, attention_dim, generator)


class NRMSModel(ComputeCopy, nn.Module):
    """NRMS or NRMS-SA (`config.nrms_model`). Runs on CUDA unless `device`
    names another device; with no device and no CUDA it raises.
    `word_embedding` (numpy [V, word_dim]), if given, replaces the drawn
    word table. With `dist` on a grid of `mesh_model` M > 1 ranks, the
    model holds its model index's rows of the table, as `Model` does; their
    gradient is the library's scatter-add, as `F.embedding`'s is for the
    whole table."""

    family = "nrms"

    def __init__(self, config: Config, device=None, generator: Optional[torch.Generator] = None,
                 word_embedding=None, dist=None):
        super().__init__()
        config.validate()
        device = resolve_device(device)
        exact_fp32()
        self.config = config
        self.sa = config.nrms_model == "NRMS-SA"
        self.model_name = config.nrms_model
        self.heads = config.nrms_head_num
        self.dim = config.nrms_head_num * config.nrms_head_dim
        self.dropout_rate = config.dropout_rate
        g = generator if generator is not None else torch.Generator().manual_seed(config.seed)
        self.news_encoder = NRMSNewsEncoder(
            config.vocabulary_size, config.word_embedding_dim, config.nrms_head_num,
            config.nrms_head_dim, config.nrms_attention_dim, self.sa, g)
        self.user_encoder = NRMSUserEncoder(config.nrms_head_num, config.nrms_head_dim,
                                            config.nrms_attention_dim, g)
        set_word_embedding(self.news_encoder, word_embedding)
        shard_word_table(self.news_encoder, dist)
        self.to(device)
        self.device = device
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self._computing = False  # inside `computing`: the compute copy is in place

    # ------------------------------------------------------------------
    def encode_titles(self, title_text: torch.Tensor, title_mask: torch.Tensor,
                      drop: DropoutSites = EVAL) -> torch.Tensor:
        """The shared title tower: [..., L] -> [..., D]."""
        ne, p = self.news_encoder, self.dropout_rate
        lead, L = title_text.shape[:-1], title_text.shape[-1]
        w = lookup(ne.word_embedding, title_text.reshape(-1, L), sorted_grad=False)
        w = drop(w.to(ne.multiheadAttention.W_Q.weight.dtype), p)
        mask = title_mask.reshape(-1, L).to(torch.bool)
        c = drop(ne.multiheadAttention(w, mask), p)
        return attn_pool(ne.attention, c, mask).reshape(*lead, self.dim)

    def fuse_sa(self, original: torch.Tensor, augmented: torch.Tensor,
                drop: DropoutSites = EVAL) -> torch.Tensor:
        """original [..., D]; augmented [..., M, D] -> the gated fusion."""
        ne = self.news_encoder
        att = sdp_attn(ne.SA_attention, augmented, original)
        logits = linear(torch.cat([original, att], dim=-1), ne.SA_transformation)
        gate = torch.sigmoid(drop(logits, self.dropout_rate / 2))
        return gate * original + (1.0 - gate) * att

    def encode_news(self, title_text, title_mask, aug_title_text=None, aug_title_mask=None,
                    drop: DropoutSites = EVAL) -> torch.Tensor:
        """[..., L] titles (+ [..., M, L] augmented ones for NRMS-SA) ->
        [..., D]."""
        rep = self.encode_titles(title_text, title_mask, drop)
        if self.sa and aug_title_text is not None:
            aug = self.encode_titles(aug_title_text, aug_title_mask, drop)
            rep = self.fuse_sa(rep, aug, drop)
        return rep

    def encode_user(self, history_reps: torch.Tensor, history_mask: torch.Tensor):
        """[B, H, D] history representations -> [B, D]: masked MHA, then the
        reference's unmasked pool."""
        ue = self.user_encoder
        return attn_pool(ue.attention, ue.multiheadAttention(history_reps, history_mask))

    # ------------------------------------------------------------------
    def forward_indexed(self, tables: NRMSTables, batch, seed: Optional[int] = None):
        """tables: NRMSTables; batch: a TrainBatch (its cat_idx unused) ->
        logits [B, 1+K]. With a `seed` the training forward."""
        drop = DropoutSites(seed)
        aug_text = aug_mask = None
        if self.sa:
            aug_ids = tables.augmented_news[batch.sample_idx]  # [B, N, M]
            aug_text, aug_mask = tables.news_title_text[aug_ids], tables.news_title_mask[aug_ids]
        news_rep = self.encode_news(tables.news_title_text[batch.sample_idx],
                                    tables.news_title_mask[batch.sample_idx], aug_text, aug_mask,
                                    drop)  # [B, N, D]
        hist_rep = self.encode_titles(tables.news_title_text[batch.history_idx],
                                      tables.news_title_mask[batch.history_idx], drop)
        user_rep = self.encode_user(hist_rep, batch.history_idx != 0)  # pad news id 0
        return torch.einsum("bnd,bd->bn", news_rep, user_rep)

    def loss_parts(self, tables: NRMSTables, batch, seed: int):
        """(weighted NLL sum, weight sum) of the listwise loss; the positive
        is candidate 0. The forward runs on the compute copy."""
        logits = self.computing(self.forward_indexed, tables, batch, seed)
        nll = -torch.log_softmax(logits, dim=1)[:, 0]
        w = batch.weight.to(logits.dtype)
        return (nll * w).sum(), w.sum()

    def loss(self, tables: NRMSTables, batch, seed: int) -> torch.Tensor:
        """Listwise NLL with per-row weights (padded tail rows weigh 0)."""
        num, den = self.loss_parts(tables, batch, seed)
        return num / den.clamp(min=1.0)
