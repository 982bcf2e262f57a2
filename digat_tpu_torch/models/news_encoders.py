"""MSA news encoder.

Counterpart of the MSA branch of `digat_tpu.models.news_encoders.encode`:
embed the title tokens from the [V, 300] table (`ops.emb_grad`, whose
gradient is kernel D), then run the whole post-embedding encoder (word
dropout, projections, unmasked multi-head attention, ReLU, masked
attention pool) as kernel A (`ops.msa_encoder`), with kernel A' as its
backward. The embedding gather stays outside the kernel, as in the JAX
package. In training the word dropout is drawn inside the kernels under
(seed, site); in eval there is none."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from digat_tpu_torch.layers import AttentionPool, MultiHeadAttention
from digat_tpu_torch.ops.emb_grad import embedding_lookup
from digat_tpu_torch.ops.msa_encoder import msa_encoder_pooled


class NewsEncoder(nn.Module):
    """state_dict names follow the reference: `word_embedding.weight`,
    `multiheadSelfattention.W_{K,Q,V}.*`, `attention.affine{1,2}.*`."""

    def __init__(self, vocab_size: int, word_dim: int, heads: int, head_dim: int,
                 attention_dim: int, max_title_length: int, dropout_rate: float,
                 generator: torch.Generator):
        super().__init__()
        self.heads = heads
        self.dim = heads * head_dim
        self.max_title_length = max_title_length
        self.dropout_rate = dropout_rate
        self.word_embedding = nn.utils.skip_init(nn.Embedding, vocab_size, word_dim)
        with torch.no_grad():
            self.word_embedding.weight.normal_(generator=generator)
        self.multiheadSelfattention = MultiHeadAttention(heads, word_dim, head_dim, head_dim,
                                                         generator)
        self.attention = AttentionPool(self.dim, attention_dim, generator)

    def forward(self, title_text: torch.Tensor, title_mask: torch.Tensor,
                seed: Optional[int] = None, site: int = 0) -> torch.Tensor:
        """title_text [..., L] int, title_mask [..., L] -> [..., D]. With a
        `seed` this is the training forward (word dropout under (seed,
        site)); without, eval."""
        lead = title_text.shape[:-1]
        L = self.max_title_length
        w = embedding_lookup(self.word_embedding.weight, title_text.reshape(-1, L))
        mha, pool = self.multiheadSelfattention, self.attention
        pooled = msa_encoder_pooled(
            w, title_mask.reshape(-1, L).to(torch.bool).contiguous(),
            mha.W_Q.weight.t(), mha.W_Q.bias, mha.W_K.weight.t(), mha.W_V.weight.t(),
            mha.W_V.bias, pool.affine1.weight.t(), pool.affine1.bias, pool.affine2.weight[0],
            self.heads, dropout_rate=self.dropout_rate if seed is not None else 0.0,
            seed=seed or 0, site=site,
        )
        return pooled.reshape(*lead, self.dim)
