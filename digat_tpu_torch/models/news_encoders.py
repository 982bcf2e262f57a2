"""News title encoders: MSA and CNN.

Counterpart of `digat_tpu.models.news_encoders.encode`. Both embed the
title tokens from the [V, 300] table (`ops.emb_grad`, whose gradient is
kernel D) and end in the masked tanh-MLP attention pool; the embedding
gather stays outside any kernel, as in the JAX package. With `--mesh_model`
M > 1 the table is row-sharded over the model group and looked up through
`parallel.sharded_table` (kernel D on the rank's rows), as the JAX
package's `param_shardings` shards it.

MSA. Where the JAX package runs its fused kernel (`group_size(heads, L,
dk) > 0`: titles up to 128 positions, heads up to 128 wide), the whole
post-embedding encoder (word dropout, projections, unmasked multi-head
attention, ReLU, masked attention pool) is kernel A (`ops.msa_encoder`),
with kernel A' as its backward; in training the word dropout is drawn
inside the kernels under (seed, site). Beyond, as the JAX package does,
word dropout (kernel A''), the projections and the attention pair
(`layers.mha`, no key mask: pads attend), ReLU, and the pool.

CNN. Word dropout (A''), the convolution bank with its ReLU
(`layers.ConvBank`), dropout (A'') on its output, and the pool. The second
dropout draws under site + CONV_SITE, clear of every other site of a
training step. In eval there is no dropout.

At `compute_dtype` bfloat16 the weights are bf16 copies, but the word
table stays the fp32 master: the rows are gathered from it and then cast
to bf16. The forward is the same as a lookup in a bf16 table, and the
table's gradient is the sum of the rows' gradients upcast, unrounded, as
the JAX package's sorted embedding gradient (kernel D) returns it. Kernel
A takes the bf16 rows and weights and returns fp32. Past kernel A's titles
the bf16 rows take the bf16 word dropout (A''s bf16 instance), bf16
projections and the attention pair's bf16 instance, whose output `mha`
casts to fp32 for the ReLU and the pool. The CNN runs in bf16 throughout:
word dropout, the bank (its bias a bf16 add), ReLU, dropout and the pool,
so its news vectors are bf16, as the JAX package's are."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from digat_tpu_torch.layers import AttentionPool, ConvBank, MultiHeadAttention, attn_pool, \
    dropout, mha
from digat_tpu_torch.ops.msa_attention_grouped import group_size
from digat_tpu_torch.ops.msa_encoder import msa_encoder_pooled
from digat_tpu_torch.parallel.sharded_table import lookup

CONV_SITE = 1 << 16  # the CNN's dropout after the convolutions: site + CONV_SITE


class NewsEncoder(nn.Module):
    """state_dict names follow the reference: `word_embedding.weight`,
    `multiheadSelfattention.W_{K,Q,V}.*` (MSA) or `conv.conv*.*` (CNN),
    `attention.affine{1,2}.*`. The news vector is heads * head_dim wide
    (MSA) or cnn_kernel_num (CNN). With `sorted_emb_grad` (the default) the
    word table's gradient is kernel D's sorted segment sum; without, the
    titles are looked up by `F.embedding`, whose gradient is the library's
    scatter-add (the JAX package's `sorted_emb_grad=False`, XLA's). On a
    rank of a model axis the table is the rank's rows, a `ShardedTable`
    (`parallel.sharded_table`), under the same name."""

    def __init__(self, vocab_size: int, word_dim: int, heads: int, head_dim: int,
                 attention_dim: int, max_title_length: int, dropout_rate: float,
                 generator: torch.Generator, encoder: str = "MSA", cnn_method: str = "naive",
                 cnn_kernel_num: int = 400, cnn_window_size: int = 3,
                 sorted_emb_grad: bool = True):
        super().__init__()
        self.sorted_emb_grad = sorted_emb_grad
        self.encoder = encoder
        self.heads = heads
        self.dim = cnn_kernel_num if encoder == "CNN" else heads * head_dim
        self.max_title_length = max_title_length
        self.dropout_rate = dropout_rate
        self.word_embedding = nn.utils.skip_init(nn.Embedding, vocab_size, word_dim)
        with torch.no_grad():
            self.word_embedding.weight.normal_(generator=generator)
        if encoder == "CNN":
            self.conv = ConvBank(cnn_method, word_dim, cnn_kernel_num, cnn_window_size,
                                 generator)
        else:
            self.multiheadSelfattention = MultiHeadAttention(heads, word_dim, head_dim,
                                                             head_dim, generator)
        self.attention = AttentionPool(self.dim, attention_dim, generator)

    @property
    def fused(self) -> bool:
        """Whether the MSA encoder runs as kernel A (the JAX package's
        `group_size(heads, L, dk) > 0`)."""
        return self.encoder != "CNN" and group_size(
            self.heads, self.max_title_length, self.dim // self.heads) > 0

    def forward(self, title_text: torch.Tensor, title_mask: torch.Tensor,
                seed: Optional[int] = None, site: int = 0) -> torch.Tensor:
        """title_text [..., L] int, title_mask [..., L] -> [..., D]. With a
        `seed` this is the training forward (dropout under (seed, site));
        without, eval."""
        lead = title_text.shape[:-1]
        L = self.max_title_length
        tok = title_text.reshape(-1, L)
        w = lookup(self.word_embedding, tok, self.sorted_emb_grad)
        mask = title_mask.reshape(-1, L).to(torch.bool).contiguous()
        rate = self.dropout_rate
        if self.fused:
            mha_, pool = self.multiheadSelfattention, self.attention
            w = w.to(mha_.W_Q.weight.dtype)
            pooled = msa_encoder_pooled(
                w, mask, mha_.W_Q.weight.t(), mha_.W_Q.bias, mha_.W_K.weight.t(),
                mha_.W_V.weight.t(), mha_.W_V.bias, pool.affine1.weight.t(), pool.affine1.bias,
                pool.affine2.weight[0], self.heads,
                dropout_rate=rate if seed is not None else 0.0, seed=seed or 0, site=site,
            )
            return pooled.reshape(*lead, self.dim)
        w = dropout(w.to(self.attention.affine1.weight.dtype), rate, seed, site)
        if self.encoder == "CNN":
            h = dropout(self.conv(w), rate, seed, site + CONV_SITE)
        else:
            h = torch.relu(mha(self.multiheadSelfattention, w, self.heads))
        return attn_pool(self.attention, h, mask).reshape(*lead, self.dim)
