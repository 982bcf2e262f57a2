"""Model assembly: the news encoder (MSA or CNN), the graph encoder (DIGAT or
one of its five ablations), dot product, and the listwise training loss.

Counterpart of `digat_tpu.models.model` (`CorpusTables`, `TrainBatch`,
`DedupTrainBatch`, `ShardedDedupBatch`, `EvalBatch`, `Model.forward`, `forward_encoded`,
`forward_indexed`, `loss_parts`, `loss`, `encode_news`,
`initial_news_context`, `inference`). Parameters live in `nn.Module`s under
the reference `state_dict` names, drawn from an explicit `torch.Generator`
on the CPU and then moved to the model's device, so one seed gives the same
weights on every device.

Where the JAX package passes `train` and a PRNG key, the port passes a
32-bit `seed`: with a seed the forward is the training forward (dropout
under that seed, one site number per dropout call, kernel C in the GAT
layers); without one it is eval (kernel B).

Mixed precision (`config.compute_dtype` bfloat16, `Model.cast_params` in
the JAX package): the parameters stay fp32 masters, which the optimizer
updates and checkpoints hold. The loss and both stages of the cached
scorer run with `compute_params()`, differentiable bf16 copies of them,
swapped in by `computing` (`torch.func.functional_call`), so each
gradient comes back to its master fp32, rounded once to bf16 as JAX's
cast rounds it. The word table is the exception: its rows are cast after
the gather (`models.news_encoders`)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from digat_tpu_torch.config import Config
from digat_tpu_torch.data.user_graph import build_user_graph
from digat_tpu_torch.layers import DropoutSites
from digat_tpu_torch.models.graph_encoders import GraphEncoder
from digat_tpu_torch.models.news_encoders import NewsEncoder
from digat_tpu_torch.parallel.sharded_table import shard_word_table
from digat_tpu_torch.runtime import exact_fp32, resolve_device

WORD_TABLE = "news_encoder.word_embedding.weight"  # stays fp32 in the compute copy


def as_device_tensor(x, device, dtype) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor of `dtype` on `device`."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype).contiguous()


class CorpusTables(NamedTuple):
    """Corpus arrays on the model's device, shared by every batch."""

    news_title_text: torch.Tensor  # [news_num, L] int64
    news_title_mask: torch.Tensor  # [news_num, L] bool
    news_node_id: torch.Tensor  # [news_num, Gn] int64 (SAG node ids)
    news_graph: torch.Tensor  # [news_num, Gn, Gn] bool (self-loops added)
    news_graph_mask: torch.Tensor  # [news_num, Gn] bool (slot 0 zeroed)

    @classmethod
    def from_arrays(cls, tables, device) -> "CorpusTables":
        """Any object with the five fields (numpy arrays or tensors) ->
        CorpusTables on `device`."""
        put = lambda x, dtype: as_device_tensor(x, device, dtype)
        return cls(
            news_title_text=put(tables.news_title_text, torch.int64),
            news_title_mask=put(tables.news_title_mask, torch.bool),
            news_node_id=put(tables.news_node_id, torch.int64),
            news_graph=put(tables.news_graph, torch.bool),
            news_graph_mask=put(tables.news_graph_mask, torch.bool),
        )


class TrainBatch(NamedTuple):
    """Index-only training batch (device tensors, int64 indices)."""

    history_idx: torch.Tensor  # [B, H] news ids (0 = pad)
    cat_idx: torch.Tensor  # [B, H] category per slot (C = pad)
    sample_idx: torch.Tensor  # [B, 1+K] candidate news ids (positive first)
    weight: torch.Tensor  # [B] float (0 for padding rows of the last batch)


class DedupTrainBatch(NamedTuple):
    """Training batch with unique-title dedup: every news of the batch
    (candidate-graph nodes and histories) is listed once in `uniq_ids`, the
    encoder runs once per unique title, and inverse indices fan the
    representations out. The same math as TrainBatch; the gather's
    gradient sums the occurrences. Unlike the JAX package's, it carries no
    sort metadata: kernel D sorts the token stream on the device."""

    uniq_ids: torch.Tensor  # [U] news ids (0-padded to the capacity)
    cand_inv: torch.Tensor  # [B, 1+K, Gn] indices into uniq_ids
    hist_inv: torch.Tensor  # [B, H] indices into uniq_ids
    cat_idx: torch.Tensor  # [B, H]
    sample_idx: torch.Tensor  # [B, 1+K] (graph and mask gathers)
    weight: torch.Tensor  # [B]


class ShardedDedupBatch(NamedTuple):
    """Per-shard unique-title dedup for data parallelism: every field of a
    DedupTrainBatch stacked on a leading shard axis [S, ...], shard s holding
    batch rows [s B/S, (s+1) B/S) with its own unique-title table, so each
    rank keeps the encode-once dedup and its own sorted embedding gradient
    with no title exchange between ranks."""

    uniq_ids: torch.Tensor  # [S, cap]
    cand_inv: torch.Tensor  # [S, B/S, 1+K, Gn]
    hist_inv: torch.Tensor  # [S, B/S, H]
    cat_idx: torch.Tensor  # [S, B/S, H]
    sample_idx: torch.Tensor  # [S, B/S, 1+K]
    weight: torch.Tensor  # [S, B/S]

    def local(self, index: int = 0) -> DedupTrainBatch:
        """Shard `index` as a DedupTrainBatch (the JAX package's `local()`
        takes shard 0 of a shard_map slice)."""
        return DedupTrainBatch(*(x[index] for x in self))


class EvalBatch(NamedTuple):
    """Stage-2 batch: one impression item per row."""

    history_idx: torch.Tensor  # [B, H] int64
    cat_idx: torch.Tensor  # [B, H] int64
    cand_idx: torch.Tensor  # [B] int64


# Dropout site numbers of a training step: the word dropout of the news
# encoder (candidates, or the unique titles of a dedup batch; then the
# histories of a plain batch), then the graph encoder's sites in call order.
SITE_NEWS, SITE_HISTORY, FIRST_GRAPH_SITE = 0, 1, 2


def dot_logits(news_rep: torch.Tensor, user_rep: torch.Tensor) -> torch.Tensor:
    """sum(news_rep * user_rep) over the last axis in fp32 at least: bf16
    representations (CNN-DIGAT at bfloat16) are upcast first, as the JAX
    package forms its logits."""
    acc = torch.promote_types(news_rep.dtype, torch.float32)
    return (news_rep.to(acc) * user_rep.to(acc)).sum(dim=-1)


def set_word_embedding(encoder: nn.Module, word_embedding) -> None:
    """The corpus's [V, word_dim] table (GloVe rows or pseudo-GloVe) as the
    encoder's initial word embedding, as the JAX package's
    `init(key, word_embedding)` takes it."""
    if word_embedding is not None:
        with torch.no_grad():
            encoder.word_embedding.weight.copy_(as_device_tensor(
                word_embedding, encoder.word_embedding.weight.device, torch.float32))


class ComputeCopy:
    """Mixed precision for a model with `compute_dtype` and `_computing` set
    (the DIGAT family's `Model`, the NRMS family's `NRMSModel`)."""

    def compute_params(self) -> Optional[dict]:
        """The bf16 compute copy at `compute_dtype` bfloat16: every fp32
        parameter cast (differentiably) but the word table -> {name:
        tensor}; None at float32, where the model computes with its
        parameters themselves."""
        if self.compute_dtype == torch.float32:
            return None
        return {name: p if name == WORD_TABLE or p.dtype != torch.float32
                else p.to(self.compute_dtype) for name, p in self.named_parameters()}

    def computing(self, fn, *args, params: Optional[dict] = None, **kwargs):
        """fn(*args, **kwargs) with the model's parameters replaced by the
        compute copy (`params`, or a fresh `compute_params()`); at float32,
        and inside another `computing` call (the copy already in place), fn
        runs as it is. fn may be any callable that reaches the parameters
        through this model's modules. The swap costs host time for each
        parameter, so a caller of many calls (the scorer's stages) wraps
        them in one."""
        if self.compute_dtype == torch.float32 or self._computing:
            return fn(*args, **kwargs)
        params = self.compute_params() if params is None else params
        self._computing = True
        try:
            return torch.func.functional_call(
                _Call(self), {f"model.{k}": v for k, v in params.items()}, (fn, args, kwargs))
        finally:
            self._computing = False


class _Call(nn.Module):
    """Holds a model as its one child; its forward calls fn(*args, **kwargs),
    so that `torch.func.functional_call` can run any method of the model
    with the parameters it is given."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, args, kwargs):
        return fn(*args, **kwargs)


class Model(ComputeCopy, nn.Module):
    """The DIGAT family: `config.news_encoder` (MSA, CNN) and
    `config.graph_encoder` (DIGAT, wo_SA, Seq_SA, wo_interaction,
    news_graph_wo_inter, user_graph_wo_inter). Runs on CUDA unless `device`
    names another device; with no device and no CUDA it raises. `word_embedding` (numpy [V, word_dim]), if
    given, replaces the drawn word table; the other weights are drawn the
    same either way. With `dist` on a grid of `mesh_model` M > 1 ranks
    (`parallel.dist.DistContext`), the model keeps its model index's rows
    of that whole table (`parallel.sharded_table`), so that every rank
    draws the same weights."""

    def __init__(self, config: Config, device=None, generator: Optional[torch.Generator] = None,
                 word_embedding=None, dist=None):
        super().__init__()
        config.validate()
        device = resolve_device(device)
        exact_fp32()
        self.config = config
        self.model_name = config.model_name
        g = generator if generator is not None else torch.Generator().manual_seed(config.seed)
        self.news_encoder = NewsEncoder(
            config.vocabulary_size, config.word_embedding_dim, config.MSA_head_num,
            config.MSA_head_dim, config.attention_dim, config.max_title_length,
            config.dropout_rate, g, encoder=config.news_encoder, cnn_method=config.cnn_method,
            cnn_kernel_num=config.cnn_kernel_num, cnn_window_size=config.cnn_window_size,
            sorted_emb_grad=config.sorted_emb_grad,
        )
        self.graph_encoder = GraphEncoder(
            config.graph_encoder, config.graph_depth, config.max_history_num, config.category_num,
            config.news_embedding_dim, config.dropout_rate, g,
        )
        set_word_embedding(self.news_encoder, word_embedding)
        shard_word_table(self.news_encoder, dist)
        self.to(device)
        self.device = device
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self._computing = False  # inside `computing`: the compute copy is in place

    # ------------------------------------------------------------------
    def forward(self, user_title_text, user_title_mask, user_graph, user_category_mask,
                user_category_indices, news_title_text, news_title_mask, news_graph,
                news_graph_mask, seed: Optional[int] = None) -> torch.Tensor:
        """Dense-tensor forward -> logits [B, N]. user_title_* [B, H, L];
        news_title_* [B, N, Gn, L]; news_graph [B, N, Gn, Gn]."""
        cand = self.news_encoder(news_title_text, news_title_mask, seed, SITE_NEWS)
        hist = self.news_encoder(user_title_text, user_title_mask, seed, SITE_HISTORY)
        return self.forward_encoded(cand, hist, user_graph, user_category_mask,
                                    user_category_indices, news_graph, news_graph_mask, seed)

    def forward_encoded(self, cand, hist, user_graph, user_category_mask,
                        user_category_indices, news_graph, news_graph_mask,
                        seed: Optional[int] = None) -> torch.Tensor:
        """cand [B, N, Gn, D] and hist [B, H, D] already encoded -> logits
        [B, N]. Every candidate graph is paired with its row's user graph."""
        B, Nn = cand.shape[:2]
        flat = lambda x: x.reshape((B * Nn,) + x.shape[2:])
        rep = lambda x: x[:, None].expand((B, Nn) + x.shape[1:]).reshape((B * Nn,) + x.shape[1:])
        news_rep, user_rep = self.graph_encoder(
            flat(cand), flat(news_graph), flat(news_graph_mask), rep(hist), rep(user_graph),
            rep(user_category_mask), rep(user_category_indices),
            drop=DropoutSites(seed, FIRST_GRAPH_SITE),
        )
        return dot_logits(news_rep, user_rep).reshape(B, Nn)

    def forward_indexed(self, tables: CorpusTables, batch, seed: Optional[int] = None):
        """Index-batch forward: gathers titles and graphs on the device,
        rebuilds the user graph from the category indices, then runs
        `forward` (TrainBatch) or encodes each unique title once
        (DedupTrainBatch)."""
        cfg = self.config
        news_graph = tables.news_graph[batch.sample_idx]  # [B, N, Gn, Gn]
        news_graph_mask = tables.news_graph_mask[batch.sample_idx]
        user_graph, user_category_mask = build_user_graph(batch.cat_idx, cfg.max_history_num,
                                                          cfg.category_num)
        if isinstance(batch, DedupTrainBatch):
            # a title's dropout mask is shared by its occurrences, as in the
            # JAX package
            uniq = self.news_encoder(tables.news_title_text[batch.uniq_ids],
                                     tables.news_title_mask[batch.uniq_ids], seed, SITE_NEWS)
            return self.forward_encoded(uniq[batch.cand_inv], uniq[batch.hist_inv], user_graph,
                                        user_category_mask, batch.cat_idx, news_graph,
                                        news_graph_mask, seed)
        node_ids = tables.news_node_id[batch.sample_idx]  # [B, N, Gn]
        return self.forward(
            tables.news_title_text[batch.history_idx], tables.news_title_mask[batch.history_idx],
            user_graph, user_category_mask, batch.cat_idx,
            tables.news_title_text[node_ids], tables.news_title_mask[node_ids],
            news_graph, news_graph_mask, seed,
        )

    def loss_parts(self, tables: CorpusTables, batch, seed: int):
        """(weighted NLL sum, weight sum) of the listwise loss; the positive
        is candidate 0. The forward runs on the compute copy."""
        logits = self.computing(self.forward_indexed, tables, batch, seed)
        nll = -torch.log_softmax(logits, dim=1)[:, 0]
        w = batch.weight.to(logits.dtype)
        return (nll * w).sum(), w.sum()

    def loss(self, tables: CorpusTables, batch, seed: int) -> torch.Tensor:
        """Listwise sampled-softmax NLL with per-row weights, so the padded
        rows of a tail batch contribute nothing."""
        num, den = self.loss_parts(tables, batch, seed)
        return num / den.clamp(min=1.0)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode_news(self, title_text: torch.Tensor, title_mask: torch.Tensor) -> torch.Tensor:
        """Stage-1: encode news titles -> [..., D] (eval), on the compute copy."""
        return self.computing(self.news_encoder, title_text, title_mask)

    @torch.inference_mode()
    def initial_news_context(self, sag_embeddings: torch.Tensor, news_graph_mask: torch.Tensor):
        """Stage-1: c_n0 from the SAG node representations [B, Gn, D] (node 0
        itself for wo_SA), on the compute copy."""
        return self.computing(self.graph_encoder.initial_news_context, sag_embeddings,
                              news_graph_mask)

    @torch.inference_mode()
    def inference(self, user_news_embedding, user_graph, user_category_mask,
                  user_category_indices, candidate_news_embedding, news_graph,
                  news_graph_mask, c_n0) -> torch.Tensor:
        """Two-stage cached scoring -> logits [B] (eval), on the compute copy."""
        news_rep, user_rep = self.computing(
            self.graph_encoder, candidate_news_embedding, news_graph, news_graph_mask,
            user_news_embedding, user_graph, user_category_mask, user_category_indices,
            c_n0=c_n0)
        return dot_logits(news_rep, user_rep)
