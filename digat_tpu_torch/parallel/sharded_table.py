"""The word table row-sharded over the model axis (`--mesh_model` M > 1).

Counterpart of the JAX package's `param_shardings` (`digat_tpu.parallel.
mesh`), which places every `word_embedding` leaf as `P(model, None)`: rank
m of a model group holds the contiguous rows `shard_rows(V, M, m)` and
every other parameter whole. JAX leaves the gather's collectives to XLA;
here they are explicit:

  * forward (`ShardedLookup`): the unique token ids u of the batch (the
    same on every rank of a model group, which sees the same rows); each
    rank fills the rows of u that it holds and zeros elsewhere, and one
    `all_reduce` over the model group gives every row of u exactly once,
    so the result is exact. It sends [U, word_dim] instead of the [N, L,
    word_dim] gathered words;
  * backward: the gradient of the rank's own rows from the token slots'
    gradient as it is: kernel D over the tokens in the rank's range
    (`ops.emb_grad.embedding_grad` with `row_start`), or, for
    `sorted_emb_grad` false and the NRMS family, the library's scatter-add
    on shard-local indices. The loss is the same on every rank of a model
    group, so the slots' gradient must not be summed over it: that sum
    would make the table's gradient M times the true one (the transpose of
    a psum is a psum);
  * eval (`whole_table`): the whole table gathered once over the model
    group before the scorer's first stage, as JAX's scorer replicates the
    parameters;
  * checkpoints and interop see the whole table: a whole-table entry
    loaded into a `ShardedTable` keeps the rank's rows, and `full_state_dict`
    gathers them (a collective over the model group).

`shard_word_table` replaces a model's `word_embedding` by its rank's
`ShardedTable`; the state_dict name (`news_encoder.word_embedding.weight`)
stays. The optimizer (`train.optimizer.Adam`, `shards=`) keeps Adam's
moments for those rows only and adds the shards' squared sums over the
model group to the clip norm."""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from digat_tpu_torch.ops.emb_grad import embedding_grad, embedding_lookup
from digat_tpu_torch.parallel.dist import DistContext


def shard_rows(vocab_size: int, model_world: int, model_rank: int) -> Tuple[int, int]:
    """(lo, hi): the rows of a `vocab_size`-row table that model index
    `model_rank` of `model_world` holds, contiguous equal blocks as JAX
    places `P(model, None)`. A vocabulary that does not split evenly
    raises, as JAX's placement does."""
    if vocab_size % model_world:
        raise ValueError(f"--mesh_model {model_world} does not split the vocabulary of "
                         f"{vocab_size} words into equal row blocks")
    if not 0 <= model_rank < model_world:
        raise ValueError(f"model index {model_rank} is not one of {model_world}")
    rows = vocab_size // model_world
    return model_rank * rows, (model_rank + 1) * rows


class ShardedTable(nn.Module):
    """Rows [lo, hi) of a [vocab_size, dim] word table on one rank of a
    model group, as the parameter `weight`. While `whole` holds the
    gathered table (`whole_table`), lookups read it and need no
    collective."""

    def __init__(self, weight: torch.Tensor, vocab_size: int, dist: DistContext):
        super().__init__()
        self.dist = dist
        self.vocab_size = vocab_size
        self.lo, self.hi = shard_rows(vocab_size, dist.model_world, dist.model_rank)
        if weight.shape[0] != self.hi - self.lo:
            raise ValueError(f"a shard of rows [{self.lo}, {self.hi}) cannot hold "
                             f"{weight.shape[0]} rows")
        self.weight = nn.Parameter(weight)
        self.whole = None

    def gather(self, t: torch.Tensor = None) -> torch.Tensor:
        """The whole [vocab_size, ...] tensor from every rank's rows of `t`
        (by default `weight`), over the model group."""
        t = self.weight.detach() if t is None else t
        return self.dist.all_gather_rows(t, group=self.dist.model_group)

    def own_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-table tensor (a tensor of the shard's
        rows is returned as it is)."""
        if t.shape[0] == self.vocab_size:
            return t[self.lo:self.hi]
        if t.shape[0] != self.hi - self.lo:
            raise ValueError(f"a tensor of {t.shape[0]} rows is neither the {self.vocab_size}-"
                             f"row table nor the shard of rows [{self.lo}, {self.hi})")
        return t

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "weight"
        if key in state_dict:
            state_dict[key] = self.own_rows(state_dict[key])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, tok: torch.Tensor, sorted_grad: bool = True) -> torch.Tensor:
        """tok [...] int -> the rows [..., dim], the lookup's gradient kernel
        D on this rank's rows (`sorted_grad`) or the library's scatter-add."""
        if self.whole is not None:
            if torch.is_grad_enabled() and self.weight.requires_grad:
                raise RuntimeError("the gathered word table is for evaluation: a lookup that "
                                   "takes gradients goes through the shards")
            return self.whole[tok]
        return ShardedLookup.apply(self.weight, tok, self, sorted_grad)


class ShardedLookup(torch.autograd.Function):
    """table[tok] over the model group (see the module docstring)."""

    @staticmethod
    def forward(ctx, weight, tok, table: ShardedTable, sorted_grad: bool):
        uniq, inv = torch.unique(tok, return_inverse=True)
        own = (uniq >= table.lo) & (uniq < table.hi)
        rows = weight.new_zeros((uniq.shape[0], weight.shape[1]))
        rows[own] = weight[uniq[own] - table.lo]
        table.dist.all_reduce_sum_([rows], group=table.dist.model_group)
        ShardedLookup.bytes += rows.numel() * rows.element_size()
        ctx.save_for_backward(tok)
        ctx.table, ctx.sorted_grad = table, sorted_grad
        return rows[inv]

    @staticmethod
    def backward(ctx, g):
        (tok,) = ctx.saved_tensors
        table = ctx.table
        rows = table.hi - table.lo
        if ctx.sorted_grad:
            return embedding_grad(tok, g, rows, row_start=table.lo), None, None, None
        t, g2 = tok.reshape(-1), g.reshape(-1, g.shape[-1])
        keep = (t >= table.lo) & (t < table.hi)
        dw = torch.ops.aten.embedding_dense_backward(g2[keep], t[keep] - table.lo, rows, -1,
                                                     False)
        return dw, None, None, None


ShardedLookup.bytes = 0  # bytes the forward's all-reduces carried (one rank's buffer)


def lookup(embedding: nn.Module, tok: torch.Tensor, sorted_grad: bool = True) -> torch.Tensor:
    """The rows of `tok` from a model's word table: an `nn.Embedding` (the
    whole table, its gradient kernel D where `sorted_grad`, else
    `F.embedding`'s scatter-add) or a `ShardedTable`."""
    if isinstance(embedding, ShardedTable):
        return embedding(tok, sorted_grad)
    if sorted_grad:
        return embedding_lookup(embedding.weight, tok)
    return F.embedding(tok, embedding.weight)


def shard_word_table(encoder: nn.Module, dist: DistContext) -> None:
    """Keep this rank's rows of `encoder.word_embedding` (an `nn.Embedding`
    holding the whole table) as a `ShardedTable`, where `dist` has a model
    axis; otherwise nothing changes."""
    if dist is None or dist.model_world == 1:
        return
    if not dist.active:
        raise ValueError("a model axis needs a process group")
    weight = encoder.word_embedding.weight.detach()
    lo, hi = shard_rows(weight.shape[0], dist.model_world, dist.model_rank)
    encoder.word_embedding = ShardedTable(weight[lo:hi].clone(), weight.shape[0], dist)


def tables(model: nn.Module) -> Dict[str, ShardedTable]:
    """{state_dict name of the weight: its ShardedTable} of `model` (empty
    where nothing is sharded)."""
    return {f"{name}.weight": m for name, m in model.named_modules()
            if isinstance(m, ShardedTable)}


def full_state_dict(model: nn.Module) -> dict:
    """`model.state_dict()` with every sharded table whole: a collective
    over the model group where the model holds shards."""
    sd = model.state_dict()
    for name, table in tables(model).items():
        sd[name] = table.gather()
    return sd


@contextlib.contextmanager
def whole_table(model: nn.Module):
    """Within the block, the model's lookups read its whole word table,
    gathered once over the model group on entry (every rank of the group
    enters together); inside another such block, nothing more is done."""
    todo = [t for t in tables(model).values() if t.whole is None]
    for t in todo:
        t.whole = t.gather()
    try:
        yield
    finally:
        for t in todo:
            t.whole = None


def broadcast_state_(model: nn.Module, dist: DistContext,
                     extra: Sequence[torch.Tensor] = ()) -> None:
    """Rank 0's replicated weights (and `extra`) on every rank, and each
    table shard from the rank of data index 0 that holds the same rows."""
    sharded = tables(model)
    sd = model.state_dict()
    dist.broadcast_([v for k, v in sd.items() if k not in sharded] + list(extra))
    if sharded:
        dist.broadcast_([sd[k] for k in sharded], src=dist.model_rank, group=dist.data_group)
