"""Word-embedding lookup whose gradient is a sorted segment sum (kernel D).

Replaces `digat_tpu/ops/pallas/emb_grad.py` (`embedding_lookup`, whose
backward runs `sorted_rowsum` -> `_rowsum_kernel`). The forward is the
gather `table[tok]`, as in the JAX package. The backward is

    dW[v] = sum of g[k] over the token slots k with tok[k] == v  (0 if none)

On a CPU tensor it is `embedding_grad_plain` (`index_add_`). On a CUDA
tensor it is kernel D (`csrc/emb_grad.cu`): the token stream is sorted on
the device (a stable `torch.sort` of 32-bit keys), and that sort is the
only metadata. A warp sums each chunk of `CHUNK` sorted slots run by run and
writes a run that lies inside its chunk straight to its table row; the
pieces of runs that cross a chunk boundary (the pad token's run above all)
go to scratch and are summed in a fixed order by a second pass. The JAX
package built its work list on the host for the TPU's scalar prefetch; here
nothing leaves the device. The sum is deterministic (no atomics).

With `row_start` the gradient is that of rows [row_start, row_start +
vocab_size) of a larger table, the rows one rank of a model group holds
(`parallel.sharded_table`): the matching slice of the whole table's
gradient, the tokens outside the range skipped. On the card the sorted
stream is cut to the range with `torch.searchsorted` (the host reads the
two bounds), its ids shifted by -row_start, and D runs on that sub-stream
alone: no dummy row, no masked slot. The cut falls between runs, so every
run lies whole in one range; the pad token's run (id 0) lies in the range
that starts at row 0.

At `compute_dtype` bfloat16 the news encoder gathers fp32 rows and casts
them, so the rows' gradient arrives here upcast from kernel A''s bf16 dx;
a bf16 gradient (a lookup in a bf16 table) is upcast here, exactly, as the
JAX package upcasts its cotangent before its kernel. The sum is fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from digat_tpu_torch.ops import build

CHUNK = 64  # sorted slots per warp in the chunk pass (a multiple of 32)


def embedding_grad_plain(tok, g, vocab_size: int, row_start: Optional[int] = None):
    """Plain PyTorch version of kernel D: tok [...] int, g [..., D] ->
    dW [V, D]; with `row_start`, the rows [row_start, row_start + V) only."""
    D = g.shape[-1]
    out = torch.zeros((vocab_size, D), dtype=g.dtype, device=g.device)
    tok, g = tok.reshape(-1), g.reshape(-1, D)
    if row_start is not None:
        keep = (tok >= row_start) & (tok < row_start + vocab_size)
        tok, g = tok[keep] - row_start, g[keep]
    return out.index_add_(0, tok, g)


def sort_metadata(tok):
    """(ids, perm) of the flat token stream: the tokens sorted as int32 and
    the stable sort's permutation (int64), the sorted slots in token order."""
    return torch.sort(tok.reshape(-1).int(), stable=True)


def cut_range(ids, perm, row_start: int, rows: int):
    """The sorted stream (ids, perm) cut to the ids in [row_start, row_start
    + rows), the ids shifted to start at 0; perm still names slots of the
    whole stream."""
    bounds = torch.tensor([row_start, row_start + rows], dtype=ids.dtype, device=ids.device)
    lo, hi = torch.searchsorted(ids, bounds).tolist()
    return ids[lo:hi] - row_start, perm[lo:hi]


def partial_rows(ntok: int, chunk: int = CHUNK) -> int:
    """Rows of kernel D's scratch: two per chunk, the piece of the run that
    crosses the chunk's start and that of the run that crosses its end."""
    return 2 * -(-ntok // chunk)


def embedding_grad(tok, g, vocab_size: int, row_start: Optional[int] = None):
    """Kernel D. Same arguments and result as `embedding_grad_plain`; a bf16
    g is upcast first (the result is fp32)."""
    if g.dtype == torch.bfloat16:
        g = g.float()
    if not build.use_kernel(g):
        return embedding_grad_plain(tok, g, vocab_size, row_start)
    if tok.device != g.device:
        raise ValueError(f"embedding_grad: tok on {tok.device}, g on {g.device}")
    D = g.shape[-1]
    if g.dtype != torch.float32 or D % 4 or D > 512:
        raise ValueError(f"embedding_grad: g must be float32 with D % 4 == 0 and D <= 512, "
                         f"got {g.dtype} D={D}")
    if tok.shape != g.shape[:-1]:
        raise ValueError(f"embedding_grad: tok {tuple(tok.shape)} does not match g "
                         f"{tuple(g.shape)}")
    if vocab_size + (row_start or 0) >= 2 ** 31:
        raise ValueError(f"embedding_grad: vocab_size {vocab_size} does not fit int32 ids")
    g2 = g.reshape(-1, D).contiguous()
    ids, perm = sort_metadata(tok)
    if row_start is not None:
        ids, perm = cut_range(ids, perm, row_start, vocab_size)
    ntok = ids.shape[0]
    partial = torch.empty((partial_rows(ntok), D), dtype=torch.float32, device=g.device)
    out = torch.empty((vocab_size, D), dtype=torch.float32, device=g.device)
    with build.launch_on(g.device) as (lib, stream):
        err = lib.emb_grad_f32(g2.data_ptr(), ids.data_ptr(), perm.data_ptr(),
                               partial.data_ptr(), out.data_ptr(), ntok, vocab_size, D,
                               CHUNK, stream)
    build.check(lib, err, "embedding_grad")
    embedding_grad.launches += 1
    return out


class EmbeddingLookup(torch.autograd.Function):
    """table[tok], with kernel D (plain `index_add_` on the CPU) as the
    table's gradient."""

    @staticmethod
    def forward(ctx, table, tok):
        ctx.save_for_backward(tok)
        ctx.vocab_size = table.shape[0]
        return table[tok]

    @staticmethod
    def backward(ctx, g):
        (tok,) = ctx.saved_tensors
        return embedding_grad(tok, g, ctx.vocab_size), None


def embedding_lookup(table, tok):
    """table [V, D], tok [...] int -> [..., D]."""
    return EmbeddingLookup.apply(table, tok)


embedding_grad.launches = 0
