"""Word-embedding lookup whose gradient is a sorted segment sum (kernel D).

Replaces `digat_tpu/ops/pallas/emb_grad.py` (`embedding_lookup`, whose
backward runs `sorted_rowsum` -> `_rowsum_kernel`). The forward is the
gather `table[tok]`, as in the JAX package. The backward is

    dW[v] = sum of g[k] over the token slots k with tok[k] == v  (0 if none)

On a CPU tensor it is `embedding_grad_plain` (`index_add_`). On a CUDA
tensor it is kernel D (`csrc/emb_grad.cu`): the token stream is sorted on
the device (stable `torch.sort`), cut into segments (runs of one token
within chunks of `CHUNK` sorted slots), each segment summed by one warp,
and each table row then sums its segments in order. The JAX package built
its work list on the host for the TPU's scalar prefetch; here every piece
of sort metadata is made on the device, with no host round trip. The sum
is deterministic (no atomics).
"""

from __future__ import annotations

import torch

from digat_tpu_torch.ops import build

CHUNK = 32  # sorted slots per warp in the segment pass


def embedding_grad_plain(tok, g, vocab_size: int):
    """Plain PyTorch version of kernel D: tok [...] int, g [..., D] ->
    dW [V, D]."""
    D = g.shape[-1]
    out = torch.zeros((vocab_size, D), dtype=g.dtype, device=g.device)
    return out.index_add_(0, tok.reshape(-1), g.reshape(-1, D))


def sort_metadata(tok, vocab_size: int, chunk: int = CHUNK):
    """(perm, seg, first, last, segments) for the flat token stream: the
    stable sort permutation, each sorted slot's segment, the [first, last)
    sorted slots of every table row, and a bound on the segment count."""
    ids, perm = torch.sort(tok.reshape(-1), stable=True)
    n = ids.numel()
    start = torch.arange(n, device=ids.device) % chunk == 0
    start[1:] |= ids[1:] != ids[:-1]
    seg = torch.cumsum(start, 0) - 1
    rows = torch.arange(vocab_size, dtype=ids.dtype, device=ids.device)
    first = torch.searchsorted(ids, rows)
    last = torch.searchsorted(ids, rows, right=True)
    return perm, seg, first, last, -(-n // chunk) + min(vocab_size, n)


def embedding_grad(tok, g, vocab_size: int):
    """Kernel D. Same arguments and result as `embedding_grad_plain`."""
    if not build.use_kernel(g):
        return embedding_grad_plain(tok, g, vocab_size)
    if tok.device != g.device:
        raise ValueError(f"embedding_grad: tok on {tok.device}, g on {g.device}")
    D = g.shape[-1]
    if g.dtype != torch.float32 or D % 4 or D > 512:
        raise ValueError(f"embedding_grad: g must be float32 with D % 4 == 0 and D <= 512, "
                         f"got {g.dtype} D={D}")
    if tok.shape != g.shape[:-1]:
        raise ValueError(f"embedding_grad: tok {tuple(tok.shape)} does not match g "
                         f"{tuple(g.shape)}")
    g2 = g.reshape(-1, D).contiguous()
    perm, seg, first, last, segments = sort_metadata(tok.long(), vocab_size)
    partial = torch.empty((segments, D), dtype=torch.float32, device=g.device)
    out = torch.empty((vocab_size, D), dtype=torch.float32, device=g.device)
    with build.launch_on(g.device) as (lib, stream):
        err = lib.emb_grad_f32(g2.data_ptr(), perm.data_ptr(), seg.data_ptr(), first.data_ptr(),
                               last.data_ptr(), partial.data_ptr(), out.data_ptr(), g2.shape[0],
                               vocab_size, D, CHUNK, stream)
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
