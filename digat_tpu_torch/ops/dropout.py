"""Inverted dropout from Philox4x32-10 keep masks (kernel A'').

Replaces `digat_tpu/ops/pallas/msa_encoder.py::dropout_keep_mask` (mask
logic `_keep_mask`). The TPU drew its bits from the core's own generator,
which has no counterpart here; the port uses Philox4x32-10 (Salmon et al.,
Random123) everywhere a dropout mask is drawn:

  * the stream of a dropout site is keyed by (seed, site), both 32-bit;
  * element (row, col) of a [rows, cols] mask takes word col % 4 of the
    Philox block at counter (col // 4, row_offset + row, 0, 0);
  * it is kept iff that 32-bit draw is >= round(rate * 2^32), so
    P(keep) = 1 - rate, as `_keep_mask` thresholds its bits.

The MSA encoder kernels (`ops.msa_encoder`) draw the word-dropout mask
inline with row = title offset and col = position * Din + feature, and
never store it. `dropout` is the dropout of every other training site
(`layers.dropout`): x seen as [rows, last dim] keeps x * (1 / (1 - rate))
where the mask keeps it and 0 elsewhere. On the CPU it runs `dropout_plain`
(`keep_mask_plain`, the same arithmetic in int64 tensor ops, and
`torch.where`); on a CUDA tensor it is `DropoutFunction`, whose forward
and backward each launch `dropout_apply_f32` of `csrc/dropout.cu` once,
the backward on the gradient under the same (seed, site), so nothing is
saved. The kernel multiplies by the fp32 value of 1 / (1 - rate), as torch
does for `x * (1 / (1 - rate))` on a float32 tensor, so the card equals the
plain version bit for bit, forward and backward. `keep_mask` materialises a
mask (the kernel `dropout_keep_mask_u8` on a CUDA device, `keep_mask_plain`
on the CPU), for the tests and the check that card and CPU draw the same
bits.

On a bf16 tensor (`compute_dtype` bfloat16) the JAX package runs XLA's
`jnp.where(mask, x / keep, 0).astype(x.dtype)`, whose weak-typed `keep`
takes x's dtype: it divides by `bf16_keep(rate)` (0.80078125 at rate 0.2)
in fp32 and rounds the quotient to bf16 (measured on JAX's CPU backend:
the fp32 division rounded once gives its bits). `dropout_plain` does the
same. The card's bf16 instance (`dropout_apply_bf16`, counted on
`dropout.launches_bf16`) multiplies by `bf16_inv_keep(rate)`, the fp32
value of 1 / keep, instead of dividing: over every bf16 x and every bf16
keep above 2^-128 the product rounded to bf16 equals the quotient rounded
to bf16 (`tests/test_torch_bf16_split.py`, exhaustively), and every rate in
[0, 1) gives a keep of 2^-53 or more, so it gives the plain version's
bits, forward and on the gradient (the VJP of x / keep is g / keep, rounded
to bf16). Its index math is 32-bit: a group of four's row is a
multiply-shift division (`divider`), and a tensor of 2^31 groups of four
or more is refused. Kernel A's in-kernel
word dropout keeps its own rule (`ops.msa_encoder.drop_titles_plain`).
"""

from __future__ import annotations

import functools

import torch

from digat_tpu_torch.ops import build

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a 32-bit constant a and int64 b in
    [0, 2^32), without overflowing int64: b is split in 16-bit halves."""
    p = a * (b >> 16)  # < 2^48
    t = ((p & 0xFFFF) << 16) + a * (b & 0xFFFF)  # < 2^49
    return (p >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors. counter: four broadcastable int64
    tensors with values in [0, 2^32); key: two Python ints. Returns the four
    output words as int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def threshold(rate: float) -> int:
    """The 32-bit draw at or above which an element is kept."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int(round(rate * 2**32)), _MASK32)


def keep_mask_plain(rows: int, cols: int, rate: float, seed: int, site: int,
                    row_offset: int = 0, device="cpu") -> torch.Tensor:
    """Plain PyTorch version of kernel A'': the [rows, cols] bool keep mask."""
    groups = -(-cols // 4)
    r = torch.arange(row_offset, row_offset + rows, dtype=torch.int64, device=device)[:, None]
    g = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10((g, r, zero, zero), (seed, site))
    draws = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(rows, groups * 4)
    return draws[:, :cols] >= threshold(rate)


def keep_mask(rows: int, cols: int, rate: float, seed: int, site: int,
              row_offset: int = 0, device="cpu") -> torch.Tensor:
    """Kernel A''. The same mask as `keep_mask_plain`: computed by it on the
    CPU, by the CUDA kernel on a CUDA device."""
    if not build.use_kernel(device):
        return keep_mask_plain(rows, cols, rate, seed, site, row_offset, device)
    thresh = threshold(rate)
    if rows < 0 or cols <= 0 or row_offset < 0 or row_offset + rows > 2**32:
        raise ValueError(f"keep_mask: bad shape rows={rows} cols={cols} row_offset={row_offset}")
    out = torch.empty((rows, cols), dtype=torch.bool, device=device)
    with build.launch_on(out.device) as (lib, stream):
        err = lib.dropout_keep_mask_u8(out.data_ptr(), rows, cols, row_offset, seed & _MASK32,
                                       site & _MASK32, thresh, stream)
    build.check(lib, err, "keep_mask")
    keep_mask.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def bf16_keep(rate: float) -> float:
    """1 - rate rounded to bf16, as a weak-typed scalar meets a bf16 x."""
    return float(torch.tensor(1.0 - rate, dtype=torch.bfloat16))


@functools.lru_cache(maxsize=64)
def bf16_inv_keep(rate: float) -> float:
    """The fp32 value of 1 / bf16_keep(rate) (an fp32 division, rounded to
    nearest): the bf16 kernel's factor."""
    one = torch.ones((), dtype=torch.float32)
    return float(one / torch.tensor(bf16_keep(rate), dtype=torch.float32))


# the bf16 kernel's index limit: groups of four (and a thread's index) in 31 bits
MAX_GROUPS = 2**31 - 1


@functools.lru_cache(maxsize=256)
def divider(d: int) -> tuple:
    """(magic, shift) with n // d == (n * magic) >> shift for every n in
    [0, 2^31) (magic < 2^32): shift = 31 + ceil(log2 d), magic =
    ceil(2^shift / d). The bf16 kernel's division of a group index by the
    row's groups."""
    if not 1 <= d < 2**31:
        raise ValueError(f"divider: d must be in [1, 2^31), got {d}")
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


def dropout_plain(x: torch.Tensor, rate: float, seed: int, site: int) -> torch.Tensor:
    """Plain PyTorch version of `dropout`: the keep mask of x seen as
    [rows, last dim], then where(keep, x * (1 / (1 - rate)), 0); for a bf16
    x where(keep, bf16(x / bf16_keep(rate)), 0), the division in fp32."""
    cols = x.shape[-1]
    keep = keep_mask_plain(x.numel() // cols, cols, rate, seed, site,
                           device=x.device).reshape(x.shape)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        return torch.where(keep, (x.float() / bf16_keep(rate)).to(x.dtype), zero)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), zero)


def _apply(x: torch.Tensor, args) -> torch.Tensor:
    """One launch of `dropout_apply_f32` (or `_bf16`) on the contiguous x;
    `args` ends with the bf16 kernel's (magic, shift) where x is bf16."""
    out = torch.empty_like(x)
    cols = x.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    with build.launch_on(x.device) as (lib, stream):
        fn = lib.dropout_apply_bf16 if bf16 else lib.dropout_apply_f32
        err = fn(x.data_ptr(), out.data_ptr(), x.numel() // cols, cols, 0, *args, stream)
    build.check(lib, err, "dropout")
    if bf16:
        dropout.launches_bf16 += 1
    else:
        dropout.launches += 1
    return out


class DropoutFunction(torch.autograd.Function):
    """Kernel A'' forward on x and backward on the gradient, with the same
    (seed, site): the same bits, so dx = keep * scale * g."""

    @staticmethod
    def forward(ctx, x, args):
        ctx.args = args
        return _apply(x.contiguous(), args)

    @staticmethod
    def backward(ctx, g):
        return _apply(g.contiguous(), ctx.args), None


def dropout(x: torch.Tensor, rate: float, seed: int, site: int) -> torch.Tensor:
    """Inverted dropout of x under (seed, site): `dropout_plain` on the CPU,
    kernel A'' forward and backward on a CUDA tensor (float32, or bfloat16
    by its bf16 instance; `x` may be a view, as the expanded topic nodes
    are)."""
    if not build.use_kernel(x):
        return dropout_plain(x, rate, seed, site)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dropout: the kernel takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        return x.clone()
    args = (seed & _MASK32, site & _MASK32, threshold(rate))
    if x.dtype == torch.bfloat16:
        per_row = -(-x.shape[-1] // 4)
        if x.numel() // x.shape[-1] * per_row > MAX_GROUPS:
            raise ValueError(f"dropout: the bf16 kernel takes fewer than 2^31 groups of four, got "
                             f"{tuple(x.shape)}")
        args += (bf16_inv_keep(rate), *divider(per_row))
    else:
        args += (1.0 / (1.0 - rate),)
    if torch.is_grad_enabled() and x.requires_grad:
        return DropoutFunction.apply(x, args)
    return _apply(x.contiguous(), args)


keep_mask.launches = 0
dropout.launches = 0  # forward and backward launches
dropout.launches_bf16 = 0  # those of the bf16 instance
