"""Fused MSA news encoder: embedded titles -> pooled news vectors, forward
(kernel A) and recompute backward (kernel A').

Replaces `digat_tpu/ops/pallas/msa_encoder.py::msa_encoder_pooled`: the
forward `_fwd_kernel` and the custom-VJP backward `_bwd_kernel` (and its
restructured `_bwd_kernel_v2`, same gradients). Per title: word dropout,
Q/K/V projections, multi-head UNMASKED softmax attention (pads attend),
ReLU, and the masked tanh-MLP attention pool (-1e9 fill, fp32 softmax).
Heads are not padded: the result is [N, H*dk]. The kernels take titles of
any length L from 1 to 128 and heads of dk up to 128, the shapes at which
the JAX package runs its kernel (`group_size(heads, L, dk) > 0`; the news
encoder sends longer titles to the attention pair). Up to L 32 and dk 64 the
attention runs as a unit of 4 warps with one lane per position (a shorter
title leaves the lanes past L idle); beyond, as the long unit of
`csrc/msa_title.cuh` (one thread per position, the head in chunks of 32
columns).

The word dropout of training is applied inside the kernels: each element of
x is kept with probability 1 - rate and scaled by 1 / (1 - rate), from the
Philox bits of `ops.dropout` at row = title offset, col = position * Din +
feature, under (seed, site). The mask is never stored; the backward draws
it again.

On a CPU tensor `msa_encoder_pooled` runs `msa_encoder_pooled_plain`, whose
gradients are autograd's. On a CUDA tensor it goes through
`MSAEncoderFunction`: forward kernel A (`csrc/msa_encoder.cu`, its two
matrix products on the tensor cores at 3xTF32 through `csrc/tc_gemm.cuh`),
backward kernel A' (`csrc/msa_encoder_bwd.cu`, its six products the same
way); the attention forward, the word dropout and the pool's softmax are
one text in `csrc/msa_title.cuh`, which both include. Each header says what
bounds it on the card and how the design answers that. There is no
fallback: a CUDA tensor launches the kernels or raises.

bf16 (`compute_dtype` bfloat16): x and the weights bf16, the result fp32,
as the JAX kernel takes them. The bf16 instances (`*_bf16` entry points,
their own launch counters `launches_bf16`) run their products on wgmma fed
by the TMA (`csrc/tc_wgmma.cuh`): q|k|v one pass of exact bf16 products
with fp32 sums (one instance for A and A', so the same bits), every other
product with each fp32 operand split into three bf16 terms (three bf16
passes against a bf16 operand, six for dpre^T h): A's pool logits and A''s
u, dO, dx and the weight gradients. A's bf16 attention stage writes h's
three terms as it writes h. Attention and the pool's softmax stay fp32.
The word dropout rounds each kept x / (1 - rate) to bf16 once (round to
nearest even), as the TPU kernel's product rounds its fp32 operand. A' stores dx in bf16, rounded once after the mask, and
returns fp32 weight gradients; autograd rounds those to the bf16 copies'
dtype, as the transpose of JAX's cast does. A bias or pool vector in bf16
is upcast by the wrapper (exact).
"""

from __future__ import annotations

import math

import torch

from digat_tpu_torch.layers import MASK_FILL
from digat_tpu_torch.ops import build
from digat_tpu_torch.ops.dropout import keep_mask_plain, threshold
from digat_tpu_torch.ops.msa_attention import MAX_SMEM_BYTES

SHORT_TITLE_LENGTH, SHORT_HEAD_DIM = 32, 64  # the short unit: a warp lane per position
MAX_TITLE_LENGTH = 128  # the long unit: a thread per position, 4 warps
MAX_HEAD_DIM = 128  # the long unit: the head in chunks of 32 columns
MAX_POOL_DIM = 512  # kernels A and A': the pool kernel's 4 float4 columns a lane


def short_unit(L: int, dk: int) -> bool:
    """Whether a (title, head) runs the short attention unit (L <= 32, dk <=
    64, `short_unit` in csrc/msa_title.cuh) or the long one."""
    return L <= SHORT_TITLE_LENGTH and dk <= SHORT_HEAD_DIM


def relu_fix_smem_bytes(Din: int, dk: int, L: int = SHORT_TITLE_LENGTH) -> int:
    """Shared memory of kernel A''s ReLU-fix block. The short unit's
    (`relu_fix_floats` in csrc/msa_encoder_bwd.cu): a title's x rows, padded
    to an odd number of float4s, one head's dk rows of Wq, Wk or Wv, its q,
    k and v, and the scores; 32 rows whatever the title length. Where that
    exceeds a block's MAX_SMEM_BYTES (Din 900 at dk 25), and for the long
    unit, A' runs the long fix (`msa_attn_relu_fix_long_kernel`), whose
    block holds only the scores [L][L | 1] (its q, k and v go to scratch in
    device memory); this counts the fix that A' runs. q, k, v and the
    scores are float64 (8 bytes), x and W rows fp32."""
    R = SHORT_TITLE_LENGTH  # the short fix's rows, whatever the title's length
    x_stride = Din if (Din // 4) % 2 else Din + 4
    short = 4 * (R * x_stride + dk * Din) + 8 * (3 * R * (dk + 1) + R * (R + 1))
    if short_unit(L, dk) and short <= MAX_SMEM_BYTES:
        return short
    return 8 * L * (L | 1)


class _RoundTo(torch.autograd.Function):
    """x rounded to `dtype` (round to nearest even) and kept in x's dtype;
    the gradient passes unchanged, as the transpose of JAX's cast does."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def drop_titles_plain(x, rate: float, seed: int, site: int):
    """x [N, L, Din] with the kernels' word dropout applied: x / (1 - rate)
    where kept, else 0. A bf16 x is dropped in fp32 and each value rounded
    once to bf16, returned as an fp32 tensor of bf16 values (its gradient
    unrounded)."""
    if rate <= 0.0:
        return x
    N, L, Din = x.shape
    keep = keep_mask_plain(N, L * Din, rate, seed, site, device=x.device).reshape(N, L, Din)
    acc = torch.promote_types(x.dtype, torch.float32)
    xd = torch.where(keep, x.to(acc) * (1.0 / (1.0 - rate)),
                     torch.zeros((), dtype=acc, device=x.device))
    return xd if acc == x.dtype else _RoundTo.apply(xd, x.dtype)


def msa_encoder_pooled_plain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads: int,
                             dropout_rate: float = 0.0, seed: int = 0, site: int = 0):
    """Plain PyTorch version. x [N, L, Din]; mask [N, L] bool; wq/wk/wv
    [Din, H*dk] ([in, out] layout); bq, bv [H*dk]; w1 [H*dk, A]; b1, v [A]
    -> [N, H*dk]. The projections and the attention up to the ReLU run in
    float64 (at least), from the inputs' values: a pre-activation within
    rounding of 0 takes the ReLU's side (and gradient) of its float64 value,
    the side kernel A''s ReLU fix recomputes, whatever order a product
    sums in. The result is then rounded to the inputs' type, fp32 at least
    (bf16 inputs give fp32, as the JAX kernel returns), and the pool runs
    in that type."""
    out_t = torch.promote_types(x.dtype, torch.float32)
    x = drop_titles_plain(x, dropout_rate, seed, site)
    N, L, _ = x.shape
    D = wq.shape[1]
    dk = D // heads
    wide = torch.promote_types(x.dtype, torch.float64)
    xw = x.to(wide)
    q = (xw @ wq.to(wide) + bq.to(wide)).reshape(N, L, heads, dk)
    k = (xw @ wk.to(wide)).reshape(N, L, heads, dk)
    val = (xw @ wv.to(wide) + bv.to(wide)).reshape(N, L, heads, dk)
    a = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(float(dk))
    p = torch.softmax(a, dim=-1)
    h = torch.relu(torch.einsum("nhqk,nkhd->nqhd", p, val).reshape(N, L, D)).to(out_t)
    w1, b1, v = (t.to(out_t) for t in (w1, b1, v))
    lg = torch.tanh(h @ w1 + b1) @ v
    lg = torch.where(mask.to(torch.bool), lg, torch.full_like(lg, MASK_FILL))
    alpha = torch.softmax(lg, dim=-1)
    return torch.einsum("nl,nld->nd", alpha, h)


def msa_encoder_bwd_plain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, dp, heads: int,
                          dropout_rate: float = 0.0, seed: int = 0, site: int = 0):
    """Plain PyTorch version of kernel A': autograd through the plain forward
    on the dropped titles, then the dropout mask on their gradient. Returns
    (dx, dwq, dbq, dwk, dwv, dbv, dw1, db1, dv) in the layouts of the
    arguments: dx in x's dtype (bf16 rounded once, after the mask), the
    weight gradients in fp32 at least (bf16 weights give fp32 gradients, as
    kernel A' returns them)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xd = drop_titles_plain(x, dropout_rate, seed, site)
    with torch.enable_grad():
        leaves = [t.detach().to(acc).requires_grad_(True)
                  for t in (xd, wq, bq, wk, wv, bv, w1, b1, v)]
        out = msa_encoder_pooled_plain(leaves[0], mask, *leaves[1:], heads)
        grads = torch.autograd.grad(out, leaves, dp.to(out.dtype))
    return (drop_titles_plain(grads[0], dropout_rate, seed, site).to(x.dtype), *grads[1:])


def _check(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads, what):
    """Shapes, types and layouts the CUDA kernels take -> (N, L, Din, D, dk, A).
    x and every weight float32, or x and the matrices bfloat16 with the
    vectors bfloat16 or float32 (the bf16 instance)."""
    N, L, Din = x.shape
    D = wq.shape[1]
    A = w1.shape[1]
    if D % heads:
        raise ValueError(f"{what}: D={D} not divisible by heads={heads}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (N, L):
        raise TypeError(f"{what}: mask must be bool [N, L], got {mask.dtype} {tuple(mask.shape)}")
    if not 1 <= L <= MAX_TITLE_LENGTH:
        raise ValueError(f"{what}: the kernels take titles of length 1 to {MAX_TITLE_LENGTH}, "
                         f"got {L}")
    if Din % 4 or D % 4:
        raise ValueError(f"{what}: Din={Din} and D={D} must be multiples of 4")
    shapes = {"wq": (wq, (Din, D)), "wk": (wk, (Din, D)), "wv": (wv, (Din, D)),
              "bq": (bq, (D,)), "bv": (bv, (D,)), "w1": (w1, (D, A)), "b1": (b1, (A,)),
              "v": (v, (A,))}
    for name, (t, shape) in shapes.items():
        dtypes = (x.dtype,) if t.dim() == 2 or x.dtype == torch.float32 else \
            (torch.bfloat16, torch.float32)
        if tuple(t.shape) != shape or t.dtype not in dtypes or t.device != x.device:
            raise ValueError(f"{what}: {name} must be {' or '.join(map(str, dtypes))} {shape} "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{what}: x and mask must be contiguous")
    return N, L, Din, D, D // heads, A


def _refuse_shapes(dk: int, A: int, what: str) -> None:
    """The kernels' limits on the head and pool widths, raised before any
    launch."""
    if dk > MAX_HEAD_DIM or A % 4 or A > MAX_POOL_DIM:
        raise ValueError(f"{what}: the kernel takes dk <= {MAX_HEAD_DIM} and A a multiple of 4 "
                         f"up to {MAX_POOL_DIM}, got dk={dk} A={A}")


def _stacked_qkv(wq, bq, wk, wv, bv):
    """The Q|K|V weights stacked [3D, Din] (nn.Linear layout, their dtype)
    and their bias [bq | 0 | bv] in fp32 at least, as the kernels' products
    read them."""
    wqkv = torch.cat([wq.t(), wk.t(), wv.t()]).contiguous()
    bq, bv = _upcast(bq), _upcast(bv)
    return wqkv, torch.cat([bq, torch.zeros_like(bq), bv]).contiguous()


def _upcast(v):
    """A bf16 vector in fp32 (exact); fp32 and fp64 as they are."""
    return v.to(torch.promote_types(v.dtype, torch.float32))


def _suffix(x) -> str:
    """The C entry points' suffix of an input dtype: f32 or bf16."""
    return "bf16" if x.dtype == torch.bfloat16 else "f32"


def _count(fn, x) -> None:
    """One launch more on fn's counter of x's instance."""
    if x.dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _dropout_args(rate: float, seed: int, site: int):
    """(thresh, drop_scale, seed, site) as the kernels take them."""
    return (threshold(rate), 1.0 / (1.0 - rate) if rate > 0 else 1.0, seed & 0xFFFFFFFF,
            site & 0xFFFFFFFF)


def _linear_layout(*ws):
    """Weights passed as [in, out] -> contiguous [out, in] (nn.Linear layout);
    a `linear.weight.t()` view is read in place."""
    out = [w.t().contiguous() for w in ws]
    if any(t.data_ptr() % 16 for t in out):
        raise ValueError("msa_encoder: the weights must be 16-byte aligned")
    return out


def _forward_kernel(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads, rate, seed, site):
    N, L, Din, D, dk, A = _check(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads,
                                 "msa_encoder_pooled")
    _refuse_shapes(dk, A, "msa_encoder_pooled")
    if x.data_ptr() % 16:
        raise ValueError("msa_encoder_pooled: x must be 16-byte aligned")
    out = torch.empty((N, D), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    wqkv, bqkv = _stacked_qkv(wq, bq, wk, wv, bv)
    (w1_r,) = _linear_layout(w1)
    b1, v = _upcast(b1).contiguous(), _upcast(v).contiguous()
    with build.launch_on(x.device) as (lib, stream):
        scratch = torch.empty(lib.msa_encoder_fwd_scratch_floats(
            N, L, Din, heads, dk, A, int(rate > 0), int(x.dtype == torch.bfloat16)),
            dtype=torch.float32, device=x.device)
        err = getattr(lib, f"msa_encoder_pooled_{_suffix(x)}")(
            x.data_ptr(), mask.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), w1_r.data_ptr(),
            b1.data_ptr(), v.data_ptr(), out.data_ptr(), scratch.data_ptr(), N, L, Din, heads,
            dk, A, 1.0 / math.sqrt(float(dk)), *_dropout_args(rate, seed, site), stream,
        )
    build.check(lib, err, "msa_encoder_pooled")
    _count(msa_encoder_pooled, x)
    return out


def msa_encoder_bwd(x, mask, wq, bq, wk, wv, bv, w1, b1, v, dp, heads: int,
                    dropout_rate: float = 0.0, seed: int = 0, site: int = 0):
    """Kernel A'. Same arguments and result as `msa_encoder_bwd_plain`
    (which it runs for a CPU tensor)."""
    if not build.use_kernel(x):
        return msa_encoder_bwd_plain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, dp, heads,
                                     dropout_rate, seed, site)
    N, L, Din, D, dk, A = _check(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads,
                                 "msa_encoder_bwd")
    if tuple(dp.shape) != (N, D) or dp.dtype != torch.float32:
        raise ValueError(f"msa_encoder_bwd: dp must be float32 [{N}, {D}], got {dp.dtype} "
                         f"{tuple(dp.shape)}")
    _refuse_shapes(dk, A, "msa_encoder_bwd")
    if x.data_ptr() % 16:
        raise ValueError("msa_encoder_bwd: x must be 16-byte aligned")
    dev = x.device
    wqkv, bqkv = _stacked_qkv(wq, bq, wk, wv, bv)
    (w1_r,) = _linear_layout(w1)
    dx = torch.empty_like(x)  # bf16 for a bf16 x: rounded once, after the mask
    dwqkv = torch.empty((3 * D, Din), dtype=torch.float32, device=dev)
    dbqkv = torch.empty(3 * D, dtype=torch.float32, device=dev)
    dw1 = torch.empty((A, D), dtype=torch.float32, device=dev)
    db1 = torch.empty(A, dtype=torch.float32, device=dev)
    dv = torch.empty(A, dtype=torch.float32, device=dev)
    if N == 0:
        return (dx, *(torch.zeros_like(t, dtype=torch.float32)
                      for t in (wq, bq, wk, wv, bv, w1, b1, v)))
    dp, b1, v = (_upcast(t).contiguous() for t in (dp, b1, v))
    with build.launch_on(dev) as (lib, stream):
        floats = lib.msa_encoder_bwd_scratch_floats(N, L, Din, heads, dk, A,
                                                    int(x.dtype == torch.bfloat16))
        scratch = torch.empty(floats, dtype=torch.float32, device=dev)
        err = getattr(lib, f"msa_encoder_bwd_{_suffix(x)}")(
            x.data_ptr(), mask.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), w1_r.data_ptr(),
            b1.data_ptr(), v.data_ptr(), dp.data_ptr(), dx.data_ptr(), dwqkv.data_ptr(),
            dbqkv.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
            N, L, Din, heads, dk, A, 1.0 / math.sqrt(float(dk)),
            *_dropout_args(dropout_rate, seed, site), stream,
        )
    build.check(lib, err, "msa_encoder_bwd")
    _count(msa_encoder_bwd, x)
    dwq, dwk, dwv = dwqkv[:D].t(), dwqkv[D:2 * D].t(), dwqkv[2 * D:].t()
    return dx, dwq, dbqkv[:D], dwk, dwv, dbqkv[2 * D:], dw1.t(), db1, dv


class MSAEncoderFunction(torch.autograd.Function):
    """Kernel A forward, kernel A' backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads, rate, seed, site):
        ctx.save_for_backward(x, mask, wq, bq, wk, wv, bv, w1, b1, v)
        ctx.args = (heads, rate, seed, site)
        return _forward_kernel(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads, rate, seed, site)

    @staticmethod
    def backward(ctx, dp):
        x, mask, wq, bq, wk, wv, bv, w1, b1, v = ctx.saved_tensors
        heads, rate, seed, site = ctx.args
        dx, dwq, dbq, dwk, dwv, dbv, dw1, db1, dv = msa_encoder_bwd(
            x, mask, wq, bq, wk, wv, bv, w1, b1, v, dp.contiguous(), heads, rate, seed, site)
        return dx, None, dwq, dbq, dwk, dwv, dbv, dw1, db1, dv, None, None, None, None


def msa_encoder_pooled(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads: int,
                       dropout_rate: float = 0.0, seed: int = 0, site: int = 0):
    """Kernel A (forward) with kernel A' as its backward. Same arguments and
    result as `msa_encoder_pooled_plain`. The kernels read Wq, Wk and Wv
    stacked [3D, Din] (a copy of 1.4 MB a call at the production widths)
    and w1 in nn.Linear layout ([out, in]): a w1 passed as
    `linear.weight.t()`, as the news encoder does, is read in place."""
    if not build.use_kernel(x):
        return msa_encoder_pooled_plain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads,
                                        dropout_rate, seed, site)
    return MSAEncoderFunction.apply(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads,
                                    float(dropout_rate), int(seed), int(site))


msa_encoder_pooled.launches = 0
msa_encoder_pooled.launches_bf16 = 0
msa_encoder_bwd.launches = 0
msa_encoder_bwd.launches_bf16 = 0
