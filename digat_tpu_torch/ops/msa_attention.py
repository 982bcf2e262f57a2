"""Masked multi-head self-attention over packed heads, forward and backward
(the kernel pair that stands in for TPU kernels E and F).

Replaces `digat_tpu/ops/pallas/msa_attention.py::msa_attention` (F: the
forward `_fwd_kernel` and the custom-VJP backward `_bwd_kernel`) and, through
`ops.msa_attention_grouped`, `msa_attention_grouped` (E). Per head:

    out = softmax(where(key_mask, q k^T / sqrt(dk), -1e9)) v

on projections laid out [N, L, H * dk]. The mask is a select, as the
reference's `masked_fill` and the JAX package's XLA path (`_attention_xla`)
take it: a masked key passes no gradient. (E and F add -1e9 to the scores
instead; the two differ only on a sequence whose keys are all masked, where
the sum rounds to -1e9 for every key and E and F pass a gradient to q and k.)

On a CPU tensor `msa_attention` runs `_attention_plain`, whose gradients
are autograd's. On a CUDA tensor it goes through `MSAAttentionFunction`:
forward `attention_fwd`, backward `attention_bwd`, both launching
`csrc/msa_attention.cu` (whose kernels' header, `msa_attention_kernels.cuh`,
says what bounds them on the card and how they are laid out) or raising.

bf16 (`compute_dtype` bfloat16): q, k, v and do may be bf16, as the TPU
kernels take them; the outputs are then bf16 too. The kernels' bf16
instances (`csrc/msa_attention_bf16.cu`, launch counters `launches_bf16`)
and the plain version both compute in fp32 from the bf16 values and round
each output once, as the TPU kernels do (the JAX package's XLA path,
`_attention_xla`, rounds the scores and the probabilities to bf16 instead).
The fp32 register-row kernels (dk <= 64) keep one head of one sequence in
the shared memory of a warp (L <= SHORT_L) or of a block, so a sequence
longer than `max_length(dk)` raises, as does a head wider than the widest
of `WIDTHS`; there is no fallback. The bf16 register-row instance (dk <=
64, `csrc/msa_attention_bf16.cuh`) runs its products on the tensor cores
on groups of heads copied as bf16 (`bf16_geometry`); its forward streams
the keys and takes any L, its backward past SHORT_L keeps three floats of
row statistics a head and row in shared memory, which caps L
(`max_length(dk, itemsize=2)`). The wide instance (dk 65-128,
`csrc/msa_attention_wide.cu`, launch counters `launches_wide` and
`launches_wide_bf16`) streams its keys through shared memory in tiles and
takes any L (`max_length` None).
"""

from __future__ import annotations

import math

import torch

from digat_tpu_torch.ops import build

MASK_FILL = -1e9  # layers.MASK_FILL; layers imports this module for `mha`
# an sm_90 block's opt-in shared memory (227 KB); the C entry points check
# the device's own limit again
MAX_SMEM_BYTES = 232_448
# the kernels' compiled head widths: dk is padded up to the first that holds
# it (as csrc/msa_attention.cu's kWidths, then its wide instance kWide)
WIDTHS = (8, 16, 20, 24, 32, 48, 64, 128)
WIDE = 128  # the wide instance: tensor-core tiles, keys streamed, 4 warps a block
WIDE_WARPS = 4  # warps of a wide block, 16 rows each
# rows of a tile the wide kernels stream through shared memory, by the
# operands' itemsize: fp32 16, bf16 32
WIDE_TILES = {4: 16, 2: 32}


def head_width(dk: int) -> int:
    """The compiled width W that a head of dk lanes is padded to."""
    for w in WIDTHS:
        if dk <= w:
            return w
    raise ValueError(f"msa_attention: head width {dk} is wider than the widest the kernels "
                     f"take ({WIDTHS[-1]})")


def bf16_width(dk: int) -> int:
    """The bf16 register-row instance's padded head width: dk rounded up to
    16, the depth of an m16n8k16 product (20 and 25 -> 32)."""
    return 16 * -(-dk // 16)


def launch_plan(pointers, rs: int, hs: int, dk: int, itemsize: int = 4) -> tuple:
    """(W, vector) of the kernel instantiation that the C entry points pick
    for these operands, by the same rule: the width `head_width(dk)`, and
    loads and stores of four elements where the row stride rs and the head
    stride hs (in elements) are multiples of 4 and every pointer
    (`data_ptr()`) is aligned to four elements of `itemsize` bytes, scalar
    ones otherwise. The bf16 register-row instance (itemsize 2, dk <= 64):
    the width `bf16_width(dk)`, and 16-byte copies of groups of heads where
    rs is a multiple of 8 elements and every pointer is 16-byte aligned,
    element copies of single heads otherwise."""
    if itemsize == 2 and head_width(dk) != WIDE:
        return bf16_width(dk), rs % 8 == 0 and all(p % 16 == 0 for p in pointers)
    vector = rs % 4 == 0 and hs % 4 == 0 and all(p % (4 * itemsize) == 0 for p in pointers)
    return head_width(dk), vector


SHORT_L = 32  # the longest L at which a warp owns a head of a sequence


def _row_stride(W: int) -> int:
    """Floats between two rows in the kernels' shared memory."""
    return W if W % 8 else W + 4


def _wide_geometry(L: int) -> tuple:
    """(warps a unit, units a block, own rows a unit and block) of the wide
    kernels at L, as csrc/msa_attention_wide.cu's `wide_geom`: beyond L 32 a
    block's 4 warps own 64 rows of one (sequence, head), 16 each; at L 17-32
    two units of 2 warps, at L <= 16 four of one."""
    wpu = 1 if L <= 16 else 2 if L <= 32 else 4
    return wpu, WIDE_WARPS // wpu, 16 * wpu


def _wide_block_bytes(L: int, kind: str, itemsize: int = 4) -> int:
    """Shared memory of one block of a wide kernel (`kind` "fwd", the
    backward's "rows" passes or its "cols" pass), as `wide_unit_bytes`
    counts it, rows of the operands' type (`itemsize` 4: fp32 rows
    `_row_stride(128)` floats apart; 2: bf16 rows 136 apart): per unit its
    own rows (q; q and do; k and v); the column pass's statistics of two
    stages of streamed rows (3 floats a row) and its own keys' mask bytes,
    or the row passes' two stages of streamed keys' mask bytes; then one
    stage (L <= KT) or two of two streamed arrays of KT = WIDE_TILES[itemsize]
    rows. It does not grow with L."""
    wpu, upb, ot = _wide_geometry(L)
    row = itemsize * (_row_stride(WIDE) if itemsize == 4 else WIDE + 8)
    KT = WIDE_TILES[itemsize]
    own = (1 if kind == "fwd" else 2) * ot * row
    small = 4 * 2 * 3 * KT + ot if kind == "cols" else 2 * KT
    stages = 2 if L > KT else 1
    return upb * (own + small + stages * 2 * KT * row)


def _smem_bytes(L: int, dk: int, backward: bool, itemsize: int = 4) -> int:
    """Shared memory that one launch needs at the least (as
    csrc/msa_attention.cuh counts it for the fp32 register-row instance; the
    bf16 one counts its own, `_bf16_smem_bytes`), with rows `_row_stride(W)`
    floats apart in the backward and W apart in the forward, then L mask
    bytes rounded up to 16, for one (sequence, head): the forward's k and v
    rows;
    the backward's q, do, k and v rows and, at L <= SHORT_L, the [L][32]
    score tiles P and S, beyond that three floats of statistics per row. The
    wide instance (dk 65-128): one block (`_wide_block_bytes`, whose rows
    are of the operands' `itemsize`; the backward's larger kernel, its
    column pass)."""
    W = head_width(dk)
    KS = _row_stride(W)
    if W == WIDE:
        return _wide_block_bytes(L, "cols" if backward else "fwd", itemsize)
    if not backward:
        floats = 2 * L * W
    elif L <= SHORT_L:
        floats = 4 * L * KS + 64 * L
    else:
        floats = 4 * L * KS + 3 * L
    return 4 * (floats + 4 * -(-L // 16))


BF16_TILE = 32  # keys of a tile of scores in the bf16 register-row kernels (kKT)
BF16_RESIDENT_WARPS = 4  # warps of a resident bf16 block at most (kRWarps)
BF16_RESIDENT = 64  # the longest L whose rows a bf16 block holds whole (kResL)
BF16_STAGES = 3  # units a resident bf16 block has in flight at most (kStages)


def bf16_kind(L: int, backward: bool) -> str:
    """The bf16 register-row kernel that the C entry points run: the resident
    forward "fwd" (L <= BF16_RESIDENT) or the streamed "fwd_long"; the
    resident backward "short" (L <= SHORT_L: p and ds kept) or "mid", or
    the streamed "long"."""
    if not backward:
        return "fwd" if L <= BF16_RESIDENT else "fwd_long"
    return "short" if L <= SHORT_L else "mid" if L <= BF16_RESIDENT else "long"


def bf16_geometry(kind: str, L: int, heads: int, hs: int, vector: bool) -> tuple:
    """(g, groups, se, sr, qr, warps) of a bf16 register-row launch, as
    csrc/msa_attention_bf16.cuh's `bgeom`: g heads a group (8 / gcd(hs, 8)
    with 16-byte copies, so that a group's columns start and end on 16
    bytes; 1 with element copies; at most `heads`), groups a sequence, a
    span row's elements se (g hs rounded up to 8) and the shared row stride
    sr (se, or se + 8 where se / 8 is even: rows 16 bytes off a multiple of
    32), a block's own rows qr and its warps. A task is a head and 32 rows
    in the forwards, 16 in the backwards. Resident kernels ("fwd", "short",
    "mid") hold L rounded up to 16 rows and run min(BF16_RESIDENT_WARPS,
    tasks) warps, which take the tasks in turn; streamed ones own a chunk of
    rows (a task's rows times max(1, 4 // g), at most L rounded up to 16)
    and run a warp a task."""
    g = min(8 // math.gcd(hs, 8) if vector else 1, heads)
    lp = -(-L // 16) * 16
    se = -(-g * hs // 8) * 8
    sr = se if (se // 8) % 2 else se + 8
    if kind in ("fwd", "short", "mid"):
        tasks = g * (-(-lp // 32) if kind == "fwd" else lp // 16)
        return g, -(-heads // g), se, sr, lp, min(BF16_RESIDENT_WARPS, tasks)
    rows = 32 if kind == "fwd_long" else 16  # a streamed task's rows
    qr = min(lp, rows * max(1, 4 // g))
    return g, -(-heads // g), se, sr, qr, g * -(-qr // rows)


def _bf16_smem_bytes(kind: str, L: int, heads: int, hs: int, vector: bool,
                     stages: int = 1) -> int:
    """Shared memory of one bf16 register-row block, as `bf16_smem` counts
    it (rows of sr bf16), with `stages` units in flight in a resident one: a
    stage per unit of q, k and v [lp] (forward) or q, do, k and v (backward)
    and its lp mask bytes; the backward's staged dq [lp] and per head either
    p and ds as bf16 hi and lo [lp][lp + 8] ("short") or three floats of
    statistics a row ("mid"). Streamed: the forward's q rows [qr] and two
    stages of k and v tiles with their mask bytes; the backward's own rows
    (two arrays of qr), two stages of two streamed tiles, three floats of
    statistics a head and row (rows rounded up to BF16_TILE) and the mask
    bytes."""
    g, _, _, sr, qr, _ = bf16_geometry(kind, L, heads, hs, vector)
    row, T, lp = 2 * sr, BF16_TILE, -(-L // 16) * 16
    if kind == "fwd":
        return stages * (3 * lp * row + lp)
    if kind in ("short", "mid"):
        own = g * 4 * lp * (lp + 8) * 2 if kind == "short" else 3 * g * lp * 4
        return stages * (4 * lp * row + lp) + lp * row + own
    if kind == "fwd_long":
        return qr * row + 2 * (2 * T * row + T)
    lr = -(-L // T) * T
    return 2 * qr * row + 4 * T * row + 12 * g * lr + lr


def bf16_stages(kind: str, L: int, heads: int, hs: int, vector: bool) -> int:
    """Units a resident bf16 block has in flight, as `bf16_stages`: the most
    up to BF16_STAGES whose shared memory fits a block (0: not one); 1 for a
    streamed kernel that fits."""
    top = BF16_STAGES if kind in ("fwd", "short", "mid") else 1
    for stages in range(top, 0, -1):
        if _bf16_smem_bytes(kind, L, heads, hs, vector, stages) <= MAX_SMEM_BYTES:
            return stages
    return 0


def _bf16_need(L: int, heads: int, hs: int, backward: bool) -> int:
    """The least shared memory of a bf16 register-row block (one unit in
    flight), the larger of 16-byte and element copies (the pointers choose
    between them)."""
    kind = bf16_kind(L, backward)
    return max(_bf16_smem_bytes(kind, L, heads, hs, v) for v in (True, False))


def warps_per_block(warp_bytes: int, sm_bytes: int, regs: int = 0,
                    block_bytes: int = MAX_SMEM_BYTES, sm_regs: int = 65_536) -> int:
    """The warps (1-4) of a block of independent warps that the C entry
    points launch, as they pick it: the most warps resident on an SM of
    `sm_bytes` shared memory and `sm_regs` registers, for one warp's shared
    memory `warp_bytes` and the kernel's `regs` per thread (allocated 256 a
    warp; 0: not counted); the card keeps 1 KB per block and runs at most
    32 blocks and 64 warps an SM; the larger block on a tie; 0 if not one
    warp fits `block_bytes`."""
    reg_warps = sm_regs // (-(-regs // 8) * 8 * 32) if regs else 64
    best, best_resident = 0, 0
    for warps in range(1, 5):
        block = warps * warp_bytes
        if block > block_bytes:
            break
        blocks = min(sm_bytes // (block + 1024), reg_warps // warps, 32, 64 // warps)
        if blocks * warps >= best_resident:
            best, best_resident = warps, blocks * warps
    return best


def block_shape(L: int, dk: int, backward: bool, sm_bytes: int, regs: int = 0,
                itemsize: int = 4) -> tuple:
    """(warps, shared bytes) of the blocks the C entry points launch: the
    wide instance WIDE_WARPS (`_wide_geometry`); beyond SHORT_L min(8,
    ceil(L / 32)) warps on one (sequence, head); otherwise `warps_per_block`
    independent warps, one each; `itemsize` of the operands (the wide
    instance's rows are of their type)."""
    need = _smem_bytes(L, dk, backward, itemsize)
    if head_width(dk) == WIDE:
        return WIDE_WARPS, need
    if L > SHORT_L:
        return min(8, -(-L // 32)), need
    warps = warps_per_block(need, sm_bytes, regs)
    return warps, warps * need


def max_length(dk: int, backward: bool = True, itemsize: int = 4, heads: int = 8,
               hs: int | None = None):
    """The longest sequence the kernel takes at head width dk; None for the
    wide instance (dk 65-128), whose shared memory does not grow with L, and
    for the bf16 register-row forward (itemsize 2), which streams its keys.
    The bf16 register-row backward's cap depends on its head group (heads
    of stride hs, default dk)."""
    if head_width(dk) == WIDE or (itemsize == 2 and not backward):
        return None
    if itemsize == 2:
        hs = dk if hs is None else hs
        lo, hi = BF16_RESIDENT, 1 << 20  # _bf16_need(lo) fits, _bf16_need(hi) does not
        while hi - lo > 1:
            mid = (lo + hi) // 2
            fits = _bf16_need(mid, heads, hs, True) <= MAX_SMEM_BYTES
            lo, hi = (mid, hi) if fits else (lo, mid)
        return lo
    L = 1
    while _smem_bytes(L + 1, dk, backward) <= MAX_SMEM_BYTES:
        L += 1
    return L


def _attention_plain(q, k, v, heads: int, mask=None):
    """Plain PyTorch version, the counterpart of `_attention_xla`. q, k, v
    [N, L, H * dk]; mask [N, L] bool or None -> [N, L, H * dk]. bf16
    operands are upcast to fp32 and the result rounded once to bf16, as the
    kernels compute (autograd then rounds each gradient once too)."""
    if q.dtype == torch.bfloat16:
        return _attention_plain(q.float(), k.float(), v.float(), heads, mask).to(q.dtype)
    N, L, D = q.shape
    dk = D // heads
    qh, kh, vh = (t.reshape(N, L, heads, dk) for t in (q, k, v))
    s = torch.einsum("nihd,njhd->nhij", qh, kh) / math.sqrt(float(dk))
    if mask is not None:
        s = torch.where(mask[:, None, None, :].to(torch.bool), s,
                        torch.full((), MASK_FILL, dtype=s.dtype, device=s.device))
    acc = torch.promote_types(vh.dtype, torch.float32)
    a = torch.softmax(s.to(acc), dim=-1).to(vh.dtype)
    return torch.einsum("nhij,njhd->nihd", a, vh).reshape(N, L, D)


def attention_bwd_plain(q, k, v, mask, do, heads: int, dk: int):
    """Plain PyTorch version of the backward on either layout: autograd
    through the plain forward (on the heads' first dk lanes, as the kernel
    reads them). Returns (dq, dk, dv) in the layout of q."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_plain_strided(*leaves, heads, dk, mask)
        return torch.autograd.grad(out, leaves, do)


def attention_plain_strided(q, k, v, heads: int, dk: int, mask=None):
    """Plain PyTorch version of the forward on either layout: heads hs =
    width / heads lanes apart, of which the first dk are read; the other
    lanes of the result are zero."""
    N, L, width = q.shape
    hs = width // heads
    if hs == dk:
        return _attention_plain(q, k, v, heads, mask)
    unpad = lambda t: t.reshape(N, L, heads, hs)[..., :dk].reshape(N, L, heads * dk)
    out = _attention_plain(unpad(q), unpad(k), unpad(v), heads, mask)
    return torch.nn.functional.pad(out.reshape(N, L, heads, dk),
                                   (0, hs - dk)).reshape(N, L, width)


def _check(q, k, v, mask, heads, dk, backward, what):
    """Shapes, types and sizes the kernels take -> (N, L, rs, hs)."""
    N, L, rs = q.shape
    if rs % heads or rs // heads < dk:
        raise ValueError(f"{what}: width {rs} is not {heads} heads of at least {dk} lanes")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or tuple(t.shape) != (N, L, rs) or t.device != q.device:
            raise ValueError(f"{what}: {name} must be {q.dtype} {(N, L, rs)} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (N, L)
                             or mask.device != q.device):
        raise ValueError(f"{what}: mask must be bool [{N}, {L}] on {q.device}, got "
                         f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
    hs = rs // heads
    if q.dtype == torch.bfloat16 and head_width(dk) != WIDE:
        need = _bf16_need(L, heads, hs, backward)
        if need > MAX_SMEM_BYTES:
            raise ValueError(f"{what}: a sequence of {L} at head width {dk} needs {need} bytes "
                             f"of shared memory (a group of heads of one sequence per block), "
                             f"more than the {MAX_SMEM_BYTES} a block has; the longest it takes "
                             f"is {max_length(dk, backward, 2, heads, hs)}")
        return N, L, rs, hs
    need = _smem_bytes(L, dk, backward)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: a sequence of {L} at head width {dk} needs {need} bytes of "
                         f"shared memory (one head of one sequence per warp), more than the "
                         f"{MAX_SMEM_BYTES} a block has; the longest it takes is "
                         f"{max_length(dk, backward)}")
    return N, L, rs, hs


def _ptr(mask):
    return 0 if mask is None else mask.data_ptr()


def _bf16(t) -> bool:
    return t.dtype == torch.bfloat16


def _count(wrapper, q, dk: int) -> None:
    """One launch on the counter of the instance that ran: `launches` (fp32)
    or `launches_bf16`, with `_wide` for the wide instance."""
    name = "launches" + ("_wide" if head_width(dk) == WIDE else "") + \
        ("_bf16" if _bf16(q) else "")
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def attention_fwd(q, k, v, mask, heads: int, dk: int):
    """The forward kernel on either layout (heads width / heads lanes apart,
    the first dk read) -> out in the layout and dtype of q (the fp32 or the
    bf16 instance)."""
    N, L, rs, hs = _check(q, k, v, mask, heads, dk, False, "msa_attention")
    out = torch.empty((N, L, rs), dtype=q.dtype, device=q.device)
    if N == 0:
        return out
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = None if mask is None else mask.contiguous()
    with build.launch_on(q.device) as (lib, stream):
        fn = lib.msa_attention_fwd_bf16 if _bf16(q) else lib.msa_attention_fwd_f32
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), out.data_ptr(), N, heads,
                 L, dk, rs, hs, 1.0 / math.sqrt(float(dk)), stream)
    build.check(lib, err, "msa_attention")
    _count(attention_fwd, q, dk)
    return out


def attention_bwd(q, k, v, mask, do, heads: int, dk: int):
    """The backward kernel -> (dq, dk, dv) in the layout and dtype of q."""
    N, L, rs, hs = _check(q, k, v, mask, heads, dk, True, "msa_attention backward")
    if do.dtype != q.dtype or do.shape != q.shape or do.device != q.device:
        raise ValueError(f"msa_attention backward: do must be {q.dtype} {tuple(q.shape)} on "
                         f"{q.device}, got {do.dtype} {tuple(do.shape)} on {do.device}")
    dq, dkk, dv = (torch.empty((N, L, rs), dtype=q.dtype, device=q.device) for _ in range(3))
    if N == 0:
        return dq, dkk, dv
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    mask = None if mask is None else mask.contiguous()
    with build.launch_on(q.device) as (lib, stream):
        fn = lib.msa_attention_bwd_bf16 if _bf16(q) else lib.msa_attention_bwd_f32
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), do.data_ptr(),
                 dq.data_ptr(), dkk.data_ptr(), dv.data_ptr(), N, heads, L, dk, rs, hs,
                 1.0 / math.sqrt(float(dk)), stream)
    build.check(lib, err, "msa_attention backward")
    _count(attention_bwd, q, dk)
    return dq, dkk, dv


class MSAAttentionFunction(torch.autograd.Function):
    """The kernel pair as an autograd Function (CUDA tensors), on either
    layout; bf16 operands take the bf16 instances and get bf16 gradients."""

    @staticmethod
    def forward(ctx, q, k, v, mask, heads, dk):
        ctx.save_for_backward(q, k, v, mask)
        ctx.args = (heads, dk)
        return attention_fwd(q, k, v, mask, heads, dk)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        return (*attention_bwd(q, k, v, mask, do.contiguous(), *ctx.args), None, None, None)


def msa_attention(q, k, v, heads: int, mask=None):
    """softmax(q k^T / sqrt(dk), key-masked) v per head over packed [N, L,
    heads * dk] projections (fp32, or bf16 with a bf16 result); mask [N, L]
    bool or None. Differentiable in q, k and v."""
    if not build.use_kernel(q):
        return _attention_plain(q, k, v, heads, mask)
    mask = None if mask is None else mask.to(torch.bool)
    return MSAAttentionFunction.apply(q, k, v, mask, heads, q.shape[-1] // heads)


attention_fwd.launches = 0  # the register-row instances (dk <= 64)
attention_bwd.launches = 0
attention_fwd.launches_bf16 = 0
attention_bwd.launches_bf16 = 0
attention_fwd.launches_wide = 0  # the wide instance (dk 65-128)
attention_bwd.launches_wide = 0
attention_fwd.launches_wide_bf16 = 0
attention_bwd.launches_wide_bf16 = 0
