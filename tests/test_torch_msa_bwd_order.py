"""Kernel A''s order of work (digat_tpu_torch/csrc/msa_encoder_bwd.cu),
replayed in float64 on the CPU against `msa_encoder_bwd_plain` (1e-12).

The kernel does not follow autograd's order. It moves the pool's two
products out of the per-title kernel into matrix products, splits the
attention into a forward and a backward kernel per (title, head), and
reformulates on the way: each head's part of dalpha = dp . h is taken in the
attention forward and the parts summed in head order; the pool's logits are
the sum of per-warp-column parts of u . v; the attention backward takes
p_ij = exp(s_ij - lse_i) from the forward's log-sum-exp, t_i = sum_j p_ij
dp_ij as four per-warp parts (8 keys each) summed in order, and the bias
gradients as per-title column sums summed in title order; the weight
gradients sum fixed row slices in order. The replay runs those steps with
the kernel's cuts and shows that they compute what the plain version does,
at L 32 and at titles of L < 32 on the first L of the 32 slots (p_ij and
dS_ij 0 past L; each warp's part of t_i over its 8 slots)."""

import math

import numpy as np
import pytest
import torch

from digat_tpu_torch.ops import msa_encoder as ME
from digat_tpu_torch.ops.dropout import keep_mask_plain

L = 32
SLOTS = 32  # title slots of an attention unit
WARPS = 4  # warps of an attention unit; each takes 8 key slots in the row pass
POOL_BN = 128  # the pool product's tile width; 4 warp columns a tile
ROWS_PER_SPLIT = 64  # a cut of the kernel's fixed row slices, scaled to the test


def replay(x, mask, wq, bq, wk, wv, bv, w1, b1, v, dp, heads, rate, seed, site):
    N, L, Din = x.shape
    D, A = wq.shape[1], w1.shape[1]
    dk = D // heads
    scale = 1.0 / math.sqrt(dk)
    M = N * L
    xd = ME.drop_titles_plain(x, rate, seed, site).reshape(M, Din)
    # 2. the Q|K|V product with its bias
    wqkv = torch.cat([wq.t(), wk.t(), wv.t()])  # [3D, Din]
    qkv = xd @ wqkv.t() + torch.cat([bq, torch.zeros_like(bq), bv])
    q, k, val = (qkv[:, i * D:(i + 1) * D].reshape(N, L, heads, dk).permute(0, 2, 1, 3)
                 for i in range(3))  # [N, heads, L, dk]
    # 3. attention forward per unit: scores, the row's max and sum, lse, h
    s = torch.einsum("nhic,nhjc->nhij", q, k) * scale
    m = s.max(-1, keepdim=True).values
    e = torch.exp(s - m)
    l_sum = e.sum(-1, keepdim=True)
    p = e / l_sum
    lse = (m + torch.log(l_sum))[..., 0]
    h_heads = torch.relu(torch.einsum("nhij,nhjc->nhic", p, val))  # [N, heads, L, dk]
    dap = torch.einsum("nhic,nhc->nhi", h_heads, dp.reshape(N, heads, dk))  # per head
    h = h_heads.permute(0, 2, 1, 3).reshape(M, D)
    # 4. u and the logits' parts, one per warp column of 32
    u = torch.tanh(h @ w1 + b1)
    parts = -(-A // POOL_BN) * 4
    lgpart = torch.zeros(parts, M, dtype=x.dtype)
    for c0 in range(0, A, 32):
        lgpart[c0 // 32] = u[:, c0:c0 + 32] @ v[c0:c0 + 32]
    # 5. the pool kernel
    lg = lgpart[0].clone()
    for pp in range(1, parts):
        lg = lg + lgpart[pp]
    lg = lg.reshape(N, L)
    keep = mask.to(torch.bool)
    alpha = torch.softmax(torch.where(keep, lg, torch.full_like(lg, -1e9)), -1)
    da = dap[:, 0]
    for hd in range(1, heads):
        da = da + dap[:, hd]
    dlg = torch.where(keep, (da - (alpha * da).sum(-1, keepdim=True)) * alpha,
                      torch.zeros_like(da)).reshape(M)
    dpre = dlg[:, None] * v * (1 - u * u)
    dv = (dlg[:, None] * u).reshape(N, L, A).sum(1).sum(0)
    db1 = dpre.reshape(N, L, A).sum(1).sum(0)
    # 6. dW1 = dpre^T h over row slices, in order
    dw1 = sum(dpre[z:z + ROWS_PER_SPLIT].t() @ h[z:z + ROWS_PER_SPLIT]
              for z in range(0, M, ROWS_PER_SPLIT))
    # 7. dO = (alpha dp + dpre W1) * (h > 0)
    dpn = dp.repeat_interleave(L, 0)
    d_o = torch.where(h > 0, dpre @ w1.t() + alpha.reshape(M, 1) * dpn, torch.zeros_like(h))
    do = d_o.reshape(N, L, heads, dk).permute(0, 2, 1, 3)
    # 8. attention backward per unit: p from lse, t from four warps' parts
    p_b = torch.exp(s - lse[..., None])
    dpp = torch.einsum("nhic,nhjc->nhij", do, val)
    pdp = torch.cat([p_b * dpp, torch.zeros(N, heads, L, SLOTS - L, dtype=x.dtype)], -1)
    t = sum(pdp[..., w * 8:(w + 1) * 8].sum(-1) for w in range(WARPS))
    ds = p_b * (dpp - t[..., None]) * scale
    dq = torch.einsum("nhij,nhjc->nhic", ds, k)
    dkk = torch.einsum("nhij,nhic->nhjc", ds, q)
    dvv = torch.einsum("nhij,nhic->nhjc", p_b, do)
    dqkv = torch.cat([g.permute(0, 2, 1, 3).reshape(M, D) for g in (dq, dkk, dvv)], 1)
    dbias = dqkv.reshape(N, L, 3 * D).sum(1).sum(0)  # per-title sums, then in title order
    # 9. dx with the dropout mask
    dx = dqkv @ wqkv
    if rate > 0:
        keep_x = keep_mask_plain(N, L * Din, rate, seed, site).reshape(M, Din)
        dx = torch.where(keep_x, dx / (1 - rate), torch.zeros_like(dx))
    # 10. dWqkv = dqkv^T xd over row slices
    dwqkv = sum(dqkv[z:z + ROWS_PER_SPLIT].t() @ xd[z:z + ROWS_PER_SPLIT]
                for z in range(0, M, ROWS_PER_SPLIT))
    return (dx.reshape(N, L, Din), dwqkv[:D].t(), dbias[:D], dwqkv[D:2 * D].t(),
            dwqkv[2 * D:].t(), dbias[2 * D:], dw1.t(), db1, dv)


def _args(N, Din, heads, dk, A, seed, L=L):
    g = torch.Generator().manual_seed(seed)
    D = heads * dk
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g, dtype=torch.float64) * sc)
    x = r(N, L, Din)
    mask = torch.rand(N, L, generator=g) < 0.75
    mask[0] = False  # an all-pad title
    return (x, mask, r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(Din, D, sc=Din ** -0.5),
            r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(D, A, sc=D ** -0.5), r(A, sc=0.1),
            r(A, sc=A ** -0.5))


@pytest.mark.parametrize("N,Din,heads,dk,A,rate", [
    (5, 24, 4, 8, 16, 0.2), (3, 12, 4, 25, 32, 0.0), (4, 16, 2, 25, 160, 0.2),
    (2, 8, 1, 64, 8, 0.0)])
def test_order_of_work_matches_plain(N, Din, heads, dk, A, rate):
    args = _args(N, Din, heads, dk, A, seed=N + dk)
    dp = torch.randn(N, heads * dk, generator=torch.Generator().manual_seed(9),
                     dtype=torch.float64)
    got = replay(*args, dp, heads, rate, 31, 2)
    want = ME.msa_encoder_bwd_plain(*args, dp, heads, rate, 31, 2)
    names = ("dx", "dwq", "dbq", "dwk", "dwv", "dbv", "dw1", "db1", "dv")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("N,Din,heads,dk,A,L", [
    (5, 100, 10, 20, 64, 16), (6, 24, 4, 8, 16, 7), (3, 12, 4, 25, 32, 20),
    (4, 8, 1, 64, 8, 1)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_order_of_work_matches_plain_short_titles(N, Din, heads, dk, A, L, rate):
    """Titles of L < 32 (the matrix cells' L 16 at their widths, odd L 7 and
    20, and L 1), title 0 all pad; N * L rows that end partway through the
    row slices."""
    args = _args(N, Din, heads, dk, A, seed=N + dk + L, L=L)
    dp = torch.randn(N, heads * dk, generator=torch.Generator().manual_seed(9),
                     dtype=torch.float64)
    got = replay(*args, dp, heads, rate, 31, 2)
    want = ME.msa_encoder_bwd_plain(*args, dp, heads, rate, 31, 2)
    names = ("dx", "dwq", "dbq", "dwk", "dwv", "dbv", "dw1", "db1", "dv")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("Din,dk,nbytes", [(300, 25, 82_608), (300, 64, 144_384),
                                           (64, 64, 54_272), (900, 25, 219_408),
                                           (600, 64, 260_096)])
def test_relu_fix_block_shared_memory(Din, dk, nbytes):
    """The wrapper's count of the ReLU-fix block's shared memory, which it
    checks before a launch (x rows padded to an odd number of float4s, dk W
    rows, q|k|v and the scores, counted by hand here): the configuration's
    Din 300 at dk 25 and the card tests' shapes fit in a block; Din 600 at
    dk 64 does not."""
    assert ME.relu_fix_smem_bytes(Din, dk) == nbytes
    assert (nbytes <= ME.MAX_SMEM_BYTES) == ((Din, dk) != (600, 64))
