"""Kernel C's order of work (digat_tpu_torch/csrc/gat_scores.cu), replayed in
float64 on the CPU from the launch plans that the wrapper passes to the
kernels (`ops.gat_scores.fwd_plan`, `bwd_plan`).

Forward: blocks of TIb x TJb threads, each thread an R x R tile of scores,
features in slices of 32 summed in order from 0; the replay walks the same
block and thread indices, checks that every (i, j) of a graph is written by
exactly one thread, and sums each score slice by slice. Backward: blocks of
DT features, the columns j in tiles of JT walked in order, each tile walking
the rows i once (t, its mask and w = m g formed once per (i, j)); a row's
sums over the tiles combine in tile order, gk2 and gk3 are written on the
last tile, and ga's per-graph partials are summed in graph order. The replay
is held against `interactive_gat_scores_plain` / `_bwd_plain` (1e-12) and
against the JAX `digat_tpu.ops.gat` path under float64 (1e-10), at G 3, 6,
26, 68 and 96 (above the 72-node cap of the kernel this replaced), with k1
and k2 strided as C' reads them, and with a graph where every t <= 0."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.ops.gat import interactive_gat_scores_xla
from digat_tpu_torch.ops import gat_scores as GS


def replay_fwd(k1, k2, k3, a):
    B, G, D = k1.shape
    p = GS.fwd_plan(G)
    R = p.R
    out = torch.full((B, G, G), float("nan"), dtype=k1.dtype)
    owners = torch.zeros((G, G), dtype=torch.int64)
    threads = GS._round32(p.TIb * p.TJb)
    assert threads <= GS.MAX_FWD_THREADS
    assert GS.fwd_smem_bytes(p) <= 48 * 1024
    for bi in range(p.row_blocks):
        for bj in range(p.col_blocks):
            for t in range(threads):
                ti, tj = divmod(t, p.TJb)
                if ti >= p.TIb:
                    continue  # a thread past the block's tiles
                rows = [bi * p.TIb * R + ti * R + r for r in range(R)]
                cols = [bj * p.TJb * R + tj * R + q for q in range(R)]
                rows = [i for i in rows if i < G]
                cols = [j for j in cols if j < G]
                if not rows or not cols:
                    continue
                ri, cj = torch.tensor(rows), torch.tensor(cols)
                c = k2[:, ri] + k3[:, None]  # [B, r, D]: k2 + k3, staged
                acc = torch.zeros((B, len(rows), len(cols)), dtype=k1.dtype)
                for d0 in range(0, D, GS.SLICE):  # slices in order, d in order
                    for d in range(d0, min(D, d0 + GS.SLICE)):
                        t_ = k1[:, None, cj, d] + c[:, :, None, d]
                        acc = acc + a[d] * torch.relu(t_)
                out[:, ri[:, None], cj[None, :]] = acc
                owners[ri[:, None], cj[None, :]] += 1
    assert torch.equal(owners, torch.ones_like(owners))
    return out


def replay_bwd(k1, k2, k3, a, g):
    B, G, D = k1.shape
    p = GS.bwd_plan(G, D)
    assert p.JT % 4 == 0 and p.JT <= GS.MAX_JT and p.ntiles * p.JT >= G
    assert p.DT % 32 == 0 and p.DT <= GS.MAX_BWD_THREADS and p.slices * p.DT >= D
    assert GS.bwd_smem_bytes(G, p.JT, p.DT, p.ntiles) <= GS.MAX_SMEM_BYTES
    zero = torch.zeros((), dtype=k1.dtype)
    gk1 = torch.full_like(k1, float("nan"))
    gk2 = torch.full_like(k1, float("nan"))
    gk3 = torch.full_like(k3, float("nan"))
    ga_part = torch.full_like(k3, float("nan"))
    for s in range(p.slices):
        d = torch.arange(s * p.DT, min(D, (s + 1) * p.DT))  # the block's active threads
        ad, k3d = a[d], k3[:, d]
        ga = torch.zeros((B, len(d)), dtype=k1.dtype)
        sum3 = torch.zeros_like(ga)
        rsb = torch.zeros((G, B, len(d)), dtype=k1.dtype)  # the shared row sums
        for tile in range(p.ntiles):
            j0 = tile * p.JT
            last = tile == p.ntiles - 1
            gs = torch.zeros((B, G, p.JT), dtype=k1.dtype)  # the tile's g, zero past G
            nj = min(p.JT, G - j0)
            gs[:, :, :nj] = g[:, :, j0:j0 + nj]
            kj = torch.zeros((B, p.JT, len(d)), dtype=k1.dtype)
            kj[:, :nj] = k1[:, j0:j0 + nj][:, :, d]
            acc = torch.zeros_like(kj)
            for i in range(G):
                c = k2[:, i, d] + k3d
                rs = torch.zeros_like(c)
                gai = torch.zeros_like(c)
                for jj in range(p.JT):
                    t = kj[:, jj] + c
                    w = torch.where(t > 0, gs[:, i, jj, None], zero)
                    rs = rs + w
                    acc[:, jj] = acc[:, jj] + w
                    gai = gai + w * t
                ga = ga + gai
                total = rs if tile == 0 else rsb[i] + rs
                if last:
                    gk2[:, i, d] = ad * total
                    sum3 = sum3 + total
                else:
                    rsb[i] = total
            gk1[:, j0:j0 + nj, d] = ad * acc[:, :nj]
        gk3[:, d] = ad * sum3
        ga_part[:, d] = ga
    ga = ga_part[0].clone()
    for b in range(1, B):  # sum_graphs_kernel: graph order
        ga = ga + ga_part[b]
    return gk1, gk2, gk3, ga


def _case(B, G, D, seed, strided=False, negative=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s) * 0.5)
    if strided:  # k1, k2 as column blocks of the fused projection y
        y = f(B, G, 3 * D)
        k1, k2 = y[..., D:2 * D], y[..., 2 * D:]
    else:
        k1, k2 = f(B, G, D), f(B, G, D)
    k3, a, g = f(B, D), f(D), f(B, G, G)
    if negative:  # graph 0: every k1 + k2 + k3 <= 0
        k1[0], k2[0], k3[0] = -k1[0].abs(), -k2[0].abs(), -k3[0].abs() - 0.01
    return k1, k2, k3, a, g


CASES = [(2, 3, 40, False, False), (3, 6, 36, True, False), (2, 26, 48, True, True),
         (2, 68, 36, True, False), (1, 96, 24, False, True)]


@pytest.mark.parametrize("B,G,D,strided,negative", CASES)
def test_scores_order_of_work_matches_plain(B, G, D, strided, negative):
    k1, k2, k3, a, g = _case(B, G, D, seed=G, strided=strided, negative=negative)
    got = replay_fwd(k1, k2, k3, a)
    want = GS.interactive_gat_scores_plain(k1, k2, k3, a)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    if negative:
        assert not got[0].any()


@pytest.mark.parametrize("B,G,D,strided,negative", CASES)
def test_scores_bwd_order_of_work_matches_plain(B, G, D, strided, negative):
    k1, k2, k3, a, g = _case(B, G, D, seed=G + 1, strided=strided, negative=negative)
    got = replay_bwd(k1, k2, k3, a, g)
    want = GS.interactive_gat_scores_bwd_plain(k1, k2, k3, a, g)
    for name, x, w in zip(("gk1", "gk2", "gk3", "ga"), got, want):
        assert x.shape == w.shape, name
        np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=1e-12, err_msg=name)
    if negative:
        assert not got[0][0].any() and not got[1][0].any() and not got[2][0].any()


@pytest.mark.parametrize("G", [6, 68])
def test_scores_order_of_work_matches_jax(G):
    """The replay against jax.vjp of the JAX XLA path (`digat_tpu.ops.gat`),
    both in float64, so that no relu mask is on the other side of 0."""
    k1, k2, k3, a, g = _case(2, G, 36, seed=3 * G, strided=True)
    with jax.enable_x64(True):
        s, vjp = jax.vjp(interactive_gat_scores_xla,
                         *(jnp.asarray(t.numpy()) for t in (k1, k2, k3, a)))
        want = [np.asarray(s)] + [np.asarray(v) for v in vjp(jnp.asarray(g.numpy()))]
    got = [replay_fwd(k1, k2, k3, a), *replay_bwd(k1, k2, k3, a, g)]
    for x, w in zip(got, want):
        assert w.dtype == np.float64
        np.testing.assert_allclose(x.numpy(), w, rtol=0, atol=1e-10)


@pytest.mark.parametrize("G,R,TIb,TJb,blocks", [
    (3, 2, 2, 2, (1, 1)), (6, 2, 3, 3, (1, 1)), (26, 2, 13, 13, (1, 1)),
    (68, 4, 17, 17, (1, 1)), (96, 4, 12, 24, (2, 1)), (200, 4, 17, 25, (3, 2))])
def test_fwd_plan(G, R, TIb, TJb, blocks):
    """The forward's plan at the main path's graphs (one block of 192 and 320
    threads at G 26 and 68) and beyond: every block at most 512 threads and
    a few KB of shared memory."""
    p = GS.fwd_plan(G)
    assert (p.R, p.TIb, p.TJb, (p.row_blocks, p.col_blocks)) == (R, TIb, TJb, blocks)
    assert GS._round32(p.TIb * p.TJb) <= GS.MAX_FWD_THREADS
    assert p.row_blocks * p.TIb * p.R >= G and p.col_blocks * p.TJb * p.R >= G
    assert GS.fwd_smem_bytes(p) <= 32 * 1024


@pytest.mark.parametrize("G,D,ntiles,JT,DT", [
    (3, 400, 1, 4, 224), (26, 400, 1, 28, 224), (68, 400, 2, 36, 224), (96, 400, 3, 32, 224),
    (500, 400, 13, 40, 64), (800, 400, 20, 40, 32)])
def test_bwd_plan(G, D, ntiles, JT, DT):
    """The backward's plan: G 68 in two tiles of 36 columns, D 400 in two
    blocks of 224 threads; large graphs take narrower blocks so that the
    row-sum buffer fits, and a graph too large for 32 features raises."""
    p = GS.bwd_plan(G, D)
    assert (p.ntiles, p.JT, p.DT) == (ntiles, JT, DT)
    assert p.slices == math.ceil(D / p.DT)
    assert GS.bwd_smem_bytes(G, JT, DT, ntiles) <= GS.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        GS.bwd_plan(900, D)
