"""Kernel D's order of work (digat_tpu_torch/csrc/emb_grad.cu), replayed on
the CPU against `embedding_grad_plain`.

The replay takes the wrapper's own metadata (`sort_metadata`, `CHUNK`,
`partial_rows`) and walks the two passes as the kernels do: each chunk of
sorted slots sums its runs in slot order, writes a run inside the chunk
straight to its row, a run crossing the chunk's start to partial[2c] and
one crossing its end to partial[2c + 1], and zero-fills the rows below each
run that starts in it (and, in the last chunk, past the last id); the runs
pass then sums, for each chunk whose last run began in it and goes on, that
run's pieces in order: by one warp up to 32 pieces, else cut into one range
per warp of the block. It records how often
every row of `out` and every partial row is written, so that the test can
hold the kernels' claims: every row of `out` written exactly once, no
partial row read before it is written, and the sum equal to the plain
version's (float64, 1e-12)."""

import numpy as np
import pytest
import torch

from digat_tpu_torch.ops import emb_grad as EG

RUN_WARPS = 16  # kRunWarps of the runs pass
SHORT_RUN = 32  # kShortRun: pieces one warp sums alone


def replay(tok, g, V, chunk=EG.CHUNK):
    """Kernel D's two passes in float64; returns (out, writes per row of out,
    partial rows written, partial rows read)."""
    ids, perm = (t.numpy() for t in EG.sort_metadata(torch.from_numpy(tok)))
    ntok, D = g.shape
    out = np.full((V, D), np.nan)
    writes = np.zeros(V, dtype=int)
    partial = np.full((EG.partial_rows(ntok, chunk), D), np.nan)
    written, read = set(), set()

    def put(row, value):
        out[row] = value
        writes[row] += 1

    chunks = -(-ntok // chunk)
    if ntok == 0:
        for row in range(V):
            put(row, 0.0)
    for c in range(chunks):  # pass 1, a warp per chunk
        k0, k1 = c * chunk, min((c + 1) * chunk, ntok)
        before = ids[k0 - 1] if k0 > 0 else -1
        after = ids[k1] if k1 < ntok else V
        acc, from_before, prev = np.zeros(D), True, before
        for k in range(k0, k1):
            if ids[k] != prev:  # a run starts: the rows below it no token names
                for row in range(prev + 1, ids[k]):
                    put(row, 0.0)
            acc = acc + g[perm[k]]
            last = k + 1 == k1
            if last or ids[k + 1] != ids[k]:  # the run's piece ends here
                head = from_before and before == ids[k]
                tail = not head and last and after == ids[k]
                if head or tail:
                    partial[2 * c + (0 if head else 1)] = acc
                    written.add(2 * c + (0 if head else 1))
                else:
                    put(ids[k], acc)
                acc, from_before = np.zeros(D), False
            prev = ids[k]
        if k1 == ntok:
            for row in range(ids[ntok - 1] + 1, V):
                put(row, 0.0)
    for c in range(chunks):  # pass 2, a block per chunk
        k0, k1 = c * chunk, min((c + 1) * chunk, ntok)
        rid = ids[k1 - 1]
        if k1 >= ntok or ids[k1] != rid or (k0 > 0 and ids[k0 - 1] == rid):
            continue
        end = k1 + int(np.searchsorted(ids[k1:], rid, side="right"))  # first slot past the run
        pieces = (end - 1) // chunk - c + 1
        warps = 1 if pieces <= SHORT_RUN else RUN_WARPS
        sums = []
        for w in range(warps):
            s = np.zeros(D)
            for t in range(pieces * w // warps, pieces * (w + 1) // warps):
                row = 2 * c + 1 if t == 0 else 2 * (c + t)
                read.add(row)
                s = s + partial[row]
            sums.append(s)
        total = sums[0]
        for s in sums[1:]:
            total = total + s
        put(rid, total)
    return out, writes, written, read


def _stream(kind, rng, ntok, V):
    if kind == "uniform":
        return rng.integers(0, V, ntok)
    if kind == "pad":  # 60 % of the slots on token 0, as real titles' pads
        return np.where(rng.random(ntok) < 0.6, 0, rng.integers(0, V, ntok))
    if kind == "one long run":  # a middle token over many chunks
        t = rng.integers(0, V, ntok)
        t[rng.random(ntok) < 0.9] = V // 2
        return t
    if kind == "last rows empty":
        return rng.integers(0, V // 3, ntok)
    if kind == "zipf":
        return np.minimum(rng.zipf(1.3, ntok) - 1, V - 1)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,ntok,V,D", [
    ("uniform", 3000, 500, 8), ("pad", 3000, 500, 8), ("one long run", 4100, 300, 4),
    ("last rows empty", 700, 900, 12), ("zipf", 1500, 200, 8), ("uniform", 0, 37, 4),
    ("uniform", 1, 37, 4), ("pad", 64, 10, 4), ("pad", 65, 10, 4)])
def test_replay_matches_plain_and_writes_each_row_once(kind, ntok, V, D):
    rng = np.random.default_rng(ntok + V)
    tok = _stream(kind, rng, ntok, V).astype(np.int64)
    g = rng.standard_normal((ntok, D))
    out, writes, written, read = replay(tok, g, V)
    want = EG.embedding_grad_plain(torch.from_numpy(tok), torch.from_numpy(g), V).numpy()
    assert (writes == 1).all(), np.flatnonzero(writes != 1)[:10]
    assert read <= written  # no partial row is read that pass 1 did not write
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-12)


def test_pad_run_goes_through_partials_and_inner_runs_do_not():
    """On the pad stream nearly every partial piece belongs to token 0's run,
    and the runs pass reads each piece it sums once."""
    rng = np.random.default_rng(5)
    ntok, V = 5000, 400
    tok = _stream("pad", rng, ntok, V)
    _, _, written, read = replay(tok, rng.standard_normal((ntok, 4)), V)
    chunks = -(-ntok // EG.CHUNK)
    pad_chunks = int((tok == 0).sum()) // EG.CHUNK
    assert len(read) >= pad_chunks  # the pad run alone spans this many chunks
    assert len(written) <= 2 * chunks
    assert read == written  # every written piece is summed, none twice


def test_sort_is_stable_int32_and_scratch_is_two_rows_a_chunk():
    tok = torch.tensor([3, 1, 3, 0, 1, 3], dtype=torch.int64)
    ids, perm = EG.sort_metadata(tok)
    assert ids.dtype == torch.int32 and perm.dtype == torch.int64
    assert ids.tolist() == [0, 1, 1, 3, 3, 3]
    assert perm.tolist() == [3, 1, 4, 0, 2, 5]  # equal tokens keep slot order
    assert EG.partial_rows(0) == 0
    assert EG.partial_rows(1) == 2
    assert EG.partial_rows(EG.CHUNK) == 2
    assert EG.partial_rows(EG.CHUNK + 1) == 4
    assert EG.CHUNK % 32 == 0
