"""Kernel A'' (the Philox dropout keep mask) in its plain version, and the
dropout that the port's training path builds on it, on the CPU.

The JAX package's in-kernel mask comes from the TPU core's own generator,
which has no interpret-mode lowering, so its bits cannot be matched. The
plain Philox is held against the published Random123 known-answer vectors
of philox4x32-10, and the masks against the properties that
`tests/test_kernels_tpu.py::test_msa_encoder_fused_dropout` asks of the
TPU's: keep fraction 1 - p within 0.002, determinism for a seed, and the
fused encoder equal to the plain one on keep * x / (1 - p), in value and in
input gradient. The CUDA kernel is held bit for bit against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from digat_tpu_torch import layers
from digat_tpu_torch.ops import dropout as DR
from digat_tpu_torch.ops.msa_encoder import (
    drop_titles_plain,
    msa_encoder_pooled,
    msa_encoder_pooled_plain,
)

# Random123 kat_vectors: philox4x32 10, counter, key -> output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = DR.philox4x32_10([torch.tensor(c, dtype=torch.int64) for c in counter], key)
    assert tuple(int(w) for w in got) == want


def test_mask_is_tile_and_offset_invariant():
    """The mask of a row depends on its absolute row and (seed, site) only:
    any slice of rows, drawn alone at its offset, is the same bits."""
    full = DR.keep_mask_plain(64, 9600, 0.2, 7, 0)
    for lo, hi in ((0, 8), (8, 24), (40, 64), (13, 14)):
        part = DR.keep_mask_plain(hi - lo, 9600, 0.2, 7, 0, row_offset=lo)
        assert torch.equal(part, full[lo:hi])
    # columns are cut from the same 4-word blocks whatever the width
    narrow = DR.keep_mask_plain(64, 9597, 0.2, 7, 0)
    assert torch.equal(narrow, full[:, :9597])


def test_keep_fraction_and_determinism():
    rate = 0.2
    keep = DR.keep_mask_plain(1100, 9600, rate, 987, 0)  # 1.06e7 draws
    assert abs(float((~keep).float().mean()) - rate) < 0.002
    assert torch.equal(keep, DR.keep_mask_plain(1100, 9600, rate, 987, 0))
    other_seed = DR.keep_mask_plain(1100, 9600, rate, 988, 0)
    other_site = DR.keep_mask_plain(1100, 9600, rate, 987, 1)
    for other in (other_seed, other_site):
        agree = float((keep == other).float().mean())
        assert abs(agree - (rate**2 + (1 - rate) ** 2)) < 0.002  # independent draws


def test_keep_mask_on_cpu_is_plain_and_counts_no_launch():
    before = DR.keep_mask.launches
    got = DR.keep_mask(9, 30, 0.3, 5, 2, row_offset=4)
    assert DR.keep_mask.launches == before
    assert torch.equal(got, DR.keep_mask_plain(9, 30, 0.3, 5, 2, row_offset=4))
    assert DR.threshold(0.0) == 0 and DR.threshold(0.5) == 2**31
    with pytest.raises(ValueError):
        DR.threshold(1.0)


def test_layer_dropout_and_site_numbering():
    x = torch.randn(6, 5, 40, dtype=torch.float64)
    assert layers.dropout(x, 0.2, None, 3) is x  # eval
    assert layers.dropout(x, 0.0, 11, 3) is x
    y = layers.dropout(x, 0.2, 11, 3)
    keep = DR.keep_mask_plain(30, 40, 0.2, 11, 3).reshape(x.shape)
    torch.testing.assert_close(y, torch.where(keep, x / 0.8, torch.zeros_like(x)),
                               rtol=1e-15, atol=0)
    sites = layers.DropoutSites(11, first_site=2)
    a, b = sites(x, 0.2), sites(x, 0.2)
    assert torch.equal(a, layers.dropout(x, 0.2, 11, 2))
    assert torch.equal(b, layers.dropout(x, 0.2, 11, 3))
    assert sites.next_site == 4
    assert layers.DropoutSites(None)(x, 0.2) is x


def _encoder_case(n, L, din, heads, dk, A, seed):
    g = torch.Generator().manual_seed(seed)
    D = heads * dk
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g) * sc
    x = r(n, L, din)
    mask = torch.rand(n, L, generator=g) < 0.75
    mask[0] = False
    weights = (r(din, D, sc=din ** -0.5), r(D, sc=0.1), r(din, D, sc=din ** -0.5),
               r(din, D, sc=din ** -0.5), r(D, sc=0.1), r(D, A, sc=D ** -0.5), r(A, sc=0.1),
               r(A, sc=A ** -0.5))
    return x, mask, weights


def test_encoder_dropout_equals_encoder_on_dropped_input():
    """The property the TPU test asks of the fused kernel, on the plain
    version: encoder(x, rate, seed) == encoder(keep * x / (1 - p)) in value
    and in input gradient, and dropped elements get exactly zero gradient."""
    x, mask, w = _encoder_case(10, 32, 24, 4, 8, 16, seed=4)
    R = torch.randn(10, 32, generator=torch.Generator().manual_seed(5))
    x1 = x.clone().requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    out1 = msa_encoder_pooled(x1, mask, *w, 4, dropout_rate=0.2, seed=987, site=0)
    out2 = msa_encoder_pooled_plain(drop_titles_plain(x2, 0.2, 987, 0), mask, *w, 4)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
    (out1 * R).sum().backward()
    (out2 * R).sum().backward()
    torch.testing.assert_close(x1.grad, x2.grad, rtol=0, atol=0)
    keep = DR.keep_mask_plain(10, 32 * 24, 0.2, 987, 0).reshape(x.shape)
    assert bool((x1.grad[~keep] == 0).all())
    again = msa_encoder_pooled(x, mask, *w, 4, dropout_rate=0.2, seed=987, site=0)
    assert torch.equal(again, out1.detach())
