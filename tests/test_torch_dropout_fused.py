"""Kernel A'' as the training path's fused dropout (`ops.dropout.dropout`),
on the CPU.

On a CUDA tensor `dropout` launches `dropout_apply_f32` once forward, on x,
and once backward, on the gradient, under the same (seed, site):
out = keep ? x * scale : 0 with scale the float32 value of 1 / (1 - rate).
Here that arithmetic is emulated in numpy and held bit for bit against
`dropout_plain` (the keep mask and torch's where(keep, x * (1 / (1 - rate)),
0)), forward and, through autograd, backward: what the card must equal,
which `chip_smoke.py` and `tests/test_torch_cuda.py` check there. The JAX
package draws its masks from `jax.random`, a different stream, so the bits
are held against the plain Philox of `tests/test_torch_dropout.py`."""

import numpy as np
import pytest
import torch

from digat_tpu_torch import layers
from digat_tpu_torch.ops import dropout as DR

# the graph encoder's site shapes at small widths: [rows, cols] with cols a
# multiple of 4 and not (the alpha sites are G wide)
_SHAPES = [((6, 26, 40), 0.1), ((3, 68, 68), 0.2), ((5, 26), 0.2), ((7, 9, 30), 0.3),
           ((2, 3, 1), 0.5)]


def launch(x: torch.Tensor, seed: int, site: int, thresh: int, scale: float) -> torch.Tensor:
    """dropout_apply_f32's arithmetic on float32 x, with the wrapper's
    arguments: the mask of x seen as [rows, last dim] (a draw kept at or
    above `thresh`), each kept element times `scale` as a float32, rounded
    once."""
    cols = x.shape[-1]
    keep = DR.keep_mask_plain(x.numel() // cols, cols, thresh / 2**32, seed, site)
    return torch.from_numpy(np.where(keep.reshape(x.shape).numpy(),
                                     x.numpy() * np.float32(scale), np.float32(0)))


def kernel(x: torch.Tensor, rate: float, seed: int, site: int) -> torch.Tensor:
    return launch(x, seed, site, DR.threshold(rate), 1.0 / (1.0 - rate))


@pytest.mark.parametrize("shape,rate", _SHAPES, ids=lambda v: str(v))
def test_kernel_arithmetic_equals_plain_bit_for_bit(shape, rate):
    x = torch.from_numpy(np.random.default_rng(len(shape)).standard_normal(shape)
                         .astype(np.float32) * 3)
    got = kernel(x, rate, 1234, 9)
    want = DR.dropout_plain(x, rate, 1234, 9)
    assert want.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,rate", _SHAPES, ids=lambda v: str(v))
def test_backward_is_the_forward_arithmetic_on_the_gradient(shape, rate):
    """autograd's gradient through `dropout_plain` is the same launch on the
    upstream gradient with the same (seed, site), bit for bit."""
    rng = np.random.default_rng(7 + len(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    (dx,) = torch.autograd.grad(DR.dropout_plain(x, rate, 55, 3), x, g)
    assert torch.equal(dx, kernel(g, rate, 55, 3))


def test_dropout_on_cpu_is_plain_and_counts_no_launch():
    x = torch.randn(4, 9, 12)
    before = DR.dropout.launches
    assert torch.equal(DR.dropout(x, 0.2, 3, 1), DR.dropout_plain(x, 0.2, 3, 1))
    assert DR.dropout.launches == before


def test_expanded_view_gradient_sums_into_its_parameter():
    """The topic-node site drops an expanded [B, C, D] view of a [C, D]
    parameter: each copy its own mask, the gradient summed over B."""
    param = torch.randn(5, 8, dtype=torch.float64, requires_grad=True)
    out = DR.dropout(param[None].expand(3, 5, 8), 0.2, 11, 0)
    out.sum().backward()
    keep = DR.keep_mask_plain(15, 8, 0.2, 11, 0).reshape(3, 5, 8)
    torch.testing.assert_close(param.grad, keep.double().sum(0) / 0.8, rtol=1e-15, atol=0)


def test_layers_dropout_goes_through_the_fused_entry(monkeypatch):
    calls = []
    real = layers.apply_dropout

    def recording(x, rate, seed, site):
        calls.append((tuple(x.shape), rate, seed, site))
        return real(x, rate, seed, site)

    monkeypatch.setattr(layers, "apply_dropout", recording)
    x = torch.randn(2, 6, 16)
    sites = layers.DropoutSites(21, first_site=4)
    assert torch.equal(sites(x, 0.2), DR.dropout_plain(x, 0.2, 21, 4))
    assert sites(x, 0.0) is x and layers.EVAL(x, 0.2) is x
    assert calls == [((2, 6, 16), 0.2, 21, 4)]



@pytest.mark.parametrize("family", ["MSA-DIGAT", "NRMS-SA"])
def test_training_step_launches_each_site_forward_and_backward(family, monkeypatch):
    """One training step at dropout 0.2 with the dispatch sent down the CUDA
    path and each launch replaced by the kernel's arithmetic on the CPU:
    two launches per site (forward on x, backward on the gradient; MSA-DIGAT
    has 1 + 2 (1 + depth) + 4 depth sites, 21 at depth 3 and 11 at the
    tests' depth 2; NRMS-SA 7), and the same loss and gradients, bit for
    bit, as the plain path."""
    from types import SimpleNamespace

    from digat_tpu_torch.config import Config
    from digat_tpu_torch.models.model import CorpusTables, Model, TrainBatch
    from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables
    from tests.test_torch_support import NRMS_GEO, corpus_arrays, nrms_arrays, port_config

    rng = np.random.default_rng(3)
    if family == "MSA-DIGAT":
        cfg = port_config(dropout_rate=0.2)
        tables = CorpusTables.from_arrays(SimpleNamespace(**corpus_arrays(rng, 40, cfg)), "cpu")
        model_class, sites = Model, 1 + 2 * (1 + cfg.graph_depth) + 4 * cfg.graph_depth
    else:
        cfg = Config(**{**NRMS_GEO, "nrms_model": "NRMS-SA", "dropout_rate": 0.2}).validate()
        tables = NRMSTables.from_arrays(SimpleNamespace(**nrms_arrays(rng, 40, cfg)), "cpu")
        model_class, sites = NRMSModel, 7
    H = cfg.max_history_num
    batch = TrainBatch(torch.from_numpy(rng.integers(1, 40, (4, H))),
                       torch.from_numpy(rng.integers(0, cfg.category_num, (4, H))),
                       torch.from_numpy(rng.integers(1, 40, (4, 5))), torch.ones(4))

    def emulated(x, args):
        DR.dropout.launches += 1
        return launch(x.detach(), *args)

    out = []
    for fused in (False, True):
        if fused:
            monkeypatch.setattr(DR, "build", SimpleNamespace(use_kernel=lambda where: True))
            monkeypatch.setattr(DR, "_apply", emulated)
        model = model_class(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        before = DR.dropout.launches
        loss = model.loss(tables, batch, 9)
        loss.backward()
        out.append((float(loss.detach()), [p.grad for p in model.parameters()],
                    DR.dropout.launches - before))
    (l_plain, g_plain, n_plain), (l_fused, g_fused, n_fused) = out
    assert n_plain == 0 and n_fused == 2 * sites
    assert l_fused == l_plain
    assert all(torch.equal(a, b) for a, b in zip(g_fused, g_plain))
