"""Guards for the port's hazards that a CPU run can check.

1. The machine with the card has no JAX and no transformers: every module
   of digat_tpu_torch (plm.mpnet and layers_ext among them) and
   chip_smoke.py must import with jax, digat_tpu, transformers and
   sentence_transformers blocked.
2. Entry points never fall back to the CPU quietly: with no device and no
   CUDA they raise.
3. Weights cross between the packages strictly: `load_jax_params` raises
   on a missing, superfluous or misshapen array, and both
   `digat_tpu.interop.torch_to_params(port.state_dict(), cfg)` and the
   port's own `params_from_model` give back the JAX parameters exactly.
4. Kernels launch on their tensor's device: the library initialises its
   kernels once per device, with that device current, and every wrapper
   makes its tensor's device current around the C call (a stub library
   and device guard stand in for the cards). The guard is skipped only
   where the tensor's device is already current; kernel B's three C calls
   and the fused dropout's forward and backward launches are checked call
   by call."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from digat_tpu import interop as jax_interop
from digat_tpu_torch import runtime
from digat_tpu_torch.interop import load_jax_params, params_from_model
from digat_tpu_torch.models.model import Model
from tests.test_torch_support import jax_config, models, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "flax", "optax", "digat_tpu", "transformers",
           "sentence_transformers"}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import digat_tpu_torch
names = [m.name for m in pkgutil.walk_packages(digat_tpu_torch.__path__, "digat_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert "digat_tpu_torch.parallel.sharded_table" in names, names
assert "digat_tpu_torch.native.bindings" in names, names
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names) + 2)
"""


def test_port_and_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # the serving, training, data, CLI and tool modules, plm and its MPNet,
    # layers_ext, the row-sharded word table, the native loader, the package
    # and chip_smoke
    assert int(proc.stdout.split()[-1]) >= 52


def test_entry_point_without_device_or_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(port_config())
    assert Model(port_config(), device="cpu").device == torch.device("cpu")


def test_smoke_without_cuda_exits_nonzero_and_prints_no_result():
    """chip_smoke.py on a host without CUDA (this one) fails and prints no
    result line."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_round_trip_through_jax_interop():
    jm, params, pm = models(seed=2)
    back = jax_interop.torch_to_params(pm.state_dict(), jm.config)
    want = jax.tree_util.tree_structure(params)
    assert jax.tree_util.tree_structure(back) == want
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def _drop(tree, path):
    node = tree
    for k in path[:-1]:
        node = node[k]
    del node[path[-1]]


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_load_jax_params_is_strict(change):
    _, params, _ = models(seed=3)
    params = jax.tree.map(np.array, params)
    if change == "missing":
        _drop(params, ("graph_encoder", "user_ctx", "K"))
        err = KeyError
    elif change == "extra":
        params["graph_encoder"]["unused"] = {"w": np.zeros((2, 2), np.float32)}
        err = ValueError
    else:
        params["news_encoder"]["pool"]["affine1"]["b"] = np.zeros(3, np.float32)
        err = RuntimeError
    with pytest.raises(err):
        load_jax_params(Model(port_config(), device="cpu"), params)


def test_load_jax_params_fills_every_parameter():
    """A port model drawn from another seed, after loading, equals the JAX
    tree everywhere: no parameter keeps its own initial value."""
    jm, params, _ = models(seed=4)
    other = Model(port_config(), device="cpu", generator=torch.Generator().manual_seed(99))
    load_jax_params(other, params)
    back = jax_interop.torch_to_params(other.state_dict(), jax_config())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_params_from_model_gives_back_the_jax_tree():
    """The port's own way back to JAX (how trained weights go back to the
    JAX package): the same tree structure and the same arrays."""
    _, params, pm = models(seed=5)
    back = params_from_model(pm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert all(a.dtype == np.float64 for a in jax.tree_util.tree_leaves(
        params_from_model(pm.double())))



# ---------------------------------------------------------------------------
# 4. launches on the tensor's own device: the kernels' library is loaded once
#    and initialised once per device, and every wrapper makes its tensor's
#    device current around the C call. A one-card machine cannot show the
#    fault this guards against (a model on cuda:1 launching from cuda:0), so
#    a stub library and a stub device guard stand in for the card here.
# ---------------------------------------------------------------------------
class _StubCuda:
    """torch.cuda's device guard, current device and stream, and the
    kernels' library, recording under which device each C call ran."""

    def __init__(self, monkeypatch):
        from digat_tpu_torch.ops import build

        self.current, self.calls, self.args = [], [], []
        stub = self

        class Guard:
            def __init__(self, device):
                self.device = torch.device("cuda", device) if isinstance(device, int) \
                    else torch.device(device)

            def __enter__(self):
                stub.current.append(self.device)

            def __exit__(self, *exc):
                stub.current.pop()

        class Library:
            def __getattr__(self, name):
                def call(*args):
                    # with no guard entered, the current device (cuda:0) is in force
                    stub.calls.append((name, stub.current[-1] if stub.current
                                       else torch.device("cuda", 0)))
                    stub.args.append(args)
                    return 0
                return call

        monkeypatch.setattr(torch.cuda, "device", Guard)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: SimpleNamespace(cuda_stream=0))
        monkeypatch.setattr(build, "_current_stream", lambda index: 0)
        monkeypatch.setattr(build, "_library", lambda: Library())
        monkeypatch.setattr(build, "_READY", set())


def test_kernels_initialise_once_per_device(monkeypatch):
    from digat_tpu_torch.ops import build

    stub = _StubCuda(monkeypatch)
    for device in ("cuda:1", "cuda:0", torch.device("cuda", 1), None, "cuda", "cuda:1"):
        build.load_library(device)
    inits = [(name, str(device)) for name, device in stub.calls if name.endswith("_init")]
    # cuda:1 first, then cuda:0; each device's inits once, with it current
    assert inits == [(name, f"cuda:{d}") for d in (1, 0) for name in build.INITS]
    assert "msa_attention_init" in build.INITS


def test_every_wrapper_launches_under_its_tensors_device(monkeypatch):
    from digat_tpu_torch.ops import build
    from digat_tpu_torch.ops import dropout as DR
    from digat_tpu_torch.ops import emb_grad as EG
    from digat_tpu_torch.ops import gat_layer as GL
    from digat_tpu_torch.ops import gat_scores as GS
    from digat_tpu_torch.ops import msa_attention as MA
    from digat_tpu_torch.ops import msa_encoder as ME

    stub = _StubCuda(monkeypatch)
    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    r = lambda *s: torch.randn(*s)
    x, mask = r(3, 32, 8), torch.rand(3, 32) < 0.7
    w = (r(8, 8), r(8), r(8, 8), r(8, 8), r(8), r(8, 4), r(4), r(4))
    bf = lambda t: t.to(torch.bfloat16)
    for cast in (lambda t: t, bf):  # the fp32 instances, then the bf16 ones
        ME._forward_kernel(cast(x), mask, *map(cast, w), 2, 0.0, 0, 0)
        ME.msa_encoder_bwd(cast(x), mask, *map(cast, w), r(3, 8), 2)
    B, G, D = 2, 5, 8
    # fp32 weights, then bf16 ones, then bf16 activations too
    for xcast, cast in ((lambda t: t, lambda t: t), (lambda t: t, bf), (bf, bf)):
        GL.interactive_gat_layer_fused(xcast(r(B, G, D)), torch.ones(B, G, G, dtype=torch.bool),
                                       xcast(r(B, D)), *map(cast, (r(D, D), r(D), r(D, D),
                                                                   r(D, D), r(D, D), r(D), r(D))))
    for cast in (lambda t: t, bf):  # the fp32 instances, then the bf16 ones
        GS.gat_scores_fwd(*map(cast, (r(B, G, D), r(B, G, D), r(B, D), r(D))))
        DR.dropout(cast(r(4, 6)), 0.2, 1, 2)
        q = cast(r(2, 12, 8))
        MA.attention_fwd(q, q, q, None, 2, 4)
        MA.attention_bwd(q, q, q, torch.ones(2, 12, dtype=torch.bool), q, 2, 4)
    GS.gat_scores_bwd(r(B, G, D), r(B, G, D), r(B, D), r(D), r(B, G, G))
    DR.keep_mask(4, 6, 0.2, 1, 2, device="cpu")
    EG.embedding_grad(torch.randint(0, 7, (3, 4)), r(3, 4, 8), 7)
    launches = [c for c in stub.calls if not c[0].endswith(("_init", "_scratch_floats"))]
    assert sorted({name for name, _ in launches}) == sorted(
        n for n in build.SIGNATURES if not n.endswith("_scratch_floats"))
    assert all(device == torch.device("cpu") for _, device in launches), launches


def test_launch_on_skips_the_guard_only_on_the_current_device(monkeypatch):
    """cuda:0 is current: a C call for a cuda:0 (or bare "cuda") tensor runs
    with no guard entered, one for cuda:1 inside a guard of cuda:1, and each
    device's inits run once, under that device."""
    from digat_tpu_torch.ops import build

    stub = _StubCuda(monkeypatch)
    for device in (torch.device("cuda", 0), "cuda", "cuda:1", torch.device("cuda", 0)):
        with build.launch_on(device) as (lib, stream):
            depth = len(stub.current)
            lib.dropout_apply_f32()
        assert depth == (1 if str(device) == "cuda:1" else 0), device
        assert not stub.current
    launches = [(n, str(d)) for n, d in stub.calls if not n.endswith("_init")]
    assert launches == [("dropout_apply_f32", d) for d in ("cuda:0", "cuda:0", "cuda:1",
                                                           "cuda:0")]
    inits = [(n, str(d)) for n, d in stub.calls if n.endswith("_init")]
    assert inits == [(name, f"cuda:{d}") for d in (0, 1) for name in build.INITS]


def test_launch_on_leaves_its_guard_when_an_init_fails(monkeypatch):
    """An init that reports a CUDA error for cuda:1 raises out of
    `launch_on("cuda:1")` with the guard left (cuda:0 current again, as
    before the call) and cuda:1 not marked ready, so the next call retries."""
    from digat_tpu_torch.ops import build

    stub = _StubCuda(monkeypatch)
    failing = {"on": True}

    class FailingLibrary:
        def __getattr__(self, name):
            def call(*args):
                device = stub.current[-1] if stub.current else torch.device("cuda", 0)
                stub.calls.append((name, device))
                if name == "digat_error_string":
                    return b"stub error"
                if failing["on"] and name.endswith("_init") and device.index == 1:
                    return 700
                return 0
            return call

    monkeypatch.setattr(build, "_library", lambda: FailingLibrary())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        with build.launch_on("cuda:1"):
            raise AssertionError("the body ran after a failed init")
    assert not stub.current
    assert 1 not in build._READY
    failing["on"] = False
    with build.launch_on("cuda:1") as (lib, stream):
        assert [str(d) for d in stub.current] == ["cuda:1"]
    assert not stub.current and 1 in build._READY


def test_gat_layer_makes_its_three_calls_under_its_tensors_device(monkeypatch):
    """Kernel B's wrapper: the projection, kernel C's forward on y's k1 and
    k2 column blocks (row stride 3 Dp), then the attend step, each under the
    tensor's device, and one count. D 6 is padded to 8."""
    from digat_tpu_torch.ops import build
    from digat_tpu_torch.ops import gat_layer as GL
    from digat_tpu_torch.ops import gat_scores as GS

    stub = _StubCuda(monkeypatch)
    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    B, G, D, Dp = 3, 7, 6, 8
    r = lambda *s: torch.randn(*s)
    before = GL.interactive_gat_layer_fused.launches
    GL.interactive_gat_layer_fused(r(B, G, D), torch.ones(B, G, G, dtype=torch.bool), r(B, D),
                                   r(D, D), r(D), r(D, D), r(D, D), r(D, D), r(D), r(D))
    assert GL.interactive_gat_layer_fused.launches == before + 1
    calls = [(n, a) for (n, d), a in zip(stub.calls, stub.args) if not n.endswith("_init")]
    assert [n for n, _ in calls] == ["gat_layer_project_f32", "gat_scores_fwd_f32",
                                     "gat_layer_attend_f32"]
    assert all(d == torch.device("cpu") for n, d in stub.calls if not n.endswith("_init"))
    project, scores, attend = (a for _, a in calls)
    y = project[6]
    assert project[8:11] == (B * G, B, Dp)
    plan = GS.fwd_plan(G)
    assert scores == (y + 4 * Dp, 3 * Dp, y + 8 * Dp, 3 * Dp, project[7], scores[5], scores[6],
                      B, G, Dp, plan.R, plan.TIb, plan.TJb, 0)
    tiles = GL.attend_plan(G, D)
    assert attend[2] == scores[6] and attend[3:5] == (y, 3 * Dp)
    assert attend[6:11] == (B, G, D, tiles.TI, tiles.CG)


def test_gat_layer_bf16_activations_makes_two_calls_under_its_tensors_device(monkeypatch):
    """Kernel B's bf16-activation instance: the projections (D 6 padded to
    8, a multiple of 8 for the TMA's rows), then the fused step on their y
    and k3 with `fused_plan`'s tiles, each under the tensor's device, and one
    count on `launches_bf16_act`."""
    from digat_tpu_torch.ops import build
    from digat_tpu_torch.ops import gat_layer as GL

    stub = _StubCuda(monkeypatch)
    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    B, G, D, Dp = 3, 7, 6, 8
    bf = lambda *s: torch.randn(*s).to(torch.bfloat16)
    fused = GL.interactive_gat_layer_fused
    before = (fused.launches, fused.launches_bf16, fused.launches_bf16_act)
    fused(bf(B, G, D), torch.ones(B, G, G, dtype=torch.bool), bf(B, D), bf(D, D), bf(D),
          bf(D, D), bf(D, D), bf(D, D), bf(D), bf(D))
    assert (fused.launches, fused.launches_bf16, fused.launches_bf16_act) == \
        (*before[:2], before[2] + 1)
    calls = [(n, a) for (n, d), a in zip(stub.calls, stub.args) if not n.endswith("_init")]
    assert [n for n, _ in calls] == ["gat_layer_project_bf16_act", "gat_layer_fused_bf16"]
    assert all(d == torch.device("cpu") for n, d in stub.calls if not n.endswith("_init"))
    project, step = (a for _, a in calls)
    assert project[8:11] == (B * G, B, Dp)
    plan = GL.fused_plan(G, D)
    assert step[2:4] == project[6:8]  # y and k3
    assert step[6:14] == (B, G, D, Dp, plan.tile.R, plan.tile.TIb, plan.tile.TJb, plan.CG)


def test_gat_layer_bf16_weights_makes_two_calls_under_its_tensors_device(monkeypatch):
    """Kernel B's bf16-weight instance (fp32 x and query): the split and the
    wgmma projections (D 6 padded to 8) into scratch of x's and query's
    three bf16 planes, then the fused step on fp32 x with `fused_plan`'s
    tiles, each under the tensor's device, and one count on
    `launches_bf16`: no C forward and no attend step."""
    from digat_tpu_torch.ops import build
    from digat_tpu_torch.ops import gat_layer as GL

    stub = _StubCuda(monkeypatch)
    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    B, G, D, Dp = 3, 7, 6, 8
    r, bf = (lambda *s: torch.randn(*s)), (lambda *s: torch.randn(*s).to(torch.bfloat16))
    fused = GL.interactive_gat_layer_fused
    before = (fused.launches, fused.launches_bf16, fused.launches_bf16_act)
    out = fused(r(B, G, D), torch.ones(B, G, G, dtype=torch.bool), r(B, D), bf(D, D), bf(D),
                bf(D, D), bf(D, D), bf(D, D), bf(D), r(D))
    assert out.dtype == torch.float32 and out.shape == (B, G, D)
    assert (fused.launches, fused.launches_bf16, fused.launches_bf16_act) == \
        (before[0], before[1] + 1, before[2])
    calls = [(n, a) for (n, d), a in zip(stub.calls, stub.args) if not n.endswith("_init")]
    assert [n for n, _ in calls] == ["gat_layer_project_bf16", "gat_layer_fused_f32"]
    assert all(d == torch.device("cpu") for n, d in stub.calls if not n.endswith("_init"))
    project, step = (a for _, a in calls)
    assert project[9:12] == (B * G, B, Dp)
    plan = GL.fused_plan(G, D)
    assert step[2:4] == project[6:8]  # y and k3
    assert step[6:14] == (B, G, D, Dp, plan.tile.R, plan.tile.TIb, plan.tile.TJb, plan.CG)


def test_dropout_launches_forward_then_backward_with_the_same_bits(monkeypatch):
    """The fused dropout on a tensor that needs its gradient: one launch of
    `dropout_apply_f32` forward on x and one backward on the gradient, with
    the same (row offset, seed, site, threshold, scale), both under the
    tensor's device, counted twice; an expanded view (the topic nodes) gets
    its gradient summed back into its parameter's shape."""
    from digat_tpu_torch.ops import build
    from digat_tpu_torch.ops import dropout as DR

    stub = _StubCuda(monkeypatch)
    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    param = torch.randn(5, 12, requires_grad=True)
    x = param[None].expand(3, 5, 12)
    before = DR.dropout.launches
    out = DR.dropout(x, 0.1, 2**33 + 7, 4)
    assert len(stub.calls) == len(build.INITS) + 1
    g = torch.randn(3, 5, 12)
    out.backward(g)
    assert DR.dropout.launches == before + 2
    assert param.grad.shape == param.shape
    calls = [(n, d, a) for (n, d), a in zip(stub.calls, stub.args) if not n.endswith("_init")]
    assert [(n, d) for n, d, _ in calls] == [("dropout_apply_f32", torch.device("cpu"))] * 2
    fwd, bwd = (a for _, _, a in calls)
    assert fwd[2:4] == bwd[2:4] == (15, 12)
    assert fwd[4:9] == bwd[4:9] == (0, 7, 4, DR.threshold(0.1), 1.0 / (1.0 - 0.1))
    assert bwd[0] == g.data_ptr()  # the backward launches on the gradient
