"""Guards for the port's hazards that a CPU run can check.

1. The machine with the card has no JAX: every module of digat_tpu_torch
   and chip_smoke.py must import with jax and digat_tpu blocked.
2. Entry points never fall back to the CPU quietly: with no device and no
   CUDA they raise.
3. Weights cross between the packages strictly: `load_jax_params` raises
   on a missing, superfluous or misshapen array, and both
   `digat_tpu.interop.torch_to_params(port.state_dict(), cfg)` and the
   port's own `params_from_model` give back the JAX parameters exactly."""

import os
import subprocess
import sys

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

BLOCKED = {"jax", "jaxlib", "flax", "optax", "digat_tpu"}

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
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names) + 2)
"""


def test_port_and_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 31  # 29 modules (serving and training) + 2


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

