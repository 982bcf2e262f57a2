"""`--compute_dtype bfloat16` through the port's configuration, CLI and
interop (CPU).

  * The configuration takes it for MSA-DIGAT and each of the five
    ablations, and refuses NRMS, NRMS-SA, the CNN encoder and MSA titles
    routed through the attention pair (L > 128), each naming its ROADMAP
    item.
  * The CLI trains one epoch at bf16 at narrow widths, writes its run
    layout, and `--mode test` on `best.ckpt` gives the auto-test's metrics
    again; the checkpoint holds fp32 masters.
  * Interop: the fp32 masters of a bf16 model go back to the JAX tree
    exactly, through the port's `params_from_model` and through
    `digat_tpu.interop.torch_to_params`, and load back."""

import os

import jax
import numpy as np
import pytest
import torch

from digat_tpu import interop as jax_interop
from digat_tpu_torch import cli
from digat_tpu_torch.config import GRAPH_ENCODERS, Config
from digat_tpu_torch.interop import load_jax_params, params_from_model
from digat_tpu_torch.models.model import Model
from tests.test_torch_cli import _flags
from tests.test_torch_support import bf16_models, jax_config, one_thread, port_config  # noqa

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("variant", GRAPH_ENCODERS)
def test_config_takes_bf16_for_msa_digat_and_its_ablations(variant):
    cfg = Config.from_args(["--compute_dtype", "bfloat16", "--graph_encoder", variant])
    assert (cfg.compute_dtype, cfg.graph_encoder) == ("bfloat16", variant)


@pytest.mark.parametrize("flags,item", [
    (["--model_family", "nrms"], "NRMS and NRMS-SA at bfloat16"),
    (["--model_family", "nrms", "--nrms_model", "NRMS"], "NRMS and NRMS-SA at bfloat16"),
    (["--news_encoder", "CNN"], "CNN at bfloat16"),
    (["--max_title_length", "160"], "the attention pair"),
    (["--MSA_head_num", "1", "--MSA_head_dim", "200"], "the attention pair"),
], ids=["nrms-sa", "nrms", "cnn", "L160", "dk200"])
def test_config_refuses_bf16_elsewhere_naming_its_roadmap_item(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md section 1, item 3.*{item}"):
        Config.from_args(["--compute_dtype", "bfloat16", *flags])
    assert Config.from_args(flags).compute_dtype == "float32"
    with pytest.raises(ValueError, match="compute_dtype"):
        Config.from_args(["--compute_dtype", "float16"])


def test_cli_trains_and_rescores_at_bf16(tmp_path):
    tmp = str(tmp_path)
    rec = cli.main(_flags(tmp, "--epoch", "1", "--compute_dtype", "bfloat16"))
    assert len(rec["history"]) == 1 and np.isfinite(rec["history"][0]["loss"])
    assert all(np.isfinite(rec["test"]))
    ckpt = os.path.join(rec["run_dir"], "best.ckpt")
    assert os.path.exists(os.path.join(tmp, "runs", "results", "synthetic", "MSA-DIGAT",
                                       "#1-test"))
    test = cli.main(_flags(tmp, "--compute_dtype", "bfloat16", "--mode", "test",
                           "--test_model_path", ckpt))
    assert test == rec["test"]
    state = torch.load(ckpt, map_location="cpu", weights_only=False)
    tensors = [v for v in _tensors(state)]
    assert tensors and all(t.dtype == torch.float32 for t in tensors if t.is_floating_point())


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def test_interop_round_trip_at_bf16():
    _, params, pm = bf16_models(seed=6)
    assert pm.config.compute_dtype == "bfloat16"
    for back in (params_from_model(pm),
                 jax_interop.torch_to_params(pm.state_dict(),
                                             jax_config(compute_dtype="bfloat16"))):
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
            assert np.asarray(a).dtype == np.float32
            np.testing.assert_array_equal(a, b)
    other = load_jax_params(Model(port_config(compute_dtype="bfloat16"), device="cpu",
                                  generator=torch.Generator().manual_seed(9)), params)
    for a, b in zip(other.parameters(), pm.parameters()):
        assert a.dtype == torch.float32 and torch.equal(a, b)
