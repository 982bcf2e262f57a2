"""`--compute_dtype bfloat16` through the port's configuration, CLI and
interop (CPU).

  * The configuration takes it for MSA-DIGAT and each of the five
    ablations, and for every other model the JAX package runs at bf16:
    NRMS, NRMS-SA, the CNN encoder, MSA titles routed through the attention
    pair (L > 128) and heads wider than 128 (which the pair refuses on the
    card at either dtype); another dtype raises.
  * The CLI trains one epoch at bf16 at narrow widths, writes its run
    layout, and `--mode test` on `best.ckpt` gives the auto-test's metrics
    again; the checkpoint holds fp32 masters. NRMS-SA, NRMS, CNN-DIGAT and
    MSA-DIGAT at titles of 160 train, test and re-score one epoch at bf16
    through the CLI too.
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


@pytest.mark.parametrize("variant", GRAPH_ENCODERS)
def test_config_takes_bf16_for_cnn_with_every_graph_encoder(variant):
    cfg = Config.from_args(["--compute_dtype", "bfloat16", "--news_encoder", "CNN",
                            "--graph_encoder", variant])
    assert (cfg.compute_dtype, cfg.news_encoder, cfg.graph_encoder) == ("bfloat16", "CNN",
                                                                        variant)


@pytest.mark.parametrize("flags,field,value", [
    (["--model_family", "nrms"], "nrms_model", "NRMS-SA"),
    (["--model_family", "nrms", "--nrms_model", "NRMS"], "nrms_model", "NRMS"),
    (["--news_encoder", "CNN"], "news_encoder", "CNN"),
    (["--max_title_length", "160"], "max_title_length", 160),
    (["--MSA_head_num", "1", "--MSA_head_dim", "200"], "MSA_head_dim", 200),
], ids=["nrms-sa", "nrms", "cnn", "L160", "dk200"])
def test_config_refuses_bf16_elsewhere_naming_its_roadmap_item(flags, field, value):
    """Once refused, naming ROADMAP items; since the NRMS family, the CNN and
    the attention pair's bf16 instances, taken as at float32."""
    cfg = Config.from_args(["--compute_dtype", "bfloat16", *flags])
    assert (cfg.compute_dtype, getattr(cfg, field)) == ("bfloat16", value)
    assert Config.from_args(flags).compute_dtype == "float32"
    with pytest.raises(ValueError, match="compute_dtype"):
        Config.from_args(["--compute_dtype", "float16", *flags])


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


@pytest.mark.parametrize("extra,name", [
    (["--model_family", "nrms"], "NRMS-SA"),
    (["--model_family", "nrms", "--nrms_model", "NRMS"], "NRMS"),
    (["--news_encoder", "CNN", "--cnn_kernel_num", "32"], "CNN-DIGAT"),
    (["--max_title_length", "160"], "MSA-DIGAT"),
], ids=["nrms-sa", "nrms", "cnn", "msa-L160"])
def test_cli_trains_and_rescores_other_models_at_bf16(tmp_path, extra, name):
    tmp = str(tmp_path)
    rec = cli.main(_flags(tmp, "--epoch", "1", "--compute_dtype", "bfloat16", *extra))
    assert len(rec["history"]) == 1 and np.isfinite(rec["history"][0]["loss"])
    assert all(np.isfinite(rec["test"]))
    assert os.path.exists(os.path.join(tmp, "runs", "results", "synthetic", name, "#1-test"))
    test = cli.main(_flags(tmp, "--compute_dtype", "bfloat16", "--mode", "test",
                           "--test_model_path", os.path.join(rec["run_dir"], "best.ckpt"),
                           *extra))
    assert test == rec["test"]


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
