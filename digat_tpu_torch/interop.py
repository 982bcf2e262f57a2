"""Carry parameters between the JAX package's tree and a port model.

`load_jax_params(model, params)` takes the `digat_tpu` parameter tree of
the model's family (nested dicts of arrays, and the CNN bank's list of
convolutions, as `digat_tpu.models.model.Model.init` builds it for the
DIGAT family, every news and graph encoder, and `digat_tpu.models.nrms.
NRMSModel.init` for NRMS and NRMS-SA, converted to numpy by the caller) and fills the
port model's parameters. It is strict both ways, like `digat_tpu/interop.py`: every
array of the tree is used exactly once and every parameter of the model is
filled, or it raises. `params_from_model(model)` goes the other way: the
JAX tree, as numpy arrays in the model's dtype, so a port model's trained
weights can be handed back to the JAX package. A model whose word table is
row-sharded (`--mesh_model` M > 1) takes its rows of the whole JAX table,
and gives the whole table back, gathered over its model group (every rank
of the group calls `params_from_model` together).

JAX stores linear weights `[in, out]`; `nn.Linear` stores `[out, in]`, so
weights transpose; a convolution's `[width, in, out]` reverses its axes into
`nn.Conv1d`'s `[out, in, width]`. Per-depth stacks (leading depth axis) split into the
`nn.ModuleList` entries. One table of (JAX path, port names) serves both
directions (one table per family).

`load_torch_checkpoint(path, config_or_model)` reads a checkpoint file of
the reference PyTorch implementation (`{model_name: state_dict}`), whose
names the port keeps: a load, not a conversion."""

from __future__ import annotations

from typing import Iterator, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from digat_tpu_torch.models.graph_encoders import VARIANT_GATS
from digat_tpu_torch.parallel.sharded_table import full_state_dict


def _linear(src: str, dst: str, bias: bool = True):
    yield f"{src}/w", [f"{dst}.weight"], True
    if bias:
        yield f"{src}/b", [f"{dst}.bias"], False


# the GAT stacks' parameters: name -> has a bias
_GAT_PARAMS = {"interactive": (("W", True), ("ffn1", False), ("ffn2", False), ("ffn3", True),
                               ("a", False)),
               "vanilla": (("W", True), ("a1", False), ("a2", False))}

# the CNN bank's convolutions by method, as the reference names them
_CONV_NAMES = {"naive": ("conv",), "group3": ("conv1", "conv2", "conv3"),
               "group5": ("conv1", "conv2", "conv3", "conv4", "conv5")}


def _gat_stack(src: str, dst: str, kind: str, depth: int):
    for name, bias in _GAT_PARAMS[kind]:
        yield f"{src}/{name}/w", [f"{dst}_{name}.{i}.weight" for i in range(depth)], True
        if bias:
            yield f"{src}/{name}/b", [f"{dst}_{name}.{i}.bias" for i in range(depth)], False


def _table(config) -> Iterator[Tuple[str, List[str], bool]]:
    """(JAX path, port state_dict names, transposed) for every parameter of
    the DIGAT-family model of `config`. More than one name: a per-depth
    stack, one name per depth. The CNN bank's list is indexed by position
    (`conv/convs/0/w`)."""
    depth, g = config.graph_depth, "graph_encoder"
    yield "news_encoder/word_embedding", ["news_encoder.word_embedding.weight"], False
    yield from _linear("news_encoder/pool/affine1", "news_encoder.attention.affine1")
    yield from _linear("news_encoder/pool/affine2", "news_encoder.attention.affine2", bias=False)
    if config.news_encoder == "CNN":
        for k, name in enumerate(_CONV_NAMES[config.cnn_method]):
            yield from _linear(f"news_encoder/conv/convs/{k}", f"news_encoder.conv.{name}")
    else:
        m = "news_encoder.multiheadSelfattention"
        yield from _linear("news_encoder/msa/W_K", f"{m}.W_K", bias=False)
        yield from _linear("news_encoder/msa/W_Q", f"{m}.W_Q")
        yield from _linear("news_encoder/msa/W_V", f"{m}.W_V")
    yield f"{g}/topic_node_embedding", [f"{g}.topic_node_embedding"], False
    if config.graph_encoder != "wo_SA":
        yield from _linear(f"{g}/news_ctx/cand_attn/K", f"{g}.candidate_attention.K",
                           bias=False)
        yield from _linear(f"{g}/news_ctx/cand_attn/Q", f"{g}.candidate_attention.Q")
        yield from _linear(f"{g}/news_ctx/gate", f"{g}.news_graph_W")
    yield from _linear(f"{g}/user_ctx/K", f"{g}.user_news_K", bias=False)
    yield from _linear(f"{g}/user_ctx/Q", f"{g}.user_news_Q")
    yield from _linear(f"{g}/user_ctx/affine", f"{g}.featureAffine")
    yield from _linear(f"{g}/user_ctx/attn/K", f"{g}.userAttention.K", bias=False)
    yield from _linear(f"{g}/user_ctx/attn/Q", f"{g}.userAttention.Q")
    news_gat, user_gat = VARIANT_GATS[config.graph_encoder]
    if news_gat is not None:
        yield from _gat_stack(f"{g}/news_gat", f"{g}.news_graph_attention", news_gat, depth)
    yield from _gat_stack(f"{g}/user_gat", f"{g}.user_graph_attention", user_gat, depth)


def _nrms_table(sa: bool) -> Iterator[Tuple[str, List[str], bool]]:
    """(JAX path, port state_dict name, transposed) for every parameter of
    NRMS, and of NRMS-SA with `sa`."""
    yield "word_embedding", ["news_encoder.word_embedding.weight"], False
    for tower in ("news", "user"):
        m = f"{tower}_encoder.multiheadAttention"
        yield from _linear(f"{tower}_msa/W_K", f"{m}.W_K", bias=False)
        yield from _linear(f"{tower}_msa/W_Q", f"{m}.W_Q")
        yield from _linear(f"{tower}_msa/W_V", f"{m}.W_V")
        yield from _linear(f"{tower}_pool/affine1", f"{tower}_encoder.attention.affine1")
        yield from _linear(f"{tower}_pool/affine2", f"{tower}_encoder.attention.affine2",
                           bias=False)
    if sa:
        yield from _linear("sa_attn/K", "news_encoder.SA_attention.K", bias=False)
        yield from _linear("sa_attn/Q", "news_encoder.SA_attention.Q")
        yield from _linear("sa_gate", "news_encoder.SA_transformation")


def _table_of(model: nn.Module) -> list:
    """The parameter table of the model's family."""
    if getattr(model, "family", "digat") == "nrms":
        return list(_nrms_table(model.sa))
    return list(_table(model.config))


def _leaves(params: Mapping) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for k, v in enumerate(node):
                walk(v, path + (str(k),))
        else:
            out["/".join(path)] = np.asarray(node)

    walk(params, ())
    return out


def _state_dict_from_jax(params: Mapping, table: list) -> dict:
    """The port's state_dict (numpy arrays) for a `digat_tpu` parameter
    tree, by `table`; strict as described in the module docstring."""
    leaves = _leaves(params)
    sd = {}
    for path, names, transposed in table:
        if path not in leaves:
            raise KeyError(f"JAX params have no array '{path}'")
        arr = leaves.pop(path)
        if len(names) > 1 and arr.shape[0] != len(names):
            raise ValueError(f"{path} has depth {arr.shape[0]}, the model {len(names)}")
        for name, a in zip(names, arr if len(names) > 1 else [arr]):
            sd[name] = a.T if transposed else a
    if leaves:
        raise ValueError(f"JAX params hold arrays the port model has no place for: "
                         f"{sorted(leaves)}")
    return sd


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Fill `model` (a `Model` or an `NRMSModel`) from the JAX parameter
    tree. Raises KeyError for a missing array, ValueError for one left
    over, and RuntimeError (from `load_state_dict`) for one of the wrong
    shape."""
    sd = _state_dict_from_jax(params, _table_of(model))
    dtype = next(model.parameters()).dtype
    tensors = {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in sd.items()}
    model.load_state_dict(tensors, strict=True)
    return model


def params_from_model(model: nn.Module) -> dict:
    """The JAX parameter tree of `model` (nested dicts of numpy arrays)."""
    sd = {k: v.detach().cpu().numpy() for k, v in full_state_dict(model).items()}
    tree: dict = {}
    for path, names, transposed in _table_of(model):
        arrs = [sd.pop(n).T if transposed else sd.pop(n) for n in names]
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.stack(arrs) if len(names) > 1 else arrs[0]
    if sd:
        raise ValueError(f"model parameters with no place in the JAX tree: {sorted(sd)}")
    return _lists(tree)


def _lists(node):
    """The tree with every dict keyed 0, 1, ... as the list it stands for."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


# the NRMS reference's user encoder holds the news encoder itself, so its
# state_dict repeats the news encoder's tensors under this prefix
NRMS_ALIAS = "user_encoder.news_encoder."


def load_torch_checkpoint(path: str, config_or_model, device=None) -> nn.Module:
    """Load a reference checkpoint file into a port model, the counterpart
    of `digat_tpu.interop.load_torch_checkpoint`. The file holds
    `{model_name: state_dict}` (the reference trainer's format; the entry
    `config.model_name` for the DIGAT family, `config.nrms_model` for NRMS)
    or a bare state_dict. For NRMS the aliased `user_encoder.news_encoder.*`
    copies are dropped. The port keeps the reference's names, so the rest
    loads as it is, strictly: a missing or stray tensor raises
    (RuntimeError). `config_or_model`: the model to fill, or a `Config`,
    for which a model of its family is built on `device` (CUDA unless the
    caller names one). -> the model."""
    from digat_tpu_torch.models.model import Model
    from digat_tpu_torch.models.nrms import NRMSModel

    if isinstance(config_or_model, nn.Module):
        model, config = config_or_model, config_or_model.config
    else:
        config = config_or_model
        model = (NRMSModel if config.model_family == "nrms" else Model)(config, device=device)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    name = config.model_name if config.model_family == "digat" else config.nrms_model
    sd = blob[name] if name in blob else blob
    if config.model_family == "nrms":
        sd = {k: v for k, v in sd.items() if not k.startswith(NRMS_ALIAS)}
    dtype = next(model.parameters()).dtype
    model.load_state_dict({k: torch.as_tensor(v).to(dtype) for k, v in sd.items()}, strict=True)
    return model
