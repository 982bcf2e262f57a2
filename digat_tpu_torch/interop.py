"""Carry parameters between the JAX package's tree and a port model.

`load_jax_params(model, params)` takes the `digat_tpu` parameter tree of
the model's family (nested dicts of arrays, as `digat_tpu.models.model.
Model.init` builds it for MSA-DIGAT and `digat_tpu.models.nrms.NRMSModel.
init` for NRMS and NRMS-SA, converted to numpy by the caller) and fills the
port model's parameters. It is strict both ways, like `digat_tpu/interop.py`: every
array of the tree is used exactly once and every parameter of the model is
filled, or it raises. `params_from_model(model)` goes the other way: the
JAX tree, as numpy arrays in the model's dtype, so a port model's trained
weights can be handed back to the JAX package.

JAX stores linear weights `[in, out]`; `nn.Linear` stores `[out, in]`, so
weights transpose. Per-depth stacks (leading depth axis) split into the
`nn.ModuleList` entries. One table of (JAX path, port names) serves both
directions (one table per family)."""

from __future__ import annotations

from typing import Iterator, List, Mapping, Tuple

import numpy as np
import torch

from torch import nn


def _linear(src: str, dst: str, bias: bool = True):
    yield f"{src}/w", [f"{dst}.weight"], True
    if bias:
        yield f"{src}/b", [f"{dst}.bias"], False


def _gat_stack(src: str, dst: str, depth: int):
    for name, bias in (("W", True), ("ffn1", False), ("ffn2", False), ("ffn3", True),
                       ("a", False)):
        yield f"{src}/{name}/w", [f"{dst}_{name}.{i}.weight" for i in range(depth)], True
        if bias:
            yield f"{src}/{name}/b", [f"{dst}_{name}.{i}.bias" for i in range(depth)], False


def _table(depth: int) -> Iterator[Tuple[str, List[str], bool]]:
    """(JAX path, port state_dict names, transposed) for every parameter of
    MSA-DIGAT. More than one name: a per-depth stack, one name per depth."""
    m, g = "news_encoder.multiheadSelfattention", "graph_encoder"
    yield "news_encoder/word_embedding", ["news_encoder.word_embedding.weight"], False
    yield from _linear("news_encoder/pool/affine1", "news_encoder.attention.affine1")
    yield from _linear("news_encoder/pool/affine2", "news_encoder.attention.affine2", bias=False)
    yield from _linear("news_encoder/msa/W_K", f"{m}.W_K", bias=False)
    yield from _linear("news_encoder/msa/W_Q", f"{m}.W_Q")
    yield from _linear("news_encoder/msa/W_V", f"{m}.W_V")
    yield f"{g}/topic_node_embedding", [f"{g}.topic_node_embedding"], False
    yield from _linear(f"{g}/news_ctx/cand_attn/K", f"{g}.candidate_attention.K", bias=False)
    yield from _linear(f"{g}/news_ctx/cand_attn/Q", f"{g}.candidate_attention.Q")
    yield from _linear(f"{g}/news_ctx/gate", f"{g}.news_graph_W")
    yield from _linear(f"{g}/user_ctx/K", f"{g}.user_news_K", bias=False)
    yield from _linear(f"{g}/user_ctx/Q", f"{g}.user_news_Q")
    yield from _linear(f"{g}/user_ctx/affine", f"{g}.featureAffine")
    yield from _linear(f"{g}/user_ctx/attn/K", f"{g}.userAttention.K", bias=False)
    yield from _linear(f"{g}/user_ctx/attn/Q", f"{g}.userAttention.Q")
    yield from _gat_stack(f"{g}/news_gat", f"{g}.news_graph_attention", depth)
    yield from _gat_stack(f"{g}/user_gat", f"{g}.user_graph_attention", depth)


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
    return list(_table(model.config.graph_depth))


def _leaves(params: Mapping) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
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
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
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
    return tree
