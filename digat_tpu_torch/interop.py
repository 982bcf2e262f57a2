"""Carry the JAX package's parameters into a port model.

`load_jax_params(model, params)` takes the `digat_tpu` MSA-DIGAT parameter
tree (nested dicts of arrays, as `digat_tpu.models.model.Model.init` builds
it, converted to numpy by the caller) and fills the port model's
parameters. It is strict both ways, like `digat_tpu/interop.py`: every
array of the tree is used exactly once and every parameter of the model is
filled, or it raises. JAX stores linear weights `[in, out]`; `nn.Linear`
stores `[out, in]`, so weights transpose. Per-depth stacks (leading depth
axis) split into the `nn.ModuleList` entries."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from digat_tpu_torch.models.model import Model


class _Tree:
    """A nested parameter mapping with take-accounting."""

    def __init__(self, params: Mapping):
        self._leaves = {}

        def walk(node, path):
            if isinstance(node, Mapping):
                for k, v in node.items():
                    walk(v, path + (str(k),))
            else:
                self._leaves["/".join(path)] = np.asarray(node)

        walk(params, ())
        self._taken = set()

    def take(self, path: str) -> np.ndarray:
        if path not in self._leaves:
            raise KeyError(f"JAX params have no array '{path}'")
        if path in self._taken:
            raise KeyError(f"array '{path}' used twice")
        self._taken.add(path)
        return self._leaves[path]

    def finish(self) -> None:
        left = sorted(set(self._leaves) - self._taken)
        if left:
            raise ValueError(f"JAX params hold arrays the port model has no place for: {left}")


def _linear(t: _Tree, sd: dict, src: str, dst: str, bias: bool = True) -> None:
    sd[f"{dst}.weight"] = t.take(f"{src}/w").T
    if bias:
        sd[f"{dst}.bias"] = t.take(f"{src}/b")


def _sdp(t: _Tree, sd: dict, src: str, dst: str) -> None:
    _linear(t, sd, f"{src}/K", f"{dst}.K", bias=False)
    _linear(t, sd, f"{src}/Q", f"{dst}.Q")


def _gat_stack(t: _Tree, sd: dict, src: str, dst: str, depth: int) -> None:
    for name, bias in (("W", True), ("ffn1", False), ("ffn2", False), ("ffn3", True),
                       ("a", False)):
        w = t.take(f"{src}/{name}/w")
        b = t.take(f"{src}/{name}/b") if bias else None
        if w.shape[0] != depth:
            raise ValueError(f"{src}/{name}/w has depth {w.shape[0]}, the model {depth}")
        for i in range(depth):
            sd[f"{dst}_{name}.{i}.weight"] = w[i].T
            if bias:
                sd[f"{dst}_{name}.{i}.bias"] = b[i]


def _state_dict_from_jax(params: Mapping, depth: int) -> dict:
    """The port's state_dict (numpy arrays) for a `digat_tpu` MSA-DIGAT
    parameter tree; strict as described in the module docstring."""
    t = _Tree(params)
    sd = {"news_encoder.word_embedding.weight": t.take("news_encoder/word_embedding")}
    _linear(t, sd, "news_encoder/pool/affine1", "news_encoder.attention.affine1")
    _linear(t, sd, "news_encoder/pool/affine2", "news_encoder.attention.affine2", bias=False)
    m = "news_encoder.multiheadSelfattention"
    _linear(t, sd, "news_encoder/msa/W_K", f"{m}.W_K", bias=False)
    _linear(t, sd, "news_encoder/msa/W_Q", f"{m}.W_Q")
    _linear(t, sd, "news_encoder/msa/W_V", f"{m}.W_V")
    g, s = "graph_encoder", "graph_encoder"
    sd[f"{g}.topic_node_embedding"] = t.take(f"{s}/topic_node_embedding")
    _sdp(t, sd, f"{s}/news_ctx/cand_attn", f"{g}.candidate_attention")
    _linear(t, sd, f"{s}/news_ctx/gate", f"{g}.news_graph_W")
    _linear(t, sd, f"{s}/user_ctx/K", f"{g}.user_news_K", bias=False)
    _linear(t, sd, f"{s}/user_ctx/Q", f"{g}.user_news_Q")
    _linear(t, sd, f"{s}/user_ctx/affine", f"{g}.featureAffine")
    _sdp(t, sd, f"{s}/user_ctx/attn", f"{g}.userAttention")
    _gat_stack(t, sd, f"{s}/news_gat", f"{g}.news_graph_attention", depth)
    _gat_stack(t, sd, f"{s}/user_gat", f"{g}.user_graph_attention", depth)
    t.finish()
    return sd


def load_jax_params(model: Model, params: Mapping) -> Model:
    """Fill `model` from the JAX parameter tree. Raises KeyError for a
    missing array, ValueError for one left over, and RuntimeError (from
    `load_state_dict`) for one of the wrong shape."""
    sd = _state_dict_from_jax(params, model.config.graph_depth)
    tensors = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
    model.load_state_dict(tensors, strict=True)
    return model
