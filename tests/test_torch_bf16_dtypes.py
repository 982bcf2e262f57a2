"""The dtypes at each kernel's boundary at `compute_dtype` bfloat16: the
port's wrappers of A, A', B, C and D, recorded over one training step and
one eval forward of the graph encoder (CPU), against the avals of the JAX
package's `pallas_call`s over the same (its kernel path, traced in
interpret mode):

    A   x bf16, weights bf16 -> fp32 pooled
    A'  dp fp32 -> dx bf16, weight gradients fp32
    B   x and query fp32, weights bf16 -> fp32
    C   k1, k2, k3 fp32, a bf16 -> fp32 scores
    D   fp32 rows of the bf16 dx -> fp32 table gradient"""

import jax
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from digat_tpu.data.user_graph import build_user_graph_np
from digat_tpu_torch.models import graph_encoders as PG
from digat_tpu_torch.models import news_encoders as PN
from digat_tpu_torch.ops import emb_grad as EG
from digat_tpu_torch.ops import gat_layer as GL
from digat_tpu_torch.ops import gat_scores as GS
from digat_tpu_torch.ops import msa_encoder as ME
from tests.test_torch_support import bf16_step_case, jax_interpret, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _jax_pallas_dtypes(closed):
    """{kernel: (input dtypes, output dtypes)} of every pallas_call in a
    jaxpr, each kernel told by its operands: A forward (12 inputs), A'
    (13), C forward (4), C backward (5), D (int32 ids first), B (10)."""
    found = {}

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                ins = [str(v.aval.dtype) for v in eqn.invars]
                outs = [str(v.aval.dtype) for v in eqn.outvars]
                kind = "D" if ins[0] == "int32" else \
                    {12: "A", 13: "A'", 4: "C", 5: "C bwd", 10: "B"}.get(len(ins))
                found[kind] = (ins, outs)
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    if isinstance(sub, jcore.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jcore.Jaxpr):
                        walk(sub)

    walk(closed.jaxpr)
    return found


def _eval_inputs(cat_idx, H, C, D, Gn):
    """Stage-2 inputs of the graph encoder for four rows, from a seed."""
    B = 4
    rng = np.random.default_rng(0)
    cat = np.asarray(cat_idx)[:B]
    ug, cm = build_user_graph_np(cat, H, C)
    graph = (rng.random((B, Gn, Gn)) < 0.3) | np.eye(Gn, dtype=bool)
    gmask = np.concatenate([np.zeros((B, 1), bool), rng.random((B, Gn - 1)) < 0.8], 1)
    return (rng.normal(size=(B, H, D)).astype(np.float32), ug, cm, cat,
            rng.normal(size=(B, Gn, D)).astype(np.float32), graph, gmask,
            rng.normal(size=(B, D)).astype(np.float32))


def test_kernel_boundaries_have_the_jax_kernels_dtypes(monkeypatch):
    jm, params, pm, jt, jb, pt, pb = bf16_step_case(seed=2)
    cfg = jm.config
    ev = _eval_inputs(pb.cat_idx.numpy(), cfg.max_history_num, cfg.category_num,
                      cfg.news_embedding_dim, cfg.news_graph_size)
    with jax_interpret():
        jx = _jax_pallas_dtypes(jax.make_jaxpr(
            lambda p: jax.grad(jm.loss)(p, jt, jb, jax.random.PRNGKey(0)))(params))
        jx.update(_jax_pallas_dtypes(jax.make_jaxpr(
            lambda p: jm.inference(jm.cast_params(p), *ev))(params)))
    want = {
        "A": ({jx["A"][0][0]}, set(jx["A"][0][2:10]), set(jx["A"][1])),
        "A'": ({jx["A'"][0][12]}, {jx["A'"][1][0]}, set(jx["A'"][1][1:])),
        "B": ({jx["B"][0][0], jx["B"][0][2]}, set(jx["B"][0][3:]), set(jx["B"][1])),
        "C": (set(jx["C"][0][:3]), {jx["C"][0][3]}, set(jx["C"][1])),
        "D": ({jx["D"][0][3]}, set(jx["D"][1])),
    }
    assert want == {"A": ({"bfloat16"}, {"bfloat16"}, {"float32"}),
                    "A'": ({"float32"}, {"bfloat16"}, {"float32"}),
                    "B": ({"float32"}, {"bfloat16"}, {"float32"}),
                    "C": ({"float32"}, {"bfloat16"}, {"float32"}),
                    "D": ({"float32"}, {"float32"})}
    got = {}
    s = lambda *ts: {str(t.dtype).replace("torch.", "") for t in ts}
    wrappers = (ME.msa_encoder_pooled, GL.interactive_gat_layer_fused,
                GS.interactive_gat_scores_fused_y, EG.embedding_grad)

    def rec_a(x, mask, *rest, **kw):
        out = wrappers[0](x, mask, *rest, **kw)
        got["A"] = (s(x), s(*rest[:8]), s(out))

        def hook(dp):  # A' on the cotangent the graph hands the encoder
            dx, *dw = ME.msa_encoder_bwd(x.detach(), mask, *(t.detach() for t in rest[:8]),
                                         dp, rest[8])
            got["A'"] = (s(dp), s(dx), s(*dw))

        if out.requires_grad:
            out.register_hook(hook)
        return out

    def rec_b(x, adj, query, *w, **kw):
        out = wrappers[1](x, adj, query, *w, **kw)
        got["B"] = (s(x, query), s(*w), s(out))
        return out

    def rec_c(y, k3, a_vec):
        out = wrappers[2](y, k3, a_vec)
        got["C"] = (s(y, k3), s(a_vec), s(out))
        return out

    def rec_d(tok, g, vocab):
        out = wrappers[3](tok, g, vocab)
        got["D"] = (s(g), s(out))
        return out

    monkeypatch.setattr(PN, "msa_encoder_pooled", rec_a)
    monkeypatch.setattr(PG, "interactive_gat_layer_fused", rec_b)
    monkeypatch.setattr(PG, "interactive_gat_scores_fused_y", rec_c)
    monkeypatch.setattr(EG, "embedding_grad", rec_d)
    pm.loss(pt, pb, 1).backward()
    pm.inference(*(torch.from_numpy(np.array(a)) for a in ev))
    assert got == want, (got, want)
