"""The plain versions of the port's two kernels against the JAX functions
they replace, both through the JAX CPU composition (`_encoder_xla`,
`_fused_xla`) and through the Pallas kernel in interpret mode.

On a CPU tensor each wrapper runs its plain version and counts no launch;
the CUDA kernels themselves are held against the plain versions on the
card by `chip_smoke.py` and `tests/test_torch_cuda.py`. Tolerance: fp32
rtol/atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import layers as JL
from digat_tpu.ops.pallas.gat_layer import interactive_gat_layer_fused as jax_gat_layer
from digat_tpu.ops.pallas.msa_attention_grouped import group_size, unpad_heads
from digat_tpu.ops.pallas.msa_encoder import msa_encoder_pooled as jax_msa_encoder
from digat_tpu_torch.ops.gat_layer import (
    interactive_gat_layer_fused,
    interactive_gat_layer_plain,
)
from digat_tpu_torch.ops.msa_encoder import msa_encoder_pooled, msa_encoder_pooled_plain
from tests.test_torch_support import MODULE_TOL


def _msa_case(n, L, din, heads, dk, A, seed):
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    msa = JL.mha_init(ks[0], heads, din, dk, dk)
    pool = JL.attn_pool_init(ks[1], heads * dk, A)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, L, din)).astype(np.float32)
    mask = rng.random((n, L)) < 0.75
    mask[0] = False  # all-pad title: uniform pool
    return msa, pool, x, mask


def _port_args(msa, pool, x, mask):
    t = lambda a: torch.from_numpy(np.array(a))
    return (t(x), t(mask), t(msa["W_Q"]["w"]), t(msa["W_Q"]["b"]), t(msa["W_K"]["w"]),
            t(msa["W_V"]["w"]), t(msa["W_V"]["b"]), t(pool["affine1"]["w"]),
            t(pool["affine1"]["b"]), t(pool["affine2"]["w"][:, 0]))


MSA_SHAPES = [  # (n, L, Din, heads, dk, A): group_size > 0 for each
    (11, 8, 24, 4, 8, 16),
    (9, 32, 20, 4, 5, 12),
]


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("shape", MSA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_msa_encoder_plain_vs_jax(shape, interpret):
    n, L, din, heads, dk, A = shape
    assert group_size(heads, L, dk) > 0
    msa, pool, x, mask = _msa_case(n, L, din, heads, dk, A, seed=n)
    padded, _ = jax_msa_encoder(jnp.asarray(x), jnp.asarray(mask), msa, pool, heads, dk,
                                tile=8, interpret=interpret)
    want = np.asarray(unpad_heads(padded, heads, dk))
    got = msa_encoder_pooled_plain(*_port_args(msa, pool, x, mask), heads).numpy()
    assert got.shape == (n, heads * dk)
    np.testing.assert_allclose(got, want, **MODULE_TOL)


def test_msa_encoder_wrapper_on_cpu_is_plain():
    msa, pool, x, mask = _msa_case(*MSA_SHAPES[0], seed=3)
    args = _port_args(msa, pool, x, mask)
    before = msa_encoder_pooled.launches
    got = msa_encoder_pooled(*args, MSA_SHAPES[0][3])
    assert msa_encoder_pooled.launches == before
    torch.testing.assert_close(got, msa_encoder_pooled_plain(*args, MSA_SHAPES[0][3]),
                               rtol=0, atol=0)


def _gat_case(B, G, D, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, G, D)) * 0.3).astype(np.float32)
    adj = (rng.random((B, G, G)) < 0.3) | np.eye(G, dtype=bool)
    adj[0, 1] = False  # a row with no neighbour: uniform alpha
    q = (rng.normal(size=(B, D)) * 0.3).astype(np.float32)
    W, W1, W2, W3 = ((rng.normal(size=(D, D)) * 0.05).astype(np.float32) for _ in range(4))
    bW, b3, a = ((rng.normal(size=(D,)) * 0.05).astype(np.float32) for _ in range(3))
    return x, adj, q, W, bW, W1, W2, W3, b3, a


@pytest.mark.parametrize("B,G,D,interpret", [
    (5, 6, 32, False), (5, 10, 32, False), (3, 14, 64, False),
    (5, 10, 32, True), (3, 14, 64, True),
], ids=["6-xla", "10-xla", "14-xla", "10-pallas_interpret", "14-pallas_interpret"])
def test_gat_layer_plain_vs_jax(B, G, D, interpret):
    case = _gat_case(B, G, D, seed=B + G)
    want = np.asarray(jax_gat_layer(*(jnp.asarray(t) for t in case), interpret=interpret))
    got = interactive_gat_layer_plain(*(torch.from_numpy(t) for t in case)).numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)


def test_jax_gat_layer_pallas_rejects_graphs_under_8_nodes():
    """Fault in the JAX package, recorded in ROADMAP.md section 3: the
    Pallas layer kernel's i-sweep slices 8 centre rows at a time even when
    the graph has fewer nodes (`gat_layer.py` `_UNROLL`), so it fails to
    trace for G < 8. The port's layer takes any G (G=6 above)."""
    case = _gat_case(5, 6, 32, seed=11)
    with pytest.raises(TypeError, match="slice_sizes"):
        jax_gat_layer(*(jnp.asarray(t) for t in case), interpret=True)


def test_gat_layer_wrapper_on_cpu_is_plain():
    case = [torch.from_numpy(t) for t in _gat_case(4, 6, 32, seed=9)]
    before = interactive_gat_layer_fused.launches
    got = interactive_gat_layer_fused(*case)
    assert interactive_gat_layer_fused.launches == before
    torch.testing.assert_close(got, interactive_gat_layer_plain(*case), rtol=0, atol=0)
