"""Where the JAX package leaves a bf16 op to XLA, the port rounds as XLA's
CPU backend does, and that backend rounds the same whether the op is
jitted (the program `make_train_step` compiles) or run op by op: bit for
bit, on seeded bf16 inputs at small shapes.

  * `x @ w + b`: the product rounded to bf16, then the sum
    (`layers.linear`);
  * `jax.nn.sigmoid`: 1 / (1 + exp(-x)) rounded op by op (`layers.sigmoid`);
  * `jax.nn.leaky_relu` with its slope and a division by `math.sqrt`, each a
    weak-typed scalar rounded to bf16 (`layers.leaky_relu`,
    `layers.scale_down`);
  * the CNN bank, `_conv1d_same` then ReLU: the convolution rounded, then
    the bias added (`layers.ConvBank`)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import layers as JL
from digat_tpu_torch import layers as L
from tests.test_torch_support import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _bf(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.float32).astype(jnp.bfloat16)


def _t(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def _linear_case(rng):
    x, w, b = _bf(rng, (64, 48)), _bf(rng, (48, 40), 0.2), _bf(rng, (40,), 0.5)
    lin = torch.nn.Linear(48, 40, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(_t(w).T)
        lin.bias.copy_(_t(b))
    return (lambda x, w, b: x @ w + b), (x, w, b), lambda: L.linear(_t(x), lin)


def _conv_case(rng):
    x = _bf(rng, (6, 12, 20))
    params = {"convs": [{"w": _bf(rng, (3, 20, 16), 0.2), "b": _bf(rng, (16,), 0.5)}]}
    bank = L.ConvBank("naive", 20, 16, 3, torch.Generator().manual_seed(0)).to(torch.bfloat16)
    with torch.no_grad():
        bank.conv.weight.copy_(_t(params["convs"][0]["w"]).permute(2, 1, 0))
        bank.conv.bias.copy_(_t(params["convs"][0]["b"]))
    return (lambda x, p: JL.conv1d_bank(p, x, "naive", 3)), (x, params), lambda: bank(_t(x))


def _elementwise(jax_fn, port_fn):
    def case(rng):
        t = _bf(rng, (4096,), 3.0)
        return jax_fn, (t,), lambda: port_fn(_t(t))
    return case


CASES = {
    "linear": _linear_case,
    "sigmoid": _elementwise(jax.nn.sigmoid, L.sigmoid),
    "leaky_relu": _elementwise(lambda t: jax.nn.leaky_relu(t, negative_slope=0.2),
                               lambda t: L.leaky_relu(t, 0.2)),
    "scale_down": _elementwise(lambda t: t / math.sqrt(32.0),
                               lambda t: L.scale_down(t, math.sqrt(32.0))),
    "conv_bank": _conv_case,
}


@pytest.mark.parametrize("op", sorted(CASES))
def test_port_rounds_as_jitted_and_eager_xla(op):
    jax_fn, args, port = CASES[op](np.random.default_rng(11))
    eager, jitted = jax_fn(*args), jax.jit(jax_fn)(*args)
    assert eager.dtype == jitted.dtype == jnp.bfloat16
    assert bool((eager == jitted).all())
    got = port()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _t(jitted))
