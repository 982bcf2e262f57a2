"""The port's NRMS family (NRMS, NRMS-SA) against `digat_tpu` on the CPU, at
small widths (4 heads of width 6, word dim 24, L 12, history 10, M 3):

  * eval logits of `forward_indexed` against `digat_tpu.models.nrms` on the
    same weights, JAX with `use_pallas=True` under Pallas interpret (both
    towers then take kernel E) and with `use_pallas=False`, <= 1e-5;
  * the dual-cache `NRMSCachedScorer` against JAX's: scores <= 1e-5 and the
    same rank file; the port's forward logits[:, 0] equal its scorer's
    scores, as tests/test_nrms.py checks for JAX; `compute_scores` picks
    the scorer by family and needs `augmented_news`;
  * weights: `digat_tpu.interop.torch_to_nrms_params` of the port's
    state_dict and the port's `params_from_model` give back the JAX tree,
    and `load_jax_params` is strict both ways;
  * training: a 30-step fp64, dropout-off NRMS-SA trajectory against the
    JAX train step (loss <= 1e-9 relative, parameters <= 1e-7 absolute); a
    step's dropout sites (7 for NRMS-SA, 4 for NRMS); a two-epoch NRMS
    `Trainer` run, resumed from its epoch-1 checkpoint bit for bit."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import interop as jax_interop
from digat_tpu.config import Config as JaxConfig
from digat_tpu.eval import metrics as JM
from digat_tpu.eval.scorer import NRMSCachedScorer as JaxNRMSScorer
from digat_tpu.models.model import TrainBatch as JaxTrainBatch
from digat_tpu.models.nrms import NRMSTables as JaxNRMSTables
from digat_tpu.ops.pallas import runtime as jax_runtime
from digat_tpu.train import optimizer as jax_optimizer
from digat_tpu.train.train_step import make_train_step
from digat_tpu_torch import layers
from digat_tpu_torch.config import Config
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.eval import metrics as M
from digat_tpu_torch.eval.scorer import NRMSCachedScorer, compute_scores
from digat_tpu_torch.interop import load_jax_params, params_from_model
from digat_tpu_torch.models.model import TrainBatch
from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables
from digat_tpu_torch.ops.msa_attention_grouped import group_size
from digat_tpu_torch.train import optimizer
from digat_tpu_torch.train.train_step import train_step
from digat_tpu_torch.train.trainer import Trainer
from tests.test_torch_support import (NRMS_GEO, impressions, nrms_arrays, nrms_models,
                                      nrms_train_corpus)

MODELS = ["NRMS-SA", "NRMS"]
NEWS = 40


def _limit(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def arrays():
    return nrms_arrays(np.random.default_rng(0), NEWS, Config(**NRMS_GEO))


def _batch(seed, B=6, K=4):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, NEWS, (B, NRMS_GEO["max_history_num"]))
    hist[0] = 0  # a cold user: every history slot is the pad news
    hist[1, 4:] = 0
    return TrainBatch(history_idx=hist.astype(np.int32), cat_idx=np.zeros_like(hist, np.int32),
                      sample_idx=rng.integers(0, NEWS, (B, 1 + K)).astype(np.int32),
                      weight=np.ones(B, np.float32))


def _jax_tables(arrays):
    return JaxNRMSTables(*(jnp.asarray(arrays[f]) for f in JaxNRMSTables._fields))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas_interpret", "xla"])
@pytest.mark.parametrize("model", MODELS)
def test_eval_logits_match_jax(arrays, model, use_pallas):
    jm, params, pm = nrms_models(seed=1, use_pallas=use_pallas, nrms_model=model)
    b = _batch(2)
    jax_runtime.set_interpret(use_pallas)
    try:
        want = np.asarray(jm.forward_indexed(params, _jax_tables(arrays),
                                             JaxTrainBatch(*map(jnp.asarray, b)),
                                             jax.random.PRNGKey(0), False))
    finally:
        jax_runtime.set_interpret(False)
    tables = NRMSTables.from_arrays(SimpleNamespace(**arrays), "cpu")
    with torch.inference_mode():
        got = pm.forward_indexed(tables, batching.to_device(b, "cpu")).numpy()
    assert np.abs(got - want).max() <= _limit(want)
    assert np.abs(want).max() > 1e-3  # the logits are not all ~0


@pytest.mark.parametrize("model", MODELS)
def test_scorer_matches_jax_and_the_forward(arrays, model, tmp_path):
    jm, params, pm = nrms_models(seed=3, nrms_model=model)
    cfg = pm.config
    hist, cat, imp, cand, _ = impressions(np.random.default_rng(4), NEWS, cfg, 9, 5)
    hist[0] = 0
    want = JaxNRMSScorer(jm, batch_size=16).score_items(params, _jax_tables(arrays), hist, cat,
                                                         imp, cand)
    scorer = NRMSCachedScorer(pm, batch_size=16)
    got = scorer.score_items(SimpleNamespace(**arrays), hist, cat, imp, cand)
    assert scorer.timings["stage2_batches"] == 3
    assert np.abs(got - want).max() <= _limit(want)
    files = []
    for tag, s, write, group in (("port", got, M.write_rank_file, M.group_by_impression),
                                 ("jax", want, JM.write_rank_file, JM.group_by_impression)):
        write(str(tmp_path / tag), group(imp, s))
        files.append((tmp_path / tag).read_text())
    assert files[0] == files[1]
    # the cached scores are the training forward's logits of candidate 0
    batch = TrainBatch(history_idx=torch.from_numpy(hist[imp]).long(),
                       cat_idx=torch.from_numpy(cat[imp]).long(),
                       sample_idx=torch.from_numpy(cand[:, None]).long(),
                       weight=torch.ones(len(cand)))
    with torch.inference_mode():
        fwd = pm.forward_indexed(NRMSTables.from_arrays(SimpleNamespace(**arrays), "cpu"),
                                 batch)[:, 0].numpy()
    assert np.abs(fwd - got).max() <= _limit(got)


def test_compute_scores_dispatches_on_family(arrays):
    _, _, pm = nrms_models(seed=5)
    corpus = nrms_train_corpus(np.random.default_rng(6), pm.config, NEWS, 8, 20, dev_imps=7)
    corpus.nrms_tables = lambda: SimpleNamespace(**arrays)
    split = corpus.splits["dev"]
    scores = NRMSCachedScorer(pm, 16).score_items(SimpleNamespace(**arrays), split.history_idx,
                                                  split.cat_idx, corpus.dev_imp_index,
                                                  corpus.dev_cand)
    want = M.score_impressions_flat(corpus.dev_imp_index, corpus.dev_labels, scores)
    assert compute_scores(pm, corpus, "dev", batch_size=16) == want
    corpus.nrms_tables = lambda: SimpleNamespace(**{**arrays, "augmented_news": None})
    with pytest.raises(ValueError, match="augmented-news"):
        compute_scores(pm, corpus, "dev", batch_size=16)


@pytest.mark.parametrize("model", MODELS)
def test_weights_round_trip_through_jax_interop(model):
    jm, params, pm = nrms_models(seed=7, nrms_model=model)
    for back in (jax_interop.torch_to_nrms_params(pm.state_dict(), jm.config),
                 params_from_model(pm)):
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(a, b)
    other = NRMSModel(pm.config, device="cpu", generator=torch.Generator().manual_seed(9))
    load_jax_params(other, params)
    for (n, a), b in zip(other.state_dict().items(), pm.state_dict().values()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_load_jax_params_is_strict_for_nrms(change):
    _, params, pm = nrms_models(seed=8)
    params = jax.tree.map(np.array, params)
    err = {"missing": KeyError, "extra": ValueError, "shape": RuntimeError}[change]
    if change == "missing":
        del params["sa_gate"]["b"]
    elif change == "extra":
        params["user_pool"]["unused"] = np.zeros(2, np.float32)
    else:
        params["user_msa"]["W_Q"]["b"] = np.zeros(3, np.float32)
    with pytest.raises(err):
        load_jax_params(NRMSModel(pm.config, device="cpu"), params)
    _, plain_params, _ = nrms_models(seed=8, nrms_model="NRMS")
    with pytest.raises(KeyError):  # NRMS-SA needs the SA weights NRMS has not
        load_jax_params(NRMSModel(pm.config, device="cpu"), plain_params)


def test_config_fields_match_jax():
    port, ref = Config(), JaxConfig()
    for f in ("model_family", "nrms_model", "nrms_head_num", "nrms_head_dim",
              "nrms_attention_dim", "augmented_news_num"):
        assert getattr(port, f) == getattr(ref, f), f
    Config(**NRMS_GEO).validate()
    for bad in (dict(model_family="bert"), dict(nrms_model="NRMS-XL")):
        with pytest.raises(ValueError, match="unknown"):
            Config(**{**NRMS_GEO, **bad}).validate()
    for ported in (dict(news_encoder="CNN"), dict(graph_encoder="wo_SA")):
        Config(**{**NRMS_GEO, "model_family": "digat", **ported}).validate()
    for bad in (dict(news_encoder="LSTM"), dict(graph_encoder="GCN")):
        with pytest.raises(ValueError, match="unknown"):
            Config(**{**NRMS_GEO, "model_family": "digat", **bad}).validate()


def test_production_towers_take_e_geometry():
    """At the JAX defaults (20 heads of 20, titles of 32, histories of 50)
    both towers are on E's geometry, as the JAX package routes them."""
    cfg = Config()
    dk = cfg.nrms_head_dim
    assert group_size(cfg.nrms_head_num, cfg.max_title_length, dk) == 4
    assert group_size(cfg.nrms_head_num, cfg.max_history_num, dk) == 2
    assert group_size(cfg.nrms_head_num, 130, dk) == 0  # F's


@pytest.mark.parametrize("model,sites", [("NRMS-SA", 7), ("NRMS", 4)])
def test_training_step_draws_its_dropout_sites(arrays, model, sites, monkeypatch):
    """A training forward draws one mask per dropout site, under the step's
    seed: the same seed gives the same loss and gradients, another another
    loss."""
    drawn = []
    real = layers.apply_dropout

    def recording(x, rate, seed, site):
        drawn.append((site, rate))
        return real(x, rate, seed, site)

    monkeypatch.setattr(layers, "apply_dropout", recording)
    tables = NRMSTables.from_arrays(SimpleNamespace(**arrays), "cpu")
    batch = batching.to_device(_batch(10), "cpu")
    losses, grads = [], []
    for seed in (5, 5, 6):
        drawn.clear()
        pm = NRMSModel(Config(**{**NRMS_GEO, "nrms_model": model, "dropout_rate": 0.2}),
                       device="cpu", generator=torch.Generator().manual_seed(0))
        loss = pm.loss(tables, batch, seed)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append(torch.cat([p.grad.reshape(-1) for p in pm.parameters()]))
        assert [s for s, _ in drawn] == list(range(sites))
    # candidates' tower, the augmented titles' tower, the gate (p / 2), the
    # history's tower; NRMS has no augmented titles and no gate
    want = [0.2] * 4 + [0.1] + [0.2] * 2 if model == "NRMS-SA" else [0.2] * 4
    assert [r for _, r in drawn] == want
    assert np.isfinite(losses).all() and bool(torch.isfinite(grads[0]).all())
    assert losses[0] == losses[1] and torch.equal(grads[0], grads[1])
    assert losses[2] != losses[0]


class _Float64Numpy:
    """`jax.numpy` with `float32` read as `float64`. The JAX NRMS model casts
    its representations and logits to float32 (`forward_indexed`,
    `loss_parts`: its bf16 path computes them in at least fp32), which would
    round an fp64 trajectory there; seen through this, the JAX model keeps
    fp64 end to end, as the port does."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_fp64_nrms_sa_training_trajectory_matches_jax(monkeypatch):
    """30 steps of the port's plain NRMS-SA training path (fp64, dropout
    off, clip 1.0, lr 1e-3) against the JAX train step on the same plain
    batches, both in fp64 throughout."""
    from digat_tpu.models import nrms as jax_nrms

    jm, params, pm = nrms_models(seed=0, dropout_rate=0.0)
    monkeypatch.setattr(jax_nrms, "jnp", _Float64Numpy())
    pm = pm.double()
    corpus = nrms_train_corpus(np.random.default_rng(1), pm.config, NEWS, 14, 75)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    batches = [b for e in range(4) for b in batching.train_batches(
        corpus.splits["train"].history_idx, corpus.splits["train"].cat_idx,
        corpus.train_behavior_row, corpus.train_pos, neg, 8, epoch_seed=e)][:30]
    assert len(batches) == 30 and all(isinstance(b, TrainBatch) for b in batches)
    lr = 1e-3
    opt = optimizer.Adam(pm.named_parameters(), 0.0, 1.0)
    raw = corpus.nrms_tables()
    tables = NRMSTables.from_arrays(raw, "cpu")
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
        tx = jax_optimizer.make_optimizer(0.0, 1.0, p64)
        state = tx.init(p64)
        step = make_train_step(jm, tx)
        jt = JaxNRMSTables(*(jnp.asarray(getattr(raw, f)) for f in JaxNRMSTables._fields))
        jax_loss, port_loss = [], []
        for b in batches:
            p64, state, loss = step(p64, state, jt, JaxTrainBatch(*map(jnp.asarray, b)),
                                    jax.random.PRNGKey(0), lr)
            jax_loss.append(float(loss))
            port_loss.append(float(train_step(pm, opt, tables, batching.to_device(b, "cpu"),
                                              1, lr)))
        p64 = jax.tree.map(np.asarray, p64)
    jax_loss, port_loss = np.array(jax_loss), np.array(port_loss)
    rel = np.abs(port_loss - jax_loss) / np.abs(jax_loss)
    param_err = max(float(np.abs(a - b).max()) for a, b in
                    zip(jax.tree.leaves(params_from_model(pm)), jax.tree.leaves(p64)))
    print(f"fp64 NRMS-SA trajectory: max loss rel {rel.max():.3e}, max param abs "
          f"{param_err:.3e}, loss {jax_loss[0]:.6f} -> {jax_loss[-1]:.6f}")
    assert rel.max() <= 1e-9
    assert param_err <= 1e-7
    assert jax_loss[-5:].mean() < jax_loss[:5].mean()  # the trajectory went somewhere


def test_nrms_trainer_two_epochs_then_resume(tmp_path):
    geo = {**NRMS_GEO, "nrms_model": "NRMS", "epoch_override": 2, "lr": 2e-3, "batch_size": 8}
    data = nrms_train_corpus(np.random.default_rng(4), Config(**geo), 50, 10, 40)
    del data.tables  # the NRMS family reads nrms_tables() only

    def run(run_dir, **over):
        model = NRMSModel(Config(**{**geo, **over}), device="cpu",
                          generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, model.config, data, str(run_dir), verbose=False)
        assert trainer.dedup_capacity() == 0
        return trainer.train(), model

    full, model_full = run(tmp_path / "full")
    assert [h["epoch"] for h in full] == [1, 2]
    assert full[1]["loss"] < full[0]["loss"]
    assert all(np.isfinite(h["step_losses"]).all() for h in full)
    assert len(full[0]["step_losses"]) == 5 and full[0]["overflow_batches"] == 0
    assert (tmp_path / "full" / "best.ckpt").exists()
    assert (tmp_path / "full" / "dev-epoch2.txt").exists()
    first, _ = run(tmp_path / "first", early_stopping_epoch=-1)
    assert [h["epoch"] for h in first] == [1]
    assert first[0]["step_losses"] == full[0]["step_losses"]
    resumed, model_resumed = run(tmp_path / "resumed",
                                 resume=str(tmp_path / "first" / "best.ckpt"))
    assert [h["epoch"] for h in resumed] == [2]
    assert resumed[0]["step_losses"] == full[1]["step_losses"]
    for (n, a), b in zip(model_full.state_dict().items(), model_resumed.state_dict().values()):
        assert torch.equal(a, b), n


def test_softmax_pool_backward_is_autograds_and_more_accurate():
    """The attention pool's written backward is the gradient of its forward
    (gradcheck in fp64, with a masked and an all-masked row); in fp32 on
    rows that are nearly alike (a history of pad slots) its score gradient
    stays closer to fp64 than autograd's, whose rounding leaks into the
    sum over slots that should be 0."""
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.normal(size=(3, 7))).requires_grad_(True)
    feature = torch.from_numpy(rng.normal(size=(3, 7, 5))).requires_grad_(True)
    mask = torch.from_numpy(rng.random((3, 7)) < 0.6)
    mask[1] = False
    masked = lambda s, f: layers.SoftmaxPool.apply(
        torch.where(mask, s, torch.full_like(s, layers.MASK_FILL)), f)
    assert torch.autograd.gradcheck(layers.SoftmaxPool.apply, (scores, feature))
    assert torch.autograd.gradcheck(masked, (scores, feature))
    # fp32 inputs: 64 histories of 50 slots whose rows differ by 1e-3, and
    # (1 - tanh^2) v of the pool, nearly the same for every slot
    f32 = torch.from_numpy(rng.normal(size=(1, 1, 400))
                           + 1e-3 * rng.normal(size=(64, 50, 400))).float()
    s32, g32 = (torch.from_numpy(rng.normal(size=s)).float() for s in ((64, 50), (64, 400)))
    weights = torch.from_numpy(1.0 + 0.01 * rng.normal(size=50)).float()

    def bias_grad(fn, dtype):
        s = s32.to(dtype).requires_grad_(True)
        fn(s, f32.to(dtype)).backward(g32.to(dtype))
        return (s.grad * weights.to(dtype)).sum(0).double()  # the bias gradient's sum

    autograd = lambda s, f: torch.einsum("bl,bld->bd", torch.softmax(s, dim=-1), f)
    want = bias_grad(autograd, torch.float64)
    assert torch.allclose(bias_grad(layers.SoftmaxPool.apply, torch.float64), want,
                          rtol=1e-10, atol=1e-14)
    scale = float(want.abs().max())
    err = {name: float((bias_grad(fn, torch.float32) - want).abs().max()) / scale
           for name, fn in (("written", layers.SoftmaxPool.apply), ("autograd", autograd))}
    assert err["written"] <= 1e-5 and err["written"] * 10 < err["autograd"], err
