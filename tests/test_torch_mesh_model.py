"""The word table row-sharded over a model axis (`--mesh_model` M > 1:
`parallel.sharded_table`, `parallel.dist`'s rank grid, the step's sums over
the data group, the optimizer's shards, checkpoints and the scorer's
gather) against the JAX package's (data, model) mesh and against the
one-process port, on the CPU.

Ranks are gloo processes (`tests/torch_dist_worker.py`, which imports no
JAX). Two module fixtures run every multi-rank part: 4 ranks as a 2 x 2
grid and 2 ranks as a 1 x 2 grid. The JAX side runs on 4 of the 8 CPU
devices that `tests/conftest.py` forces.

  (a) `shard_rows` gives the rows of each addressable shard of JAX's
      `param_shardings(make_mesh(2, 2), ..., True)`; a vocabulary that M
      does not divide raises, and so do the grids that do not fit;
  (b) a 4-step fp64, dropout-0 MSA-DIGAT trajectory of each grid against
      the one-process port, and of the 2 x 2 grid against JAX's
      `make_train_step` on a 2 x 2 mesh (its table placed by
      `param_shardings`; plain jit, so no 1/W scale): loss within 1e-9
      relative, parameters after the last step within 1e-7. The step-1 table gradient, put together from
      the shards, is the one-process gradient, not M times it;
  (c) NRMS-SA, 2 steps, the same tolerances;
  (d) the `sorted_emb_grad false` route's table gradient against D's
      (its plain version on the CPU), within 1e-12;
  (e) a bf16 step pair of the 2 x 2 grid against the one-process bf16 port,
      each loss within 1e-3 relative (the gate of
      tests/test_torch_bf16_steps.py);
  (f) a checkpoint written on a grid resumed in one process, and one
      written in one process resumed on the grid: the next two losses
      within 1e-12 relative; the file holds the whole table and moments;
  (g) both scorers after the gather against one process: within 1e-6 of
      the score scale, the same ranks;
  (h) `embedding_grad_plain(..., row_start)` against the slice of the whole
      table's gradient, hypothesis over ranges;
  (i) the CLI under torchrun at `--mesh_model 2` on 2 ranks: rank 0 alone
      writes, the ranks' dev metrics agree, the checkpoint holds the whole
      table."""

import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from digat_tpu.models import nrms as jax_nrms
from digat_tpu.models.model import CorpusTables as JaxTables
from digat_tpu.models.model import TrainBatch as JaxTrainBatch
from digat_tpu.parallel import mesh as mesh_lib
from digat_tpu.train import optimizer as jax_optimizer
from digat_tpu.train.train_step import make_train_step
from digat_tpu_torch.config import Config
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.eval import metrics as PM
from digat_tpu_torch.eval.scorer import CachedScorer, NRMSCachedScorer
from digat_tpu_torch.interop import params_from_model
from digat_tpu_torch.models.model import CorpusTables, Model, TrainBatch
from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables
from digat_tpu_torch.ops.emb_grad import embedding_grad_plain
from digat_tpu_torch.parallel import dist as dist_lib
from digat_tpu_torch.parallel.sharded_table import ShardedTable, shard_rows
from digat_tpu_torch.train import checkpoint
from digat_tpu_torch.train.optimizer import Adam
from digat_tpu_torch.train.train_step import train_step
from tests.test_torch_parallel import (REPO, _Float64Numpy, free_port, launcher_env,
                                       max_param_err)
from tests.test_torch_support import (corpus_arrays, impressions, models, nrms_arrays,
                                      nrms_models, nrms_train_corpus, port_config,
                                      train_corpus)

B, CAP, LR, STEPS = 8, 512, 1e-3, 4
LOSS_RTOL, PARAM_ATOL, SCORE_TOL, RESUME_RTOL, BF16_RTOL = 1e-9, 1e-7, 1e-6, 1e-12, 1e-3
GRIDS = {"2x2": (2, 2), "1x2": (1, 2)}
TABLE = "news_encoder.word_embedding.weight"


# ---------------------------------------------------------------------------
# the inputs, made from seeds
# ---------------------------------------------------------------------------
def _batches(corpus, cfg, seed: int = 1):
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(seed))
    split = corpus.splits["train"]
    return [tuple(b) for b in batching.train_batches(
        split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg, B,
        epoch_seed=0)]


def digat_case():
    """fp64 MSA-DIGAT weights at dropout 0, a 40-news corpus and its first
    STEPS global batches of 8."""
    jm, params, pm = models(seed=0, dropout_rate=0.0)
    corpus = train_corpus(np.random.default_rng(1), pm.config, 40, 30, 43)
    spec = {"config": dataclasses.asdict(pm.config), "state": pm.double().state_dict(),
            "tables": vars(corpus.tables()), "batches": _batches(corpus, pm.config)[:STEPS],
            "lr": LR, "news_node_id": corpus.news_node_id, "capacity": CAP}
    return jm, params, spec


def nrms_case():
    jm, params, pm = nrms_models(seed=0, dropout_rate=0.0)
    corpus = nrms_train_corpus(np.random.default_rng(1), pm.config, 30, 14, 19)
    spec = {"config": dataclasses.asdict(pm.config), "state": pm.double().state_dict(),
            "tables": vars(corpus.nrms_tables()), "batches": _batches(corpus, pm.config)[:2],
            "lr": LR}
    return jm, params, spec


def bf16_spec(digat_spec):
    """The MSA-DIGAT job at compute_dtype bfloat16, fp32 masters, 2 steps."""
    _, _, pm = models(seed=0, dropout_rate=0.0, compute_dtype="bfloat16")
    return {**digat_spec, "config": dataclasses.asdict(pm.config), "state": pm.state_dict(),
            "batches": digat_spec["batches"][:2], "double": False}


def scorer_case():
    """As tests/test_torch_parallel.py's: weights (cast to fp32 on load), a
    37-news corpus and 9 impressions of 3 items at eval batch 8, for each
    family -> {family: worker spec}."""
    out = {}
    for family, (_, _, pm) in (("digat", models(seed=3)), ("nrms", nrms_models(seed=4))):
        cfg = pm.config
        rng = np.random.default_rng(7)
        arrays = (corpus_arrays if family == "digat" else nrms_arrays)(rng, 37, cfg)
        hist, cat, imp_index, cand, labels = impressions(rng, 37, cfg, 9, 3)
        corpus = {"splits": {"dev": SimpleNamespace(history_idx=hist, cat_idx=cat)},
                  "dev_imp_index": imp_index, "dev_cand": cand, "dev_labels": labels}
        out[family] = {"config": dataclasses.asdict(cfg), "state": pm.double().state_dict(),
                       "tables": arrays, "corpus": corpus, "batch_size": B}
    return out


def one_process(spec, batches=None, resume: str = "", save=None) -> dict:
    """The spec's steps by the one-process port (the whole batch, deduplicated
    as one rank would) -> losses, parameters after each step, step-1
    gradients; `resume` a checkpoint to start from, `save` (k, path) one to
    write after step k."""
    cfg = Config(**spec["config"]).validate()
    nrms = cfg.model_family == "nrms"
    model = (NRMSModel if nrms else Model)(cfg, device="cpu")
    if spec.get("double", True):
        model.double()
    model.load_state_dict(spec["state"])
    opt = Adam(model.named_parameters(), 0.0, 1.0)
    if resume:
        checkpoint.load(resume, model, opt)
    tables = (NRMSTables if nrms else CorpusTables).from_arrays(
        SimpleNamespace(**spec["tables"]), "cpu")
    out = {"loss": [], "params": []}
    for k, b in enumerate(spec["batches"] if batches is None else batches):
        rows = batching.rank_rows(TrainBatch(*b), 0, 1, spec.get("news_node_id"),
                                  spec.get("capacity", 0))
        out["loss"].append(float(train_step(model, opt, tables,
                                            batching.to_device(rows, "cpu"), 1, spec["lr"])))
        out["params"].append(copy.deepcopy(params_from_model(model)))  # views of the weights
        if k == 0:
            out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
        if save and save[0] == k + 1:
            checkpoint.save(save[1], model, opt, k + 1)
    return out


@pytest.fixture(scope="module")
def cases():
    return {"digat": digat_case(), "nrms": nrms_case()}


@pytest.fixture(scope="module")
def one(cases, tmp_path_factory):
    """The one-process port on every job, and its checkpoint after step 2."""
    digat, nrms = cases["digat"][2], cases["nrms"][2]
    path = str(tmp_path_factory.mktemp("one") / "one.ckpt")
    return {"digat": one_process(digat, save=(2, path)), "ckpt": path,
            "nrms": one_process(nrms), "bf16": one_process(bf16_spec(digat))}


def grid_job(cases, one, tmp, data: int) -> dict:
    """Every multi-rank part of a grid of `data` data indices (the bf16 steps
    and the scorers on the 2 x 2 grid only)."""
    digat = {**cases["digat"][2], "grads": True}
    job = {"mesh_model": 2, "trajectories": {
        "digat": {**digat, "save": (2, os.path.join(tmp, "grid.ckpt"))},
        "resumed": {**digat, "batches": digat["batches"][2:], "resume": one["ckpt"],
                    "grads": False},
        "scatter": {**digat, "batches": digat["batches"][:1], "config": {
            **digat["config"], "sorted_emb_grad": False}},
        "nrms": cases["nrms"][2]}}
    if data == 2:
        job["trajectories"]["bf16"] = bf16_spec(cases["digat"][2])
        job["scorers"] = scorer_case()
    return job


def launch(job: dict, tmp, world: int) -> list:
    """`world` gloo ranks of one node on `job`, started and not waited for
    (tests/torch_dist_worker.py; each rank's output in tmp/log<r>)."""
    path = os.path.join(tmp, "job.pt")
    torch.save(job, path)
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_worker", path, str(tmp)], cwd=REPO,
        env={**os.environ, **launcher_env(r, world, port), "OMP_NUM_THREADS": "1"},
        stdout=open(os.path.join(tmp, f"log{r}"), "w"), stderr=subprocess.STDOUT)
        for r in range(world)]


def collect(procs: list, tmp) -> list:
    """Wait for the ranks (killing them past 300 s) -> each rank's output."""
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, open(os.path.join(tmp, f"log{r}")).read()[-4000:]
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(cases, one, tmp_path_factory):
    """Both grids' ranks, started together; the JAX steps on the 2 x 2 mesh
    run while they step."""
    started = {}
    try:
        for name, (data, model) in GRIDS.items():
            tmp = tmp_path_factory.mktemp(f"grid{name}")
            started[name] = (tmp, launch(grid_job(cases, one, tmp, data), tmp, data * model))
        jm, params, spec = cases["digat"]
        jax_out = {"digat": jax_grid_trajectory(jm, params, spec, JaxTables, 2, 2)}
        jm, params, spec = cases["nrms"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_nrms, "jnp", _Float64Numpy())
            jax_out["nrms"] = jax_grid_trajectory(jm, params, spec, jax_nrms.NRMSTables, 2, 2)
    finally:
        grids = {name: {"ranks": collect(procs, tmp), "ckpt": str(tmp / "grid.ckpt")}
                 for name, (tmp, procs) in started.items()}
    return {"grids": grids, "jax": jax_out}


@pytest.fixture(scope="module")
def grids(runs):
    return runs["grids"]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


# ---------------------------------------------------------------------------
# the JAX side: make_train_step on a (data, model) mesh
# ---------------------------------------------------------------------------
def jax_grid_trajectory(jm, params, spec, table_type, data: int, model: int):
    """JAX's train step (plain jit: its TP path) in fp64 on a data x model
    mesh, the word table placed by `param_shardings`, over the spec's
    global batches -> (losses, parameters after each step)."""
    mesh = mesh_lib.make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    repl = mesh_lib.replicated(mesh)
    losses, snaps = [], []
    with jax.enable_x64(True):
        p = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
        tx = jax_optimizer.make_optimizer(0.0, 1.0, p)
        state = jax.device_put(tx.init(p), repl)
        p = jax.device_put(p, mesh_lib.param_shardings(mesh, p, model > 1))
        step = make_train_step(jm, tx)
        tables = jax.device_put(table_type(*(jnp.asarray(spec["tables"][f])
                                             for f in table_type._fields)), repl)
        for b in spec["batches"]:
            p, state, loss = step(p, state, tables,
                                  mesh_lib.shard_batch_arrays(mesh, JaxTrainBatch(*b)),
                                  jax.random.PRNGKey(0), LR)
            losses.append(float(loss))
            snaps.append(jax.tree.map(np.array, p))  # copies: the step donates p
    return np.array(losses), snaps


# ---------------------------------------------------------------------------
# (a) the rows of each rank, and what raises
# ---------------------------------------------------------------------------
def test_shard_rows_are_jax_param_shardings_row_blocks(cases):
    params = cases["digat"][1]
    mesh = mesh_lib.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    placed = jax.device_put(params, mesh_lib.param_shardings(mesh, params, True))
    table = placed["news_encoder"]["word_embedding"]
    V = table.shape[0]
    position = {d: idx for idx, d in np.ndenumerate(mesh.devices)}
    seen = set()
    for shard in table.addressable_shards:
        data_index, model_index = position[shard.device]
        rows = shard.index[0]
        assert (rows.start, rows.stop) == shard_rows(V, 2, model_index)
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      params["news_encoder"]["word_embedding"][rows])
        seen.add((data_index, model_index))
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}
    assert placed["graph_encoder"]["topic_node_embedding"].sharding.is_fully_replicated


def test_a_vocabulary_that_the_model_axis_does_not_divide_raises():
    with pytest.raises(ValueError, match="mesh_model 2"):
        shard_rows(7, 2, 0)
    with pytest.raises(ValueError, match="mesh_model 2"):
        Config(dataset="synthetic", mesh_model=2, vocabulary_size=7, category_num=4).validate()
    assert Config(dataset="synthetic", mesh_model=2, vocabulary_size=8,
                  category_num=4).validate().mesh_model == 2
    # JAX refuses the same placement
    mesh = mesh_lib.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((7, 3), np.float32),
                       jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("model", None)))


@pytest.mark.parametrize("world,local_world,over,match", [
    (2, 2, {"mesh_model": 4}, "does not divide the 2 ranks"),
    (4, 2, {"mesh_model": 4}, "does not divide the 2 ranks"),
    (4, 4, {"mesh_model": 3}, "does not divide the 4 ranks"),
    (4, 4, {"mesh_model": 2, "mesh_data": 1}, "mesh_data 1 x --mesh_model 2"),
    (2, 2, {"mesh_model": 2, "mesh_data": 2}, "world size 2"),
])
def test_grids_that_do_not_fit_the_launch_raise(monkeypatch, world, local_world, over, match):
    for k, v in launcher_env(0, world, free_port(), local_world).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        dist_lib.init_distributed(Config(device="cpu", **over))
    assert not torch.distributed.is_initialized()


def test_a_grid_needs_a_process_group():
    with pytest.raises(ValueError, match="mesh_model 2 needs as many ranks"):
        dist_lib.init_distributed(Config(device="cpu", mesh_model=2))
    with pytest.raises(ValueError, match="mesh_model 2"):
        dist_lib.make_grid(dist_lib.DistContext(), 2)
    cfg = port_config(mesh_model=2)
    ctx = dataclasses.replace(dist_lib.DistContext(), model_world=2)
    with pytest.raises(ValueError, match="process group"):
        Model(cfg, device="cpu", dist=ctx)
    assert isinstance(Model(cfg, device="cpu").news_encoder.word_embedding, torch.nn.Embedding)


# ---------------------------------------------------------------------------
# (b)-(e) training on the grids
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", list(GRIDS))
def test_ranks_stand_on_their_grid_and_hold_their_rows(grids, cases, grid):
    data, model = GRIDS[grid]
    ranks = grids[grid]["ranks"]
    V = cases["digat"][2]["config"]["vocabulary_size"]
    D = cases["digat"][2]["config"]["word_embedding_dim"]
    assert [r["grid"] for r in ranks] == [(r // model, r % model, data, model)
                                         for r in range(data * model)]
    assert all(r["imported"] == [] for r in ranks)
    for r in ranks:
        assert r["trajectories"]["digat"]["table_rows"] == [(V // model, D)]


@pytest.mark.parametrize("grid", list(GRIDS))
def test_msa_digat_trajectory_matches_jax_and_one_process(grids, one, jax_runs, grid):
    ranks = grids[grid]["ranks"]
    got = ranks[0]["trajectories"]["digat"]
    assert all(r["trajectories"]["digat"]["loss"] == got["loss"] for r in ranks)
    assert got["kind"] == ["DedupTrainBatch"] * STEPS
    loss = np.array(got["loss"])
    wants = [("one process", np.array(one["digat"]["loss"]), one["digat"]["params"][-1])]
    if grid == "2x2":
        jax_loss, jax_params = jax_runs["digat"]
        wants.append(("JAX", jax_loss, jax_params[-1]))
    for what, want_loss, want_params in wants:
        rel = np.abs(loss - want_loss) / np.abs(want_loss)
        err = max_param_err(got["params"][-1], want_params)
        print(f"{grid} MSA-DIGAT against {what}: loss rel {rel.max():.3e}, params {err:.3e}")
        assert rel.max() <= LOSS_RTOL
        assert err <= PARAM_ATOL
    # every rank puts the same whole weights together
    for r in ranks[1:]:
        assert max_param_err(r["trajectories"]["digat"]["params"][-1], got["params"][-1]) == 0


@pytest.mark.parametrize("grid", list(GRIDS))
def test_table_gradient_is_the_one_process_gradient_not_m_times_it(grids, one, grid):
    _, model = GRIDS[grid]
    want = one["digat"]["grads"]
    for r in grids[grid]["ranks"]:
        got = r["trajectories"]["digat"]["grads"]
        assert set(got) == set(want)
        for n, g in got.items():
            np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-9, atol=1e-12)
        table = got[TABLE].numpy()
        assert np.abs(table).max() > 0
        assert not np.allclose(table, model * want[TABLE].numpy(), rtol=1e-3, atol=0)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_scatter_add_route_gives_kernel_d_table_gradient(grids, grid):
    for r in grids[grid]["ranks"]:
        t = r["trajectories"]
        d, scatter = t["digat"]["grads"], t["scatter"]["grads"]
        assert t["scatter"]["loss"][0] == t["digat"]["loss"][0]
        np.testing.assert_allclose(scatter[TABLE].numpy(), d[TABLE].numpy(), rtol=0,
                                   atol=1e-12)
        assert np.abs(d[TABLE].numpy()).max() > 0


@pytest.mark.parametrize("grid", list(GRIDS))
def test_nrms_sa_steps_match_one_process(grids, one, jax_runs, grid):
    got = grids[grid]["ranks"][0]["trajectories"]["nrms"]
    assert got["kind"] == ["TrainBatch"] * 2
    wants = [("one process", np.array(one["nrms"]["loss"]), one["nrms"]["params"])]
    if grid == "2x2":
        wants.append(("JAX", *jax_runs["nrms"]))
    for what, want_loss, want_params in wants:
        rel = np.abs(np.array(got["loss"]) - want_loss) / np.abs(want_loss)
        err = max(max_param_err(got["params"][k], want_params[k]) for k in range(2))
        print(f"{grid} NRMS-SA against {what}: loss rel {rel.max():.3e}, params {err:.3e}")
        assert rel.max() <= LOSS_RTOL
        assert err <= PARAM_ATOL


def test_bf16_steps_match_one_process_bf16(grids, one):
    want = np.array(one["bf16"]["loss"])
    for r in grids["2x2"]["ranks"]:
        got = np.array(r["trajectories"]["bf16"]["loss"])
        assert np.isfinite(got).all()
        assert (np.abs(got - want) <= BF16_RTOL * np.abs(want)).all(), (got, want)


# ---------------------------------------------------------------------------
# (f) checkpoints across grid shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", list(GRIDS))
def test_checkpoint_written_on_a_grid_resumes_in_one_process(grids, cases, grid):
    spec = cases["digat"][2]
    state = torch.load(grids[grid]["ckpt"], weights_only=True)
    V, D = spec["config"]["vocabulary_size"], spec["config"]["word_embedding_dim"]
    assert tuple(state["model"][TABLE].shape) == (V, D)
    assert tuple(state["optimizer"]["mu"][TABLE].shape) == (V, D)
    assert tuple(state["optimizer"]["nu"][TABLE].shape) == (V, D)
    assert state["epoch"] == 2
    resumed = one_process(spec, spec["batches"][2:], resume=grids[grid]["ckpt"])
    grid_loss = grids[grid]["ranks"][0]["trajectories"]["digat"]["loss"][2:]
    np.testing.assert_allclose(resumed["loss"], grid_loss, rtol=RESUME_RTOL, atol=0)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_checkpoint_written_in_one_process_resumes_on_a_grid(grids, one, grid):
    for r in grids[grid]["ranks"]:
        np.testing.assert_allclose(r["trajectories"]["resumed"]["loss"],
                                   one["digat"]["loss"][2:], rtol=RESUME_RTOL, atol=0)


# ---------------------------------------------------------------------------
# (g) the scorers after the gather
# ---------------------------------------------------------------------------
def _ranks_of(imp_index, scores):
    return [np.argsort(-s, kind="stable") for s in PM.group_by_impression(imp_index, scores)]


@pytest.mark.parametrize("family", ["digat", "nrms"])
def test_scorers_after_the_gather_match_one_process(grids, family):
    spec = scorer_case()[family]
    c = SimpleNamespace(**spec["corpus"])
    split = c.splits["dev"]
    pm = (Model if family == "digat" else NRMSModel)(Config(**spec["config"]).validate(),
                                                     device="cpu")
    pm.load_state_dict(spec["state"])
    want = (CachedScorer if family == "digat" else NRMSCachedScorer)(pm, B).score_items(
        SimpleNamespace(**spec["tables"]), split.history_idx, split.cat_idx, c.dev_imp_index,
        c.dev_cand)
    got = [r["scorers"][family] for r in grids["2x2"]["ranks"]]
    scale = max(1.0, float(np.abs(want).max()))
    for g in got:
        np.testing.assert_array_equal(g["scores"], got[0]["scores"])
    assert np.abs(got[0]["scores"] - want).max() <= SCORE_TOL * scale
    for a, b in zip(_ranks_of(c.dev_imp_index, got[0]["scores"]),
                    _ranks_of(c.dev_imp_index, want)):
        np.testing.assert_array_equal(a, b)
    assert [g["timings"]["items"] for g in got] == [7, 7, 7, 6]  # 27 items strided


# ---------------------------------------------------------------------------
# (h) kernel D's plain version on a row range
# ---------------------------------------------------------------------------
@settings(max_examples=40, deadline=None)
@given(V=st.integers(1, 40), D=st.integers(1, 6), ntok=st.integers(0, 120),
       cut=st.tuples(st.floats(0, 1), st.floats(0, 1)), pad=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_plain_row_range_is_the_slice_of_the_whole_gradient(V, D, ntok, cut, pad, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, ntok)
    if pad:
        tok[rng.random(ntok) < 0.6] = 0
    tok = torch.from_numpy(tok)
    g = torch.from_numpy(rng.standard_normal((ntok, D)))
    lo, hi = sorted(int(c * V) for c in cut)
    hi = max(hi, lo + 1) if lo < V else V
    lo = min(lo, hi - 1)
    whole = embedding_grad_plain(tok, g, V)
    part = embedding_grad_plain(tok, g, hi - lo, row_start=lo)
    assert part.shape == (hi - lo, D)
    assert torch.equal(part, whole[lo:hi])


def test_sharded_table_loads_whole_entries_and_refuses_other_sizes():
    table = ShardedTable.__new__(ShardedTable)
    torch.nn.Module.__init__(table)
    table.vocab_size, table.lo, table.hi = 8, 4, 8
    whole = torch.arange(16.0).reshape(8, 2)
    assert torch.equal(table.own_rows(whole), whole[4:])
    assert torch.equal(table.own_rows(whole[:4]), whole[:4])
    with pytest.raises(ValueError, match="neither"):
        table.own_rows(whole[:3])


# ---------------------------------------------------------------------------
# (i) the CLI under torchrun on a 1 x 2 grid
# ---------------------------------------------------------------------------
def test_cli_under_torchrun_with_a_model_axis(tmp_path):
    flags = ["--device", "cpu", "--dataset", "synthetic", "--epoch", "1", "--batch_size", "16",
             "--max_history_num", "12", "--max_title_length", "16", "--SAG_neighbors", "3",
             "--graph_depth", "2", "--eval_batch_size", "64", "--word_embedding_dim", "32",
             "--MSA_head_num", "4", "--MSA_head_dim", "8", "--attention_dim", "16",
             "--data_root", "data", "--run_root", "runs", "--mesh_model", "2"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "digat_tpu_torch.cli", *flags],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    results = tmp_path / "runs" / "results" / "synthetic" / "MSA-DIGAT"
    assert sorted(os.listdir(results)) == ["#1-dev", "#1-test"]
    run = tmp_path / "runs" / "synthetic" / "MSA-DIGAT"
    assert os.listdir(run) == ["#1"]
    dev = {int(r): m for r, m in re.findall(r"\[rank (\d)/2\] Epoch 1: .*\| dev (.*)", log)}
    assert sorted(dev) == [0, 1] and dev[0] == dev[1], log[-4000:]
    assert log.count("[test] epoch 1:") == 1
    cfg = Config(**json.loads((run / "#1" / "config.json").read_text()))
    assert cfg.mesh_model == 2 and cfg.vocabulary_size % 2 == 0
    state = torch.load(run / "#1" / "best.ckpt", weights_only=True)
    assert tuple(state["model"][TABLE].shape) == (cfg.vocabulary_size, 32)
    assert tuple(state["optimizer"]["nu"][TABLE].shape) == (cfg.vocabulary_size, 32)
