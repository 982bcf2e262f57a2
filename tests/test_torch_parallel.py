"""The port's data parallelism (`digat_tpu_torch.parallel.dist`, the
sharded batches, train step, trainer, scorers and CLI) against the JAX
package's `data` mesh, on the CPU.

Ranks are gloo processes (`tests/torch_dist_worker.py`, started with
torchrun's environment; they import no JAX and record so); the JAX side
runs on 2 of the 8 CPU devices that `tests/conftest.py` forces. One pair
of ranks runs every multi-rank part (a module fixture):

  (a) `dedup_shards`, `rank_rows` and the node-strided `train_batches` /
      `eval_batches` give index blocks identical to `digat_tpu.data.batching`
      for the same seeds, dedup on, off and overflowing; where nodes hold a
      sample fewer than others and the JAX package gives them a batch
      fewer, the port's shorter nodes end with an all-weight-0 batch, and
      two such nodes of the trainer take as many steps, with the same
      losses (then one rank raises and the other's next all-reduce ends
      in an error);
  (b) a 6-step fp64, dropout-off MSA-DIGAT trajectory of the port's 2-rank
      step (per-shard dedup) against `make_shardmap_train_step` on a
      2-device mesh under `jax.enable_x64`, and against the single-device
      `make_train_step` on the same global batches, from the same weights:
      per-step loss within 1e-9 relative, parameters after step 5 within
      1e-7. JAX's shard_map step differentiates psum(num) / psum(den)
      under `check_vma=False`, where psum transposes to psum, so each
      device's gradient is already summed once and its explicit psum makes
      the gradient W times the global one (recorded by the last test of
      (b)): its clip and Adam's eps act on that. The port sums the
      gradients once, as the single-device step and the reference's DDP
      see them; the JAX side here runs the shard_map step with its
      optimizer behind a 1/W scale, which divides the factor out;
  (c) its step 6, a tail batch whose second shard is all weight 0: loss
      within 1e-9 relative and parameters within 1e-7 again (an average of
      per-rank means would halve this loss);
  (d) NRMS-SA, plain batches, 3 steps (the last such a tail), the same
      tolerances;
  (e) the 2-rank `CachedScorer` and `NRMSCachedScorer` in fp64 against the
      single-process port and the JAX scorer: scores within 1e-6 of the
      score scale and the same ranks; metrics against JAX's sharded
      `compute_scores` within 1e-6;
  (f) `python -m torch.distributed.run --nproc_per_node 2 -m
      digat_tpu_torch.cli --device cpu`, one epoch at narrow widths with
      consistent distribution flags and a profile directory: both ranks
      exit 0, only rank 0 writes `#1-dev`, `#1-test` and the rank files,
      the ranks' dev metrics agree, each rank writes its trace;
  (g) a `mesh_model` that does not divide a node's ranks, a `mesh_data`
      x `mesh_model` that is not the world size, flags that contradict the
      launcher and a bad rendezvous raise (the model axis itself:
      tests/test_torch_mesh_model.py)."""

import dataclasses
import glob
import os
import re
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from digat_tpu.data import batching as jax_batching
from digat_tpu.eval import metrics as JM
from digat_tpu.eval.scorer import CachedScorer as JaxCachedScorer
from digat_tpu.eval.scorer import NRMSCachedScorer as JaxNRMSCachedScorer
from digat_tpu.eval.scorer import compute_scores as jax_compute_scores
from digat_tpu.models import nrms as jax_nrms
from digat_tpu.models.model import CorpusTables as JaxTables
from digat_tpu.models.model import TrainBatch as JaxTrainBatch
from digat_tpu.parallel import mesh as mesh_lib
from digat_tpu.train import optimizer as jax_optimizer
from digat_tpu.train.train_step import make_shardmap_train_step, make_train_step
from digat_tpu_torch.config import Config
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.eval import metrics as PM
from digat_tpu_torch.eval.scorer import CachedScorer, NRMSCachedScorer
from digat_tpu_torch.models.model import DedupTrainBatch, Model, TrainBatch
from digat_tpu_torch.models.nrms import NRMSModel
from digat_tpu_torch.parallel import dist as dist_lib
from tests.test_torch_support import (corpus_arrays, impressions, models, nrms_arrays,
                                      nrms_models, nrms_train_corpus, train_corpus)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, B, CAP, LR = 2, 8, 512, 1e-3
LOSS_RTOL, PARAM_ATOL, SCORE_TOL = 1e-9, 1e-7, 1e-6


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launcher_env(rank: int, world: int, port: int, local_world: int = 0) -> dict:
    """torchrun's environment: `world` ranks, `local_world` a node (all on
    one node by default)."""
    local_world = local_world or world
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank % local_world),
            "LOCAL_WORLD_SIZE": str(local_world), "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port)}


def start_ranks(job: dict, tmp, world: int = WORLD, local_world: int = 0,
                timeout: float = 300) -> tuple:
    """Run `job` on `world` gloo ranks (tests/torch_dist_worker.py) ->
    (their exit codes, their logs)."""
    path = os.path.join(tmp, "job.pt")
    torch.save(job, path)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_worker", path, str(tmp)], cwd=REPO,
        env={**os.environ, **launcher_env(r, world, port, local_world), "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


def run_ranks(job: dict, tmp, world: int = WORLD) -> list:
    """Run `job` on `world` gloo ranks of one node -> each rank's output
    dict."""
    rcs, logs = start_ranks(job, tmp, world)
    for rc, log in zip(rcs, logs):
        assert rc == 0, log[-4000:]
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


class _Float64Numpy:
    """`jax.numpy` with `float32` read as `float64`, so that the JAX NRMS
    model's casts to float32 keep an fp64 trajectory fp64 (as in
    tests/test_torch_nrms.py)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


# ---------------------------------------------------------------------------
# the inputs: every part's weights, tables and batches, made from seeds
# ---------------------------------------------------------------------------
def digat_case():
    jm, params, pm = models(seed=0, dropout_rate=0.0)
    cfg = pm.config
    # 43 samples: five full batches of 8, then a tail of 3 whose second
    # shard (rows 4-7) is all weight 0
    corpus = train_corpus(np.random.default_rng(1), cfg, 40, 30, 43)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    split = corpus.splits["train"]
    batches = list(batching.train_batches(split.history_idx, split.cat_idx,
                                          corpus.train_behavior_row, corpus.train_pos, neg, B,
                                          epoch_seed=0))
    arrays = vars(corpus.tables())
    spec = {"config": dataclasses.asdict(cfg), "state": pm.double().state_dict(),
            "tables": arrays, "batches": [tuple(b) for b in batches], "lr": LR,
            "news_node_id": corpus.news_node_id, "capacity": CAP}
    return jm, params, spec


def nrms_case():
    jm, params, pm = nrms_models(seed=0, dropout_rate=0.0)
    corpus = nrms_train_corpus(np.random.default_rng(1), pm.config, 30, 14, 19)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets, 4,
                                    np.random.default_rng(1))
    split = corpus.splits["train"]
    batches = list(batching.train_batches(split.history_idx, split.cat_idx,
                                          corpus.train_behavior_row, corpus.train_pos, neg, B,
                                          epoch_seed=0))
    spec = {"config": dataclasses.asdict(pm.config), "state": pm.double().state_dict(),
            "tables": vars(corpus.nrms_tables()), "batches": [tuple(b) for b in batches],
            "lr": LR}
    return jm, params, spec


def scorer_case():
    """fp64 weights, a 37-news corpus and 9 impressions of 3 items (eval
    batch 8, so stage 1's last chunk and stage 2's last batch are short)
    for each family -> {family: (jax model, fp64 params, worker spec)}."""
    out = {}
    for family, (jm, params, pm) in (("digat", models(seed=3)), ("nrms", nrms_models(seed=4))):
        cfg = pm.config
        rng = np.random.default_rng(7)
        arrays = (corpus_arrays if family == "digat" else nrms_arrays)(rng, 37, cfg)
        hist, cat, imp_index, cand, labels = impressions(rng, 37, cfg, 9, 3)
        corpus = {"splits": {"dev": SimpleNamespace(history_idx=hist, cat_idx=cat)},
                  "dev_imp_index": imp_index, "dev_cand": cand, "dev_labels": labels}
        p64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
        out[family] = (jm, p64, {"config": dataclasses.asdict(cfg),
                                 "state": pm.double().state_dict(), "tables": arrays,
                                 "corpus": corpus, "batch_size": B})
    return out


@pytest.fixture(scope="module")
def cases():
    return {"digat": digat_case(), "nrms": nrms_case(), "scorers": scorer_case()}


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    job = {"digat": cases["digat"][2], "nrms": cases["nrms"][2],
           "scorers": {k: v[2] for k, v in cases["scorers"].items()}}
    return run_ranks(job, tmp_path_factory.mktemp("ranks"))


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def jax_trajectory(jm, params, spec, table_type, data_parallel: bool = True):
    """The JAX data-parallel step (shard_map over a 2-device `data` mesh,
    its optimizer behind a 1/W scale: see (b)), or the single-device step
    on the global batches, in fp64 over the spec's batches -> (losses,
    parameters after each step)."""
    mesh = mesh_lib.make_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])
    repl = mesh_lib.replicated(mesh)
    losses, snaps = [], []
    with jax.enable_x64(True):
        p = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
        tx = jax_optimizer.make_optimizer(0.0, 1.0, p)
        if data_parallel:
            tx = optax.chain(optax.scale(1.0 / WORLD), tx)
            step = make_shardmap_train_step(jm, tx, mesh)
        else:
            step = make_train_step(jm, tx)
        state = jax.device_put(tx.init(p), repl)
        p = jax.device_put(p, repl)
        tables = jax.device_put(table_type(*(jnp.asarray(spec["tables"][f])
                                             for f in table_type._fields)), repl)
        for b in spec["batches"]:
            batch = JaxTrainBatch(*b)
            if not data_parallel:
                p, state, loss = step(p, state, tables, batch, jax.random.PRNGKey(0), LR)
                losses.append(float(loss))
                snaps.append(jax.tree.map(np.array, p))
                continue
            if spec.get("capacity"):
                sharded = jax_batching.dedup_shards(batch, spec["news_node_id"],
                                                    spec["capacity"], WORLD)
                batch = batch if sharded is None else sharded
            p, state, loss = step(p, state, tables, mesh_lib.shard_batch_arrays(mesh, batch),
                                  jax.random.PRNGKey(0), LR)
            losses.append(float(loss))
            snaps.append(jax.tree.map(np.array, p))  # copies: the step donates p
    return np.array(losses), snaps


@pytest.fixture(scope="module")
def jax_digat(cases):
    jm, params, spec = cases["digat"]
    return {dp: jax_trajectory(jm, params, spec, JaxTables, dp) for dp in (True, False)}


@pytest.fixture(scope="module")
def jax_nrms_run(cases):
    jm, params, spec = cases["nrms"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_nrms, "jnp", _Float64Numpy())
        return jax_trajectory(jm, params, spec, jax_nrms.NRMSTables)


def max_param_err(port_tree, jax_tree) -> float:
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(jax.tree.leaves(port_tree), jax.tree.leaves(jax_tree)))


# ---------------------------------------------------------------------------
# (a) index blocks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus_small():
    cfg = Config(dataset="synthetic", vocabulary_size=60, category_num=4, max_title_length=8,
                 max_history_num=6, SAG_neighbors=3, SAG_hops=2).validate()
    return train_corpus(np.random.default_rng(2), cfg, 50, 40, 61)


@pytest.mark.parametrize("capacity", [0, CAP, 16])  # off, on, overflowing
def test_rank_rows_match_jax_dedup_shards(corpus_small, capacity):
    c = corpus_small
    neg = sampling.sample_negatives(c.train_neg_flat, c.train_neg_offsets, 4,
                                    np.random.default_rng(3))
    split = c.splits["train"]
    kinds = set()
    for b in batching.train_batches(split.history_idx, split.cat_idx, c.train_behavior_row,
                                    c.train_pos, neg, B, epoch_seed=4):
        want = jax_batching.dedup_shards(JaxTrainBatch(*b), c.news_node_id, capacity,
                                         WORLD) if capacity else None
        if capacity:
            got = batching.dedup_shards(b, c.news_node_id, capacity, WORLD)
            assert (got is None) == (want is None)
            if got is not None:
                for f in DedupTrainBatch._fields:
                    np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        for r in range(WORLD):
            rows = batching.rank_rows(b, r, WORLD, c.news_node_id, capacity)
            kinds.add(type(rows).__name__)
            if want is not None:
                local = jax.tree.map(lambda x: np.asarray(x)[r], want._replace(emb=None))
                for f in DedupTrainBatch._fields:
                    np.testing.assert_array_equal(getattr(rows, f), getattr(local, f))
            else:
                assert isinstance(rows, TrainBatch)
                for f in TrainBatch._fields:
                    np.testing.assert_array_equal(getattr(rows, f),
                                                  np.asarray(getattr(b, f))[r * 4:(r + 1) * 4])
    assert kinds == ({"DedupTrainBatch"} if capacity == CAP else {"TrainBatch"})
    with pytest.raises(ValueError, match="does not split"):
        batching.rank_rows(b, 0, 3)


@pytest.mark.parametrize("dedup", [0, CAP])
def test_node_strided_train_batches_match_jax(corpus_small, dedup):
    c = corpus_small
    neg = sampling.sample_negatives(c.train_neg_flat, c.train_neg_offsets, 4,
                                    np.random.default_rng(5))
    split = c.splits["train"]
    args = (split.history_idx, split.cat_idx, c.train_behavior_row, c.train_pos, neg, B)
    for node in range(3):
        kw = dict(epoch_seed=9, shard_index=node, shard_count=3,
                  news_node_id=c.news_node_id if dedup else None, dedup_titles=dedup)
        got = list(batching.train_batches(*args, **kw))
        want = list(jax_batching.train_batches(*args, **kw))
        assert len(got) == len(want) == 3  # 61 samples: 21, 20, 20 a node
        for g, w in zip(got, want):
            assert type(g).__name__ == type(w).__name__
            for f in g._fields:
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("dedup", [0, CAP])
def test_every_node_takes_as_many_batches(corpus_small, dedup):
    """61 samples over 7 nodes at B 8: five nodes hold 9 samples (two
    batches), two hold 8 (one batch in the JAX package). Each of those two
    ends with an all-weight-0 batch, so every rank takes two steps; the
    batches before it are JAX's, and every sample has weight 1 once."""
    c = corpus_small
    neg = sampling.sample_negatives(c.train_neg_flat, c.train_neg_offsets, 4,
                                    np.random.default_rng(5))
    split = c.splits["train"]
    args = (split.history_idx, split.cat_idx, c.train_behavior_row, c.train_pos, neg, B)
    seen = []
    for node in range(7):
        kw = dict(epoch_seed=9, shard_index=node, shard_count=7,
                  news_node_id=c.news_node_id if dedup else None, dedup_titles=dedup)
        got = list(batching.train_batches(*args, **kw))
        want = list(jax_batching.train_batches(*args, **kw))
        assert len(got) == 2 and len(want) == (2 if node < 5 else 1)
        for g, w in zip(got, want):
            assert type(g).__name__ == type(w).__name__
            for f in g._fields:
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        if node >= 5:
            assert not np.asarray(got[1].weight).any()
            assert type(got[1]).__name__ == ("DedupTrainBatch" if dedup else "TrainBatch")
        order = np.random.default_rng(9).permutation(61)[node::7]
        seen += [int(i) for g, i in zip(np.concatenate([b.weight for b in got]), np.concatenate(
            [order, np.zeros(16 - len(order), np.int64)])) if g]
        kept = list(batching.train_batches(*args, **kw, drop_remainder=True))
        assert len(kept) == 1  # where the shortest node stops
    assert sorted(seen) == list(range(61))


def test_nodes_a_sample_short_take_as_many_steps_and_a_raising_rank_ends_the_run(tmp_path):
    """Two nodes of one rank each run `Trainer.train_epoch` on 17 samples at
    B 8: node 0 holds 9 (two batches), node 1 holds 8 (one, then an
    all-weight-0 batch). Both take two steps with the same global losses;
    before the padding, rank 0 waited in a step that rank 1 never took.
    Then rank 1 raises, and rank 0's next all-reduce ends in an error."""
    _, _, pm = models(seed=0, dropout_rate=0.0)
    cfg = dataclasses.replace(pm.config, batch_size=B)
    corpus = train_corpus(np.random.default_rng(8), cfg, 30, 20, 17)
    fields = ("news_node_id", "train_behavior_row", "train_pos", "train_neg_flat",
              "train_neg_offsets")
    spec = {"config": dataclasses.asdict(cfg), "state": pm.state_dict(),
            "tables": vars(corpus.tables()), "capacity": CAP,
            "corpus": {**{f: getattr(corpus, f) for f in fields},
                       "splits": {"train": vars(corpus.splits["train"])}}}
    rcs, logs = start_ranks({"node_epoch": spec, "fail_rank": 1}, tmp_path, local_world=1,
                            timeout=120)
    assert rcs[0] != 0 and rcs[1] != 0, logs
    assert "rank 1 raises" in logs[1] and "all_reduce" in logs[0], logs[0][-4000:]
    out = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["node_epoch"]
           for r in range(2)]
    assert [(o["node"], o["nodes"]) for o in out] == [(0, 2), (1, 2)]
    assert len(out[0]["losses"]) == len(out[1]["losses"]) == 2
    assert out[0]["losses"] == out[1]["losses"] and np.isfinite(out[0]["losses"]).all()


def test_node_strided_eval_batches_match_jax():
    rng = np.random.default_rng(6)
    hist, cat = rng.integers(0, 30, (9, 5)), rng.integers(0, 4, (9, 5))
    imp_index, cand = rng.integers(0, 9, 23), rng.integers(0, 30, 23)
    for shard in range(WORLD):
        got = list(batching.eval_batches(hist, cat, imp_index, cand, 4, "cpu",
                                         shard_index=shard, shard_count=WORLD))
        want = list(jax_batching.eval_batches(hist, cat, imp_index, cand, 4,
                                              shard_index=shard, shard_count=WORLD))
        assert [v for _, v in got] == [v for _, v in want]
        for (g, _), (w, _) in zip(got, want):
            for f in g._fields:
                np.testing.assert_array_equal(getattr(g, f).numpy(), getattr(w, f))


# ---------------------------------------------------------------------------
# (b)-(d) training against the JAX data-parallel step
# ---------------------------------------------------------------------------
def test_ranks_import_no_jax_and_join_one_group(ranks):
    assert [(r["rank"], r["world"], r["backend"]) for r in ranks] == [(0, 2, "gloo"),
                                                                      (1, 2, "gloo")]
    assert all(r["imported"] == [] for r in ranks)


@pytest.mark.parametrize("data_parallel", [True, False], ids=["shard_map", "one_device"])
def test_two_rank_msa_digat_trajectory_matches_jax(ranks, jax_digat, data_parallel):
    jax_loss, jax_params = jax_digat[data_parallel]
    loss = np.array(ranks[0]["digat"]["loss"])
    assert ranks[1]["digat"]["loss"] == ranks[0]["digat"]["loss"]  # the global loss
    assert ranks[0]["digat"]["kind"] == ["DedupTrainBatch"] * 6  # per-shard dedup
    rel = np.abs(loss - jax_loss) / np.abs(jax_loss)
    err = max_param_err(ranks[0]["digat"]["params"][4], jax_params[4])
    print(f"2-rank MSA-DIGAT: loss rel {rel[:5].max():.3e}, params after step 5 {err:.3e}")
    assert rel[:5].max() <= LOSS_RTOL
    assert err <= PARAM_ATOL
    assert max_param_err(ranks[1]["digat"]["params"][4], ranks[0]["digat"]["params"][4]) == 0


@pytest.mark.parametrize("data_parallel", [True, False], ids=["shard_map", "one_device"])
def test_tail_batch_with_an_all_weight_0_shard_matches_jax(cases, ranks, jax_digat,
                                                            data_parallel):
    jax_loss, jax_params = jax_digat[data_parallel]
    tail = cases["digat"][2]["batches"][5]
    assert tail[3][:3].all() and not tail[3][3:].any()  # rank 1's rows all weight 0
    loss = ranks[0]["digat"]["loss"][5]
    err = max_param_err(ranks[0]["digat"]["params"][5], jax_params[5])
    print(f"tail step: loss {loss:.12f} (JAX {jax_loss[5]:.12f}), params {err:.3e}")
    assert abs(loss - jax_loss[5]) <= LOSS_RTOL * abs(jax_loss[5])
    assert err <= PARAM_ATOL


def test_jax_shardmap_step_gradient_is_world_times_the_global_one(cases):
    """Recorded, not repaired (no file of digat_tpu changes): with an
    identity optimizer, JAX's shard_map step moves the parameters by W
    times the global gradient that `jax.grad` of the single-device loss
    gives (W = 2 here), while its loss is the global one."""
    jm, params, spec = cases["digat"]
    mesh = mesh_lib.make_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])
    repl = mesh_lib.replicated(mesh)
    with jax.enable_x64(True):
        p = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
        tables = JaxTables(*(jnp.asarray(spec["tables"][f]) for f in JaxTables._fields))
        batch = JaxTrainBatch(*spec["batches"][0])
        loss_of = jax.jit(lambda q: jm.loss(q, tables, batch, jax.random.PRNGKey(0)))
        want = jax.jit(jax.grad(loss_of))(p)
        tx = optax.scale(1.0)
        step = make_shardmap_train_step(jm, tx, mesh)
        moved, _, loss = step(jax.device_put(jax.tree.map(jnp.array, p), repl),
                              jax.device_put(tx.init(p), repl), jax.device_put(tables, repl),
                              mesh_lib.shard_batch_arrays(mesh, batch), jax.random.PRNGKey(0),
                              1.0)
        got = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), p, moved)
        assert abs(float(loss) - float(loss_of(p))) < 1e-12
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, WORLD * np.asarray(w), rtol=1e-9, atol=1e-12)


def test_two_rank_nrms_sa_steps_match_jax(cases, ranks, jax_nrms_run):
    jax_loss, jax_params = jax_nrms_run
    out = ranks[0]["nrms"]
    assert out["kind"] == ["TrainBatch"] * 3 and not cases["nrms"][2]["batches"][2][3][4:].any()
    rel = np.abs(np.array(out["loss"]) - jax_loss) / np.abs(jax_loss)
    err = max(max_param_err(out["params"][k], jax_params[k]) for k in range(3))
    print(f"2-rank NRMS-SA: loss rel {rel.max():.3e}, params {err:.3e}")
    assert rel.max() <= LOSS_RTOL
    assert err <= PARAM_ATOL


# ---------------------------------------------------------------------------
# (e) the sharded scorers
# ---------------------------------------------------------------------------
def _ranks_of(imp_index, scores):
    return [np.argsort(-s, kind="stable") for s in PM.group_by_impression(imp_index, scores)]


@pytest.mark.parametrize("family", ["digat", "nrms"])
def test_sharded_scorer_matches_one_process_and_jax(cases, ranks, family):
    jm, p64, spec = cases["scorers"][family]
    c = SimpleNamespace(**spec["corpus"])
    split = c.splits["dev"]
    item_args = (split.history_idx, split.cat_idx, c.dev_imp_index, c.dev_cand)
    got = [r["scorers"][family] for r in ranks]
    np.testing.assert_array_equal(got[0]["scores"], got[1]["scores"])
    assert [g["timings"]["items"] for g in got] == [14, 13]  # 27 items strided
    # the single-process port on the same fp64 weights
    pm = (Model if family == "digat" else NRMSModel)(
        Config(**spec["config"]).validate(), device="cpu").double()
    pm.load_state_dict(spec["state"])
    one = (CachedScorer if family == "digat" else NRMSCachedScorer)(pm, B).score_items(
        SimpleNamespace(**spec["tables"]), *item_args)
    jax_tables = (JaxTables if family == "digat" else jax_nrms.NRMSTables)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_nrms, "jnp", _Float64Numpy())
        jt = jax_tables(*(jnp.asarray(spec["tables"][f]) for f in jax_tables._fields))
        scorer = JaxCachedScorer if family == "digat" else JaxNRMSCachedScorer
        want = scorer(jm, B, mesh=False).score_items(p64, jt, *item_args)
        corpus = SimpleNamespace(**spec["corpus"], tables=lambda: jt, nrms_tables=lambda: jt)
        want_metrics = jax_compute_scores(jm, p64, corpus, "dev", batch_size=B)
    scale = max(1.0, float(np.abs(want).max()))
    for other in (one, want):
        assert np.abs(got[0]["scores"] - other).max() <= SCORE_TOL * scale
        for g, w in zip(_ranks_of(c.dev_imp_index, got[0]["scores"]),
                        _ranks_of(c.dev_imp_index, other)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0]["metrics"], want_metrics, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0]["metrics"],
                               JM.score_impressions_flat(c.dev_imp_index, c.dev_labels, want),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (f) the CLI under torchrun, (g) what raises
# ---------------------------------------------------------------------------
def test_cli_under_torchrun_on_two_cpu_ranks(tmp_path):
    flags = ["--device", "cpu", "--dataset", "synthetic", "--epoch", "1", "--batch_size", "16",
             "--max_history_num", "12", "--max_title_length", "16", "--SAG_neighbors", "3",
             "--graph_depth", "2", "--eval_batch_size", "64", "--word_embedding_dim", "32",
             "--MSA_head_num", "4", "--MSA_head_dim", "8", "--attention_dim", "16",
             "--data_root", "data", "--run_root", "runs", "--mesh_data", "2",
             "--num_processes", "1", "--process_id", "0", "--profile_dir", "trace"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(WORLD), "-m", "digat_tpu_torch.cli", *flags],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True, text=True,
        timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    results = tmp_path / "runs" / "results" / "synthetic" / "MSA-DIGAT"
    assert sorted(os.listdir(results)) == ["#1-dev", "#1-test"]  # rank 0 alone took an index
    assert (results / "#1-dev").read_text().strip() and (results / "#1-test").read_text().strip()
    run = tmp_path / "runs" / "synthetic" / "MSA-DIGAT"
    assert os.listdir(run) == ["#1"]
    assert {"best.ckpt", "config.json", "dev-epoch1.txt", "dev_log.txt",
            "test-prediction.txt"} <= set(os.listdir(run / "#1"))
    dev = {int(r): m for r, m in re.findall(r"\[rank (\d)/2\] Epoch 1: .*\| dev (.*)", log)}
    assert sorted(dev) == [0, 1] and dev[0] == dev[1], log[-4000:]
    assert log.count("[test] epoch 1:") == 1
    assert len(glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))) == WORLD


def test_mesh_and_rendezvous_flags_raise(monkeypatch):
    cpu = dict(device="cpu")
    # one process holds no model axis of 2: 2 does not divide its 1 rank
    with pytest.raises(ValueError, match="mesh_model 2 needs as many ranks"):
        dist_lib.init_distributed(Config(mesh_model=2, **cpu))
    with pytest.raises(ValueError, match="mesh_data 2"):  # one process, no launcher
        dist_lib.init_distributed(Config(mesh_data=2, **cpu))
    with pytest.raises(ValueError, match="host:port"):
        dist_lib.init_distributed(Config(coordinator_address="nohost", num_processes=2,
                                         process_id=1, **cpu))
    with pytest.raises(ValueError, match="not a rank"):
        dist_lib.init_distributed(Config(coordinator_address="localhost:1", num_processes=2,
                                         **cpu))
    # a rendezvous that no rank 0 answers fails loudly
    with pytest.raises(RuntimeError):
        dist_lib.init_distributed(Config(coordinator_address=f"localhost:{free_port()}",
                                         num_processes=2, process_id=1, **cpu), timeout_s=2)
    # one process through the JAX flags alone: a group of one, then gone
    ctx = dist_lib.init_distributed(Config(coordinator_address=f"localhost:{free_port()}",
                                           num_processes=1, mesh_data=1, **cpu))
    try:
        assert (ctx.world, ctx.rank, ctx.backend, ctx.nodes) == (1, 0, "gloo", 1)
        t = torch.ones(3)
        ctx.all_reduce_sum_([t])
        assert t.tolist() == [1.0, 1.0, 1.0]
    finally:
        dist_lib.destroy(ctx)
    assert not torch.distributed.is_initialized()
    # a launcher's world of 2 on 1 node: flags that contradict it raise
    # before any rendezvous
    for k, v in launcher_env(0, 2, free_port()).items():
        monkeypatch.setenv(k, v)
    for over, match in (({"mesh_data": 3}, "world size 2"), ({"num_processes": 2}, "1 nodes"),
                        ({"process_id": 1}, "node rank 0"),
                        ({"coordinator_address": "otherhost:1"}, "contradicts"),
                        ({"mesh_model": 4}, "mesh_model 4 does not divide the 2 ranks"),
                        ({"mesh_model": 2, "mesh_data": 2}, "world size 2")):
        with pytest.raises(ValueError, match=match):
            dist_lib.init_distributed(Config(**over, **cpu))
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    with pytest.raises(RuntimeError, match="incomplete"):
        dist_lib.init_distributed(Config(**cpu))
