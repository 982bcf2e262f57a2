"""One rank of the port's data-parallel tests (`tests/test_torch_parallel.py`)
and of its row-sharded word table (`tests/test_torch_mesh_model.py`): a
gloo process group on the CPU, joined through torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
by `parallel.dist.init_distributed`, with the job's "mesh_model" (1 if
absent) as its grid's model axis.

    python -m tests.torch_dist_worker <job.pt> <out_dir>

The job file (written by the test) holds, by key, what to run:
"digat" / "nrms" an fp64 training trajectory (a configuration, the weights,
the tables and each step's node batch; each rank steps the rows of its
data index), "trajectories" more of them by name (optionally resumed from
a checkpoint, saving one after a step, at another dtype, recording the
step-1 gradients with the word table's put together), and
"scorers" the two cached scorers over a corpus, "node_epoch" one epoch of
the trainer on this rank's node. The rank writes `<out_dir>/rank<r>.pt`:
each part's results, and which of jax, jaxlib and digat_tpu it imported
(none may be). With "fail_rank", that rank then raises and the others
enter an all-reduce, which must end in an error. It imports torch, numpy
and the port only."""

import copy
import sys
from types import SimpleNamespace

import torch


def _trajectory(ctx, spec: dict) -> dict:
    from digat_tpu_torch.config import Config
    from digat_tpu_torch.data import batching
    from digat_tpu_torch.interop import params_from_model
    from digat_tpu_torch.models.model import CorpusTables, Model, TrainBatch
    from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables
    from digat_tpu_torch.parallel import sharded_table
    from digat_tpu_torch.train import checkpoint
    from digat_tpu_torch.train.optimizer import Adam
    from digat_tpu_torch.train.train_step import train_step

    cfg = Config(**spec["config"]).validate()
    nrms = cfg.model_family == "nrms"
    model = (NRMSModel if nrms else Model)(cfg, device="cpu", dist=ctx)
    if spec.get("double", True):
        model.double()
    model.load_state_dict(spec["state"])
    shards = sharded_table.tables(model)
    opt = Adam(model.named_parameters(), 0.0, 1.0, shards=shards)
    if "resume" in spec:
        checkpoint.load(spec["resume"], model, opt)
    tables = (NRMSTables if nrms else CorpusTables).from_arrays(
        SimpleNamespace(**spec["tables"]), "cpu")
    out = {"loss": [], "params": [], "kind": [],
           "table_rows": [tuple(t.weight.shape) for t in shards.values()]}
    for k, b in enumerate(spec["batches"]):
        rows = batching.rank_rows(TrainBatch(*b), ctx.local_data_rank, ctx.local_data_world,
                                  spec.get("news_node_id"), spec.get("capacity", 0))
        loss = train_step(model, opt, tables, batching.to_device(rows, "cpu"), 1, spec["lr"],
                          ctx)
        out["loss"].append(float(loss))
        out["params"].append(copy.deepcopy(params_from_model(model)))  # views of the weights
        out["kind"].append(type(rows).__name__)
        if k == 0 and spec.get("grads"):
            out["grads"] = {n: (shards[n].gather(p.grad) if n in shards else p.grad).clone()
                            for n, p in model.named_parameters()}
        if spec.get("save", (0, ""))[0] == k + 1:
            checkpoint.save(spec["save"][1], model, opt, k + 1, write=ctx.is_main)
    return out


def _node_epoch(ctx, spec: dict, out_dir: str) -> dict:
    """One epoch of `Trainer.train_epoch` on this rank's node (every rank a
    node of its own here) -> its step losses and kinds of batch."""
    from digat_tpu_torch.config import Config
    from digat_tpu_torch.models.model import CorpusTables, Model
    from digat_tpu_torch.train.trainer import Trainer

    cfg = Config(**spec["config"]).validate()
    model = Model(cfg, device="cpu")
    model.load_state_dict(spec["state"])
    corpus = SimpleNamespace(**spec["corpus"])
    corpus.splits = {k: SimpleNamespace(**v) for k, v in corpus.splits.items()}
    trainer = Trainer(model, cfg, corpus, f"{out_dir}/run", verbose=False, dist=ctx)
    tables = CorpusTables.from_arrays(SimpleNamespace(**spec["tables"]), "cpu")
    rec = trainer.train_epoch(1, tables, spec["capacity"])
    return {"losses": rec["step_losses"], "node": ctx.node, "nodes": ctx.nodes}


def _scorers(ctx, spec: dict) -> dict:
    """Both cached scorers over the spec's corpus (the models built on this
    rank's grid: a model axis shards their word tables)."""
    from digat_tpu_torch.config import Config
    from digat_tpu_torch.eval.scorer import CachedScorer, NRMSCachedScorer, compute_scores
    from digat_tpu_torch.models.model import Model
    from digat_tpu_torch.models.nrms import NRMSModel

    out = {}
    for family, scorer, build in (("digat", CachedScorer, Model),
                                  ("nrms", NRMSCachedScorer, NRMSModel)):
        part = spec[family]
        model = build(Config(**part["config"]).validate(), device="cpu", dist=ctx)
        model.load_state_dict(part["state"])
        corpus = SimpleNamespace(**part["corpus"])
        tables = SimpleNamespace(**part["tables"])
        corpus.tables = corpus.nrms_tables = lambda tables=tables: tables
        split = corpus.splits["dev"]
        s = scorer(model, part["batch_size"], ctx)
        scores = s.score_items(tables, split.history_idx, split.cat_idx, corpus.dev_imp_index,
                               corpus.dev_cand)
        metrics = compute_scores(model, corpus, "dev", batch_size=part["batch_size"], dist=ctx)
        out[family] = {"scores": scores, "metrics": metrics, "timings": s.timings}
    return out


def main(job_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from digat_tpu_torch.config import Config
    from digat_tpu_torch.parallel import dist as dist_lib

    job = torch.load(job_path, weights_only=False)  # written by the test that started us
    ctx = dist_lib.init_distributed(Config(device="cpu", mesh_model=job.get("mesh_model", 1)),
                                    backend="gloo", timeout_s=120)
    try:
        out = {"world": ctx.world, "rank": ctx.rank, "backend": ctx.backend,
               "grid": (ctx.data_rank, ctx.model_rank, ctx.data_world, ctx.model_world)}
        for key in ("digat", "nrms"):
            if key in job:
                out[key] = _trajectory(ctx, job[key])
        if "trajectories" in job:
            out["trajectories"] = {k: _trajectory(ctx, v) for k, v in job["trajectories"].items()}
        if "scorers" in job:
            out["scorers"] = _scorers(ctx, job["scorers"])
        if "node_epoch" in job:
            out["node_epoch"] = _node_epoch(ctx, job["node_epoch"], out_dir)
        out["imported"] = sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "jaxlib", "digat_tpu"))
        torch.save(out, f"{out_dir}/rank{ctx.rank}.pt")
        if "fail_rank" in job:  # one rank raises; the others' next collective must end
            if ctx.rank == job["fail_rank"]:
                raise RuntimeError(f"rank {ctx.rank} raises")
            ctx.all_reduce_sum_([torch.ones(1)])
    finally:
        dist_lib.destroy(ctx)


if __name__ == "__main__":
    main(*sys.argv[1:3])
