"""Experiment configuration for the port.

A copy of the fields of `digat_tpu.config.Config` that the port reads
(the DIGAT family with either news encoder and every graph encoder, the
NRMS family, training, the cached scorers, the data pipeline and the CLI),
with the same names, defaults and per-dataset protocol overrides, plus
`device` (cuda | cpu). Kept as its own copy so the
port never imports the JAX package.

`compute_dtype` bfloat16 runs every model with bf16 compute copies of the
fp32 weights (`models.model.ComputeCopy`), as the JAX package does.

The distribution flags (`mesh_data`, `mesh_model`, `coordinator_address`,
`num_processes`, `process_id`) and `profile_dir` are fields as in the JAX
package; `parallel.dist.init_distributed` reads the first five against
torchrun's environment (a port process is one GPU, a JAX process one
host). `mesh_model` M > 1 row-shards the word table over M ranks
(`parallel.sharded_table`), as the JAX package's `param_shardings` places
it along the `model` axis: the vocabulary must split into M equal blocks,
as JAX's placement requires, and M must divide each node's ranks.

`from_args` also takes the JAX package's TPU-only flags (the PRNG, the
compilation cache and the Pallas switch), so that a JAX command line
parses; they read nothing on the card and are dropped. `sorted_emb_grad`
is a field: true (the default) takes the word table's gradient through
kernel D, false through the library's scatter-add, as the JAX package's
flag routes it to XLA's."""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

def news_graph_size(sag_neighbors: int, sag_hops: int) -> int:
    """Number of nodes in a SAG news graph: hop 0 adds M neighbours, each
    deeper hop branches into M-1 new nodes."""
    size = 1
    frontier = 1
    for hop in range(sag_hops):
        frontier *= sag_neighbors if hop == 0 else (sag_neighbors - 1)
        size += frontier
    return size


# The JAX package's TPU-only flags, name -> default: parsed and dropped (any
# value: none of them reads anything on the card)
JAX_ONLY_FLAGS = {"use_pallas": True, "rng_impl": "rbg", "compilation_cache_dir": ""}

NEWS_ENCODERS = ("MSA", "CNN")
GRAPH_ENCODERS = ("DIGAT", "wo_SA", "Seq_SA", "wo_interaction", "news_graph_wo_inter",
                  "user_graph_wo_inter")
CNN_METHODS = ("naive", "group3", "group5")
COMPUTE_DTYPES = ("float32", "bfloat16")


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


@dataclasses.dataclass
class Config:
    mode: str = "train"  # train | dev | test
    news_encoder: str = "MSA"
    graph_encoder: str = "DIGAT"
    dev_model_path: str = ""
    test_model_path: str = ""
    test_output_file: str = ""
    seed: int = 0
    dataset: str = "MIND-small"  # MIND-small | MIND-large | synthetic
    data_root: str = "data"
    word_threshold: int = 3
    max_title_length: int = 32
    negative_sample_num: int = 4
    max_history_num: int = 50
    epoch: int = 16
    epoch_override: int = 0
    batch_size: int = 64
    lr: float = 1e-4
    weight_decay: float = 0.0
    gradient_clip_norm: float = 1.0
    dev_criterion: str = "avg"  # auc | mrr | ndcg5 | ndcg10 | avg
    early_stopping_epoch: int = 5
    word_embedding_dim: int = 300
    MSA_head_num: int = 16
    MSA_head_dim: int = 25
    attention_dim: int = 256
    dropout_rate: float = 0.2
    graph_depth: int = 3
    cnn_method: str = "naive"  # naive | group3 | group5
    cnn_kernel_num: int = 400
    cnn_window_size: int = 3
    SAG_hops: int = 2
    SAG_neighbors: int = 5
    glove_path: str = ""  # GloVe .txt (word + floats a line); '' = pseudo-GloVe
    # hash | sentence_transformer | jax_mpnet (the port's MPNet, plm.mpnet, on
    # `device`; sag_embedder_model is then a local checkpoint directory)
    sag_embedder: str = "hash"
    sag_embedder_model: str = "sentence-transformers/all-mpnet-base-v2"
    # model family: 'digat' (the main experiment) or 'nrms' (the SA strategy
    # on a sequence model)
    model_family: str = "digat"
    nrms_model: str = "NRMS-SA"  # NRMS-SA | NRMS
    nrms_head_num: int = 20
    nrms_head_dim: int = 20
    nrms_attention_dim: int = 200
    augmented_news_num: int = 10
    vocabulary_size: int = 0
    category_num: int = 0
    user_num: int = 0
    eval_batch_size: int = 0  # 0 = batch_size * 16
    run_root: str = "runs"
    run_index: int = 0
    # unique-title dedup capacity of training batches: -1 auto-size, 0 off,
    # > 0 fixed
    dedup_titles: int = -1
    resume: str = ""  # checkpoint to resume training from
    device: str = "cuda"  # cuda | cpu: where the CLI runs the model and the SAG
    # float32 | bfloat16: the dtype of the weights' compute copies (masters,
    # optimizer and checkpoints stay float32)
    compute_dtype: str = "float32"
    # the word table's gradient: kernel D's sorted segment sum (true) or the
    # library's scatter-add of F.embedding (false)
    sorted_emb_grad: bool = True
    # the rank grid (parallel.dist): mesh_data x mesh_model is the world size
    # (mesh_data 0: world / mesh_model); mesh_model > 1 row-shards the word table
    mesh_data: int = 0
    mesh_model: int = 1
    coordinator_address: str = ""  # host:port rendezvous ('' = the launcher's)
    num_processes: int = 0  # nodes (0 = the launcher's)
    process_id: int = -1  # node rank (-1 = the launcher's)
    profile_dir: str = ""  # torch.profiler trace of epoch 1's steps 10-20

    def __post_init__(self) -> None:
        # per-dataset protocol overrides, as the JAX package forces them
        if self.dataset == "MIND-small":
            self.dropout_rate = 0.2
            self.epoch = 16
        elif self.dataset == "MIND-large":
            self.dropout_rate = 0.1
            self.epoch = 7
        if self.epoch_override > 0:
            self.epoch = self.epoch_override

    @property
    def news_graph_size(self) -> int:
        return news_graph_size(self.SAG_neighbors, self.SAG_hops)

    @property
    def user_graph_size(self) -> int:
        return self.max_history_num + self.category_num

    @property
    def news_embedding_dim(self) -> int:
        if self.news_encoder == "CNN":
            return self.cnn_kernel_num
        return self.MSA_head_num * self.MSA_head_dim

    @property
    def model_name(self) -> str:
        return f"{self.news_encoder}-{self.graph_encoder}"

    @property
    def lr_decay_epoch(self) -> int:
        """The epoch from which the learning rate is divided by 10."""
        return self.epoch - ((self.epoch - 1) // 10 + 1) + 1

    def effective_eval_batch_size(self) -> int:
        return self.eval_batch_size or self.batch_size * 16

    def check_options(self) -> "Config":
        """The options alone, before a corpus fills the sizes: every news and
        graph encoder of the JAX package (the NRMS family reads neither
        field), with its checks of the CNN bank's method and width."""
        if self.mode not in ("train", "dev", "test"):
            raise ValueError(f"unknown mode {self.mode}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {self.device}")
        if self.model_family not in ("digat", "nrms"):
            raise ValueError(f"unknown model_family {self.model_family}")
        if self.nrms_model not in ("NRMS-SA", "NRMS"):
            raise ValueError(f"unknown nrms_model {self.nrms_model}")
        if self.news_encoder not in NEWS_ENCODERS:
            raise ValueError(f"unknown news_encoder {self.news_encoder}")
        if self.graph_encoder not in GRAPH_ENCODERS:
            raise ValueError(f"unknown graph_encoder {self.graph_encoder}")
        if self.cnn_method not in CNN_METHODS:
            raise ValueError(f"unknown cnn_method {self.cnn_method}")
        for method, k in (("group3", 3), ("group5", 5)):
            if self.cnn_method == method and self.cnn_kernel_num % k:
                raise ValueError(f"cnn_method={method} needs cnn_kernel_num divisible by {k}, "
                                 f"got {self.cnn_kernel_num}")
        if self.dev_criterion not in ("auc", "mrr", "ndcg5", "ndcg10", "avg"):
            raise ValueError(f"unknown dev_criterion {self.dev_criterion}")
        self.check_compute_dtype()
        return self

    def check_compute_dtype(self) -> None:
        """bfloat16 runs every model the JAX package runs at bfloat16: the
        DIGAT family with either news encoder and every graph encoder, and
        the NRMS family. A head too wide for the attention pair raises on
        the card at bfloat16 as at float32."""
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype}")

    def validate(self) -> "Config":
        """`check_options` and the sizes the corpus sets."""
        self.check_options()
        if self.model_family == "digat" and self.category_num <= 0:
            raise ValueError("category_num must be set from the corpus")
        if self.vocabulary_size <= 0:
            raise ValueError("vocabulary_size must be set from the corpus")
        if self.mesh_model > 1 and self.vocabulary_size % self.mesh_model:
            raise ValueError(f"--mesh_model {self.mesh_model} does not split the vocabulary of "
                             f"{self.vocabulary_size} words into equal row blocks")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_args(cls, argv: Optional[list] = None) -> "Config":
        """A configuration from `--name value` flags under the JAX package's
        names (every field, and the TPU-only flags of `JAX_ONLY_FLAGS`)."""
        parser = argparse.ArgumentParser(description="digat_tpu_torch experiments")
        defaults = {f.name: f.default for f in dataclasses.fields(cls)}
        defaults.update(JAX_ONLY_FLAGS)
        for name, default in defaults.items():
            kind = _parse_bool if isinstance(default, bool) else type(default)
            parser.add_argument(f"--{name}", type=kind, default=default)
        ns = vars(parser.parse_args(argv))
        for name in JAX_ONLY_FLAGS:
            del ns[name]
        return cls(**ns).check_options()
