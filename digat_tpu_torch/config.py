"""Experiment configuration for the port.

A copy of the fields of `digat_tpu.config.Config` that the port reads
(the DIGAT family with either news encoder and every graph encoder, the
NRMS family, training, the cached scorers, the data pipeline and the CLI),
with the same names, defaults and per-dataset protocol overrides, plus
`device` (cuda | cpu). Kept as its own copy so the
port never imports the JAX package.

`compute_dtype` bfloat16 runs MSA-DIGAT and its five ablations with bf16
compute copies of the fp32 weights (`models.model.Model.compute_params`);
the other models at bf16 raise naming their ROADMAP item.

`from_args` also takes the JAX package's TPU-only flags, so that a JAX
command line parses. Each is checked and dropped: a value the port runs
(one device, no profile directory, the sorted embedding gradient, any PRNG
or Pallas setting, which read nothing on the card) passes, any other
raises naming the ROADMAP item that would bring it."""

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


# The JAX package's TPU-only flags: name -> (default, is the value one the
# port runs, the ROADMAP item that would bring the others)
_ROADMAP_MULTI = "ROADMAP.md section 1, item 3 (multi-GPU)"
JAX_ONLY_FLAGS = {
    "use_pallas": (True, lambda v: True, ""),
    "rng_impl": ("rbg", lambda v: True, ""),
    "compilation_cache_dir": ("", lambda v: True, ""),
    "mesh_data": (0, lambda v: v <= 1, _ROADMAP_MULTI),
    "mesh_model": (1, lambda v: v <= 1, _ROADMAP_MULTI),
    "coordinator_address": ("", lambda v: v == "", _ROADMAP_MULTI),
    "num_processes": (0, lambda v: v <= 1, _ROADMAP_MULTI),
    "process_id": (-1, lambda v: v <= 0, _ROADMAP_MULTI),
    "profile_dir": ("", lambda v: v == "",
                    "ROADMAP.md section 1, item 3 (sweep, aggregate and StepTimer)"),
    "sorted_emb_grad": (True, lambda v: v,
                        "ROADMAP.md section 2 (the port always runs kernel D, the sorted "
                        "embedding gradient)"),
}

NEWS_ENCODERS = ("MSA", "CNN")
GRAPH_ENCODERS = ("DIGAT", "wo_SA", "Seq_SA", "wo_interaction", "news_graph_wo_inter",
                  "user_graph_wo_inter")
CNN_METHODS = ("naive", "group3", "group5")
COMPUTE_DTYPES = ("float32", "bfloat16")
# the models that do not run at bfloat16 yet: the ROADMAP item of each
_ROADMAP_BF16_NRMS = "ROADMAP.md section 1, item 3 (NRMS and NRMS-SA at bfloat16)"
_ROADMAP_BF16_CNN = "ROADMAP.md section 1, item 3 (CNN at bfloat16)"
_ROADMAP_BF16_PAIR = ("ROADMAP.md section 1, item 3 (NRMS and NRMS-SA at bfloat16: the "
                      "attention pair, which also takes MSA titles past 128 positions)")


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
    sag_embedder: str = "hash"  # hash (sentence_transformer, jax_mpnet: not ported)
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
        """bfloat16 runs the DIGAT family with the MSA encoder where its titles
        take kernel A (every graph encoder); the NRMS family, the CNN encoder
        and MSA titles routed through the attention pair raise."""
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype}")
        if self.compute_dtype == "float32":
            return
        from digat_tpu_torch.ops.msa_attention_grouped import group_size

        what = f"--compute_dtype {self.compute_dtype}"
        if self.model_family == "nrms":
            raise NotImplementedError(f"{what} for {self.nrms_model} is not ported: "
                                      f"{_ROADMAP_BF16_NRMS}")
        if self.news_encoder == "CNN":
            raise NotImplementedError(f"{what} for the CNN news encoder is not ported: "
                                      f"{_ROADMAP_BF16_CNN}")
        if group_size(self.MSA_head_num, self.max_title_length, self.MSA_head_dim) <= 0:
            raise NotImplementedError(
                f"{what} at titles of {self.max_title_length} positions and heads of "
                f"{self.MSA_head_dim} is not ported: {_ROADMAP_BF16_PAIR}")

    def validate(self) -> "Config":
        """`check_options` and the sizes the corpus sets."""
        self.check_options()
        if self.model_family == "digat" and self.category_num <= 0:
            raise ValueError("category_num must be set from the corpus")
        if self.vocabulary_size <= 0:
            raise ValueError("vocabulary_size must be set from the corpus")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_args(cls, argv: Optional[list] = None) -> "Config":
        """A configuration from `--name value` flags under the JAX package's
        names (every field, and the TPU-only flags of `JAX_ONLY_FLAGS`)."""
        parser = argparse.ArgumentParser(description="digat_tpu_torch experiments")
        defaults = {f.name: f.default for f in dataclasses.fields(cls)}
        defaults.update({k: v[0] for k, v in JAX_ONLY_FLAGS.items()})
        for name, default in defaults.items():
            kind = _parse_bool if isinstance(default, bool) else type(default)
            parser.add_argument(f"--{name}", type=kind, default=default)
        ns = vars(parser.parse_args(argv))
        for name, (_, runs, item) in JAX_ONLY_FLAGS.items():
            value = ns.pop(name)
            if not runs(value):
                raise NotImplementedError(f"--{name} {value} is not ported: {item}")
        return cls(**ns).check_options()
