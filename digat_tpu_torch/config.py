"""Experiment configuration for the port.

A copy of the fields of `digat_tpu.config.Config` that MSA-DIGAT and the
NRMS family (NRMS, NRMS-SA) read for training and the cached scorers, with
the same names, defaults and per-dataset protocol overrides. Kept as its
own copy so the port never imports the JAX package."""

from __future__ import annotations

import dataclasses


def news_graph_size(sag_neighbors: int, sag_hops: int) -> int:
    """Number of nodes in a SAG news graph: hop 0 adds M neighbours, each
    deeper hop branches into M-1 new nodes."""
    size = 1
    frontier = 1
    for hop in range(sag_hops):
        frontier *= sag_neighbors if hop == 0 else (sag_neighbors - 1)
        size += frontier
    return size


@dataclasses.dataclass
class Config:
    news_encoder: str = "MSA"
    graph_encoder: str = "DIGAT"
    seed: int = 0
    dataset: str = "MIND-small"  # MIND-small | MIND-large | synthetic
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
    SAG_hops: int = 2
    SAG_neighbors: int = 5
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
    eval_batch_size: int = 0  # 0 = batch_size * 16
    # unique-title dedup capacity of training batches: -1 auto-size, 0 off,
    # > 0 fixed
    dedup_titles: int = -1
    resume: str = ""  # checkpoint to resume training from

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

    def validate(self) -> "Config":
        """The port has MSA-DIGAT and the NRMS family (which reads neither
        encoder field); the CNN encoder and the DIGAT ablations raise."""
        if self.model_family not in ("digat", "nrms"):
            raise ValueError(f"unknown model_family {self.model_family}")
        if self.nrms_model not in ("NRMS-SA", "NRMS"):
            raise ValueError(f"unknown nrms_model {self.nrms_model}")
        if self.model_family == "digat":
            if self.news_encoder != "MSA":
                raise NotImplementedError(f"news_encoder={self.news_encoder} is not ported yet")
            if self.graph_encoder != "DIGAT":
                raise NotImplementedError(f"graph_encoder={self.graph_encoder} is not ported yet")
            if self.category_num <= 0:
                raise ValueError("category_num must be set from the corpus")
        if self.dev_criterion not in ("auc", "mrr", "ndcg5", "ndcg10", "avg"):
            raise ValueError(f"unknown dev_criterion {self.dev_criterion}")
        if self.vocabulary_size <= 0:
            raise ValueError("vocabulary_size must be set from the corpus")
        return self
