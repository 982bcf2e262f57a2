"""Experiment configuration for the port's serving slice.

A copy of the fields of `digat_tpu.config.Config` that the two-stage
MSA-DIGAT scorer reads, with the same names, defaults and per-dataset
protocol overrides. Kept as its own copy so the port never imports the JAX
package."""

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
    max_history_num: int = 50
    epoch: int = 16
    epoch_override: int = 0
    batch_size: int = 64
    word_embedding_dim: int = 300
    MSA_head_num: int = 16
    MSA_head_dim: int = 25
    attention_dim: int = 256
    dropout_rate: float = 0.2
    graph_depth: int = 3
    SAG_hops: int = 2
    SAG_neighbors: int = 5
    vocabulary_size: int = 0
    category_num: int = 0
    eval_batch_size: int = 0  # 0 = batch_size * 16

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

    def effective_eval_batch_size(self) -> int:
        return self.eval_batch_size or self.batch_size * 16

    def validate(self) -> "Config":
        """This slice ports the MSA news encoder and the DIGAT graph encoder
        only; other choices raise."""
        if self.news_encoder != "MSA":
            raise NotImplementedError(f"news_encoder={self.news_encoder} is not ported yet")
        if self.graph_encoder != "DIGAT":
            raise NotImplementedError(f"graph_encoder={self.graph_encoder} is not ported yet")
        if self.vocabulary_size <= 0 or self.category_num <= 0:
            raise ValueError("vocabulary_size and category_num must be set from the corpus")
        return self
