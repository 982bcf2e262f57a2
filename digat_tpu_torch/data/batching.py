"""Training and eval batches: numpy index blocks, moved to the device.

Counterpart of `digat_tpu.data.batching` (the port's own copy of its
logic):

  * `train_batches` shuffles the samples per epoch with a seeded generator
    and yields TrainBatch index blocks, or DedupTrainBatch ones where
    unique-title dedup is on and the batch fits its capacity; the tail
    batch is padded to the full size with weight-0 rows. Under data
    parallelism every node computes the same permutation and takes the
    strided slice `shard_index::shard_count` (the JAX package's hosts, the
    port's nodes), and every node yields as many batches (a node a sample
    short ends with an all-weight-0 batch where it needs one, so no rank
    waits in a step the others never take);
  * `dedup_batch`, `dedup_shards` and `estimate_dedup_capacity` as in the
    JAX package; `rank_rows` gives one rank its contiguous row group of a
    node's batch, deduplicated per shard where that fits;
  * `Prefetcher` assembles batches on a background thread into pinned host
    memory and moves each to the device with non_blocking copies;
  * `eval_batches` yields stage-2 batches, the last one padded with item 0,
    over every item or a strided shard of them.

The index blocks are numpy (int32 as in the JAX package); `to_device`
turns a batch into int64 index tensors and a float32 weight."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from digat_tpu_torch.models.model import (DedupTrainBatch, EvalBatch, ShardedDedupBatch,
                                          TrainBatch)


def dedup_batch(batch: TrainBatch, news_node_id, capacity: int) -> DedupTrainBatch:
    """A (numpy) TrainBatch in its unique-title form; raises if the batch
    holds more unique news than `capacity`."""
    node_ids = np.asarray(news_node_id)[np.asarray(batch.sample_idx)]
    hist = np.asarray(batch.history_idx)
    flat = np.concatenate([node_ids.ravel(), hist.ravel()])
    uniq, inv = np.unique(flat, return_inverse=True)
    if len(uniq) > capacity:
        raise ValueError(f"{len(uniq)} unique news exceed the dedup capacity {capacity}")
    uniq_ids = np.zeros(capacity, np.int32)
    uniq_ids[: len(uniq)] = uniq
    split = node_ids.size
    return DedupTrainBatch(
        uniq_ids=uniq_ids,
        cand_inv=inv[:split].reshape(node_ids.shape).astype(np.int32),
        hist_inv=inv[split:].reshape(hist.shape).astype(np.int32),
        cat_idx=np.asarray(batch.cat_idx),
        sample_idx=np.asarray(batch.sample_idx),
        weight=np.asarray(batch.weight),
    )


def dedup_shards(batch: TrainBatch, news_node_id, capacity: int,
                 n_shards: int) -> Optional[ShardedDedupBatch]:
    """Per-shard dedup: the batch rows in `n_shards` contiguous groups
    (shard s holds rows [s B/S, (s+1) B/S)), each deduplicated on its own
    and stacked. None when the rows do not split evenly or any shard holds
    more unique news than `capacity` (then every shard runs the plain
    batch)."""
    B = np.asarray(batch.weight).shape[0]
    if B % n_shards:
        return None
    rows = B // n_shards
    parts = []
    for s in range(n_shards):
        sub = TrainBatch(*(np.asarray(x)[s * rows:(s + 1) * rows] for x in batch))
        node_ids = np.asarray(news_node_id)[sub.sample_idx]
        flat = np.concatenate([node_ids.ravel(), sub.history_idx.ravel()])
        if len(np.unique(flat)) > capacity:
            return None
        parts.append(dedup_batch(sub, news_node_id, capacity))
    return ShardedDedupBatch(*(np.stack(xs) for xs in zip(*parts)))


def rank_rows(batch: TrainBatch, index: int, n_shards: int, news_node_id=None,
              capacity: int = 0):
    """Rank `index` of `n_shards`: its contiguous row group of a (numpy)
    TrainBatch, as a DedupTrainBatch where `capacity` > 0 and every shard
    fits it (`dedup_shards`), else as a TrainBatch. Raises if the rows do
    not split evenly."""
    B = np.asarray(batch.weight).shape[0]
    if B % n_shards:
        raise ValueError(f"a batch of {B} rows does not split over {n_shards} ranks")
    if capacity > 0 and news_node_id is not None:
        sharded = dedup_shards(batch, news_node_id, capacity, n_shards)
        if sharded is not None:
            return sharded.local(index)
    rows = B // n_shards
    return TrainBatch(*(np.asarray(x)[index * rows:(index + 1) * rows] for x in batch))


def estimate_dedup_capacity(
    history_idx: np.ndarray,
    behavior_row: np.ndarray,
    pos: np.ndarray,
    negatives: np.ndarray,
    news_node_id: np.ndarray,
    batch_size: int,
    sample_batches: int = 32,
    headroom: float = 1.15,
    seed: int = 0,
) -> int:
    """A static unique-title capacity: the largest unique count over
    sampled batches, with headroom, rounded up to 256 (and at most the
    batch's slot count). Batches that still overflow run undeduplicated."""
    rng = np.random.default_rng(seed)
    num = len(pos)
    worst = 0
    for _ in range(sample_batches):
        sel = rng.choice(num, size=min(batch_size, num), replace=False)
        samples = np.concatenate([pos[sel, None], negatives[sel]], axis=1)
        flat = np.concatenate([
            news_node_id[samples].ravel(),
            history_idx[behavior_row[sel]].ravel(),
        ])
        worst = max(worst, len(np.unique(flat)))
    cap = int(np.ceil(worst * headroom / 256.0) * 256)
    worst_case = batch_size * (samples.shape[1] * news_node_id.shape[1]
                               + history_idx.shape[1])
    return min(cap, worst_case)


def train_batches(
    history_idx: np.ndarray,  # [rows, H] per behavior row
    cat_idx: np.ndarray,  # [rows, H]
    behavior_row: np.ndarray,  # [num_samples] -> row
    pos: np.ndarray,  # [num_samples]
    negatives: np.ndarray,  # [num_samples, K] (this epoch's draw)
    batch_size: int,
    *,
    epoch_seed: int,
    shard_index: int = 0,
    shard_count: int = 1,
    drop_remainder: bool = False,
    news_node_id: Optional[np.ndarray] = None,
    dedup_titles: int = 0,
) -> Iterator:
    """Yields numpy TrainBatch blocks, or DedupTrainBatch ones with the
    unique titles padded to `dedup_titles` when that is > 0 (and
    `news_node_id` is given; `rank_rows` over one shard); a batch over that
    capacity stays a TrainBatch. The samples are this shard's strided slice
    of the epoch's permutation. Every shard yields as many batches, since
    each batch is a step of every rank: the shards that hold a sample fewer
    end, where that leaves them a batch short, with one all-weight-0
    batch (with `drop_remainder`, every shard stops where the shortest
    does). Up to that batch, the blocks are the JAX package's."""
    num = len(pos)
    order = np.random.default_rng(epoch_seed).permutation(num)[shard_index::shard_count]
    if drop_remainder:
        n_batches = num // shard_count // batch_size
        order = order[: n_batches * batch_size]
    else:
        longest = -(-num // shard_count)
        n_batches = -(-longest // batch_size)
    for s in range(0, n_batches * batch_size, batch_size):
        sel = order[s : s + batch_size]
        b = len(sel)
        samples = np.concatenate([pos[sel, None], negatives[sel]], axis=1)
        weight = np.ones(batch_size, np.float32)
        if b < batch_size:
            pad = batch_size - b
            sel = np.concatenate([sel, np.zeros(pad, np.int64)])
            samples = np.concatenate(
                [samples, np.zeros((pad, samples.shape[1]), samples.dtype)]
            )
            weight[b:] = 0.0
        rows = behavior_row[sel]
        batch = TrainBatch(
            history_idx=history_idx[rows],
            cat_idx=cat_idx[rows].astype(np.int32),
            sample_idx=samples.astype(np.int32),
            weight=weight,
        )
        yield rank_rows(batch, 0, 1, news_node_id, dedup_titles)


def eval_batches(
    history_idx: np.ndarray,
    cat_idx: np.ndarray,
    imp_index: np.ndarray,  # [items] -> behavior row
    cand: np.ndarray,  # [items]
    batch_size: int,
    device,
    *,
    shard_index: int = 0,
    shard_count: int = 1,
) -> Iterator[tuple]:
    """Yields (EvalBatch on `device`, valid_count). Items keep file order;
    a shard takes the strided slice `shard_index::shard_count` of them."""
    items = np.arange(len(cand))[shard_index::shard_count]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)
    for s in range(0, len(items), batch_size):
        sel = items[s : s + batch_size]
        b = len(sel)
        if b < batch_size:
            sel = np.concatenate([sel, np.zeros(batch_size - b, np.int64)])
        rows = imp_index[sel]
        yield (
            EvalBatch(history_idx=put(history_idx[rows]), cat_idx=put(cat_idx[rows]),
                      cand_idx=put(cand[sel])),
            b,
        )


def _host_tensors(batch, pin: bool):
    """numpy batch -> the same batch type of host tensors: int64 indices, a
    float32 weight; in pinned memory when `pin`."""
    def put(name, a):
        t = torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32 if name == "weight" else np.int64))
        return t.pin_memory() if pin else t

    return type(batch)(**{k: put(k, v) for k, v in batch._asdict().items()})


def to_device(batch, device):
    """A numpy (or host tensor) batch -> the same batch type on `device`."""
    device = torch.device(device)
    if not isinstance(batch.weight, torch.Tensor):
        batch = _host_tensors(batch, pin=False)
    return type(batch)(*(t.to(device, non_blocking=True) for t in batch))


class Prefetcher:
    """Runs a batch iterator on a background thread, keeping `depth`
    batches ready as host tensors (pinned for a CUDA device), and moves
    each to the device with non_blocking copies when it is taken. Call
    `close` (or exhaust it) to end the thread."""

    _DONE = object()

    def __init__(self, it: Iterator, device, depth: int = 3):
        self._device = torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        pin = self._device.type == "cuda"

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(_host_tensors(item, pin))
            except BaseException as e:  # raised again by __next__
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return to_device(item, self._device)

    def close(self) -> None:
        """Stop the thread, draining what it still puts."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()
