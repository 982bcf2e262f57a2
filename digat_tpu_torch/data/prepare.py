"""MIND split preparation from files already on disk: the port's own copy
of the local steps of `digat_tpu/data/prepare.py`.

  * MIND-small: re-split the official train behaviors 95/5 into local train
    and dev, and use the official dev split as the local test split;
  * MIND-large: copy train, dev and test as they are.

The port fetches nothing. The official archives must already be extracted
under <data_root>/<dataset>/download/{train,dev[,test]}/ (each holding
news.tsv and behaviors.tsv), or the train/ dev/ test/ directories must
already be in place; an existing layout is left alone."""

from __future__ import annotations

import os
import random
import shutil
from typing import List, Tuple

TRAIN_RATIO = 0.95
SOURCE_SPLITS = {"MIND-small": ("train", "dev"), "MIND-large": ("train", "dev", "test")}


def split_behaviors(lines: List[str], seed: int = 0) -> Tuple[List[str], List[str]]:
    """95/5 random split of behavior lines: shuffle once, mark a uniform
    random 95% subset of positions as train, keep both splits in shuffled
    order (self-seeded and deterministic)."""
    rng = random.Random(seed)
    shuffled = list(lines)
    rng.shuffle(shuffled)
    train_ids = set(rng.sample(range(len(lines)), int(len(lines) * TRAIN_RATIO)))
    train = [l for i, l in enumerate(shuffled) if i in train_ids]
    dev = [l for i, l in enumerate(shuffled) if i not in train_ids]
    return train, dev


def _copy_if_exists(src: str, dst: str) -> None:
    if os.path.exists(src) and not os.path.exists(dst):
        shutil.copyfile(src, dst)


def _require_download(root: str, dataset: str) -> str:
    """<root>/download, with a message naming the files it needs when they
    are missing."""
    dl = os.path.join(root, "download")
    need = [os.path.join(dl, s, name) for s in SOURCE_SPLITS[dataset]
            for name in ("news.tsv", "behaviors.tsv")]
    missing = [p for p in need if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"{dataset}: no data under {root}. The port does not download MIND; "
            f"extract the official archives so that these files exist: "
            f"{', '.join(missing)} (or place train/ dev/ test/ directories holding "
            f"news.tsv and behaviors.tsv under {root})")
    return dl


def prepare_mind_small(root: str, seed: int = 0) -> None:
    """root: e.g. data/MIND-small. Produces train/ dev/ test/ subdirs."""
    dl = _require_download(root, "MIND-small")
    with open(os.path.join(dl, "train", "behaviors.tsv"), encoding="utf-8") as f:
        lines = [l for l in f if l.strip()]
    train_lines, dev_lines = split_behaviors(lines, seed)
    for split, blines, news_src in [
        ("train", train_lines, "train"),
        ("dev", dev_lines, "train"),
        ("test", None, "dev"),
    ]:
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        bpath = os.path.join(d, "behaviors.tsv")
        if not os.path.exists(bpath):
            if blines is None:  # official dev becomes local test
                shutil.copyfile(os.path.join(dl, "dev", "behaviors.tsv"), bpath)
            else:
                with open(bpath, "w", encoding="utf-8") as f:
                    f.writelines(blines)
        _copy_if_exists(os.path.join(dl, news_src, "news.tsv"), os.path.join(d, "news.tsv"))
        for extra in ("entity_embedding.vec", "relation_embedding.vec"):
            _copy_if_exists(os.path.join(dl, news_src, extra), os.path.join(d, extra))


def prepare_mind_large(root: str) -> None:
    dl = _require_download(root, "MIND-large")
    for split in ("train", "dev", "test"):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for name in ("behaviors.tsv", "news.tsv"):
            _copy_if_exists(os.path.join(dl, split, name), os.path.join(d, name))


def prepare(dataset: str, data_root: str, seed: int = 0) -> None:
    root = os.path.join(data_root, dataset)
    done = all(os.path.exists(os.path.join(root, s, "behaviors.tsv"))
               for s in ("train", "dev", "test"))
    if done:
        return
    if dataset == "MIND-small":
        prepare_mind_small(root, seed)
    elif dataset == "MIND-large":
        prepare_mind_large(root)
    else:
        raise ValueError(f"unknown dataset {dataset}")
