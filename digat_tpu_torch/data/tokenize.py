"""Tokenization, vocabulary and word-embedding utilities: the port's own
copy of `digat_tpu/data/tokenize.py` (numpy only).

The reference's text handling: the regex tokenizer ``[\\w]+|[.,!?;|]``
over lowercased titles with the e-accent fold, ``<NUM>`` for numerals, a
frequency-threshold vocabulary built from the training split (dev and test
words count only if train has them), and a GloVe-initialized embedding
matrix whose OOV rows are drawn from N(glove_mean, glove_std) and whose pad
row is the GloVe mean. Without a GloVe file the rows are deterministic
pseudo-GloVe vectors from word hashes, so the pipeline runs on its own.

The GloVe text file is parsed by the port's multithreaded C++ parser
(`digat_tpu_torch/native`, as the JAX package's default path does);
`_load_glove_txt_py` is its plain version."""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from digat_tpu_torch.native import bindings as native

_PAT = re.compile(r"[\w]+|[.,!?;|]")

PAD, UNK, NUM = "<PAD>", "<UNK>", "<NUM>"


def tokenize(text: str) -> List[str]:
    return _PAT.findall(text.lower().replace("é", "e"))


def is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def build_vocabulary(
    title_streams: Iterable[Tuple[int, Iterable[str]]], word_threshold: int
) -> Dict[str, int]:
    """`title_streams`: iterable of (split_index, titles). Words from split 0
    (train) always count; words from later splits count only if already
    present. Ties are broken by frequency, then first-seen order."""
    counts: Dict[str, int] = {}
    order: Dict[str, int] = {}
    for split, titles in title_streams:
        for title in titles:
            for w in tokenize(title):
                if is_number(w):
                    w = NUM
                    counts[w] = counts.get(w, 0) + 1
                    order.setdefault(w, len(order))
                elif split == 0:
                    counts[w] = counts.get(w, 0) + 1
                    order.setdefault(w, len(order))
                elif w in counts:
                    counts[w] += 1
    items = [(w, c) for w, c in counts.items() if c >= word_threshold]
    items.sort(key=lambda x: (-x[1], order[x[0]]))
    vocab = {PAD: 0, UNK: 1}
    for w, _ in items:
        vocab[w] = len(vocab)
    return vocab


def encode_title(title: str, vocab: Dict[str, int], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.zeros(max_len, np.int32)
    mask = np.zeros(max_len, bool)
    for i, w in enumerate(tokenize(title)):
        if i == max_len:
            break
        if is_number(w):
            ids[i] = vocab[NUM]
        else:
            ids[i] = vocab.get(w, vocab[UNK])
        mask[i] = True
    return ids, mask


def load_glove_txt(path: str, dim: int) -> Tuple[Dict[str, int], np.ndarray]:
    """Parse a GloVe text file into (stoi, vectors) with the native parser.
    A line is taken only with exactly dim + 1 fields, as the reference's
    loader does."""
    stoi, vecs = native.parse_glove_native(path, dim)
    if vecs.shape[0] == 0:
        # would otherwise spread a NaN mean and std through the OOV draws
        raise ValueError(f"no valid GloVe rows parsed from {path}")
    return stoi, vecs


def _load_glove_txt_py(path: str, dim: int) -> Tuple[Dict[str, int], np.ndarray]:
    """The plain version of `native.parse_glove_native`."""
    stoi: Dict[str, int] = {}
    vecs: List[np.ndarray] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            stoi[parts[0]] = len(vecs)
            vecs.append(np.asarray(parts[1:], np.float32))
    if not vecs:
        return stoi, np.zeros((0, dim), np.float32)
    return stoi, np.stack(vecs)


def _hash_vector(word: str, dim: int) -> np.ndarray:
    """Deterministic pseudo-embedding from a word hash."""
    seed = int.from_bytes(word.encode("utf-8")[:8].ljust(8, b"\0"), "little")
    rng = np.random.default_rng(seed & 0x7FFFFFFF)
    return rng.standard_normal(dim).astype(np.float32) * 0.3


def build_word_embedding(
    vocab: Dict[str, int], dim: int, glove_path: Optional[str] = None, seed: int = 0
) -> np.ndarray:
    """[V, dim] matrix: GloVe rows where available, N(mean, std) for OOV
    words, the mean for the pad row."""
    out = np.zeros((len(vocab), dim), np.float32)
    if glove_path:
        stoi, vecs = load_glove_txt(glove_path, dim)
        mean = vecs.mean(0)
        std = vecs.std(0, ddof=1)
        rng = np.random.default_rng(seed)
        out[0] = mean
        for w, i in vocab.items():
            if i == 0:
                continue
            if w in stoi:
                out[i] = vecs[stoi[w]]
            else:
                out[i] = mean + std * rng.standard_normal(dim).astype(np.float32)
    else:
        for w, i in vocab.items():
            out[i] = _hash_vector(w, dim)
        out[0] = out[1:].mean(0) if len(vocab) > 1 else 0.0
    return out
