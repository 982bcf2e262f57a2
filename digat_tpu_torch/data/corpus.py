"""MIND corpus preprocessing and runtime store: the port's own copy of
`digat_tpu/data/corpus.py`.

`preprocess` turns the MIND TSV files into cached npz / npy / json
artifacts under <data_root>/<dataset>-cache, under the JAX package's file
names and keys, so that either package reads the other's cache. `Corpus`
loads them and gives the numpy tables that `CorpusTables.from_arrays` and
`NRMSTables.from_arrays` move to the model's device. Behaviors are stored
as index arrays (histories and per-slot categories; the user graph is
rebuilt on the device), train negatives as a ragged (flat, offsets)
pair. Behaviors are parsed by the port's C++ parser (`digat_tpu_torch/native`,
as the JAX package's default path does). The SAG's similarity products run on
`cfg.device` (CUDA unless the configuration names the CPU)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from digat_tpu_torch.config import Config
from digat_tpu_torch.data import sag as sag_mod
from digat_tpu_torch.data import tokenize as tok
from digat_tpu_torch.native import bindings as native

SPLITS = ("train", "dev", "test")


def _paths(cfg: Config) -> Dict[str, str]:
    """The artifacts' paths, keyed by every configuration field that shapes
    them (the JAX package's names)."""
    cache = os.path.join(cfg.data_root, f"{cfg.dataset}-cache")
    key_vocab = f"{cfg.word_threshold}-{cfg.max_title_length}"
    key_emb = f"{cfg.word_threshold}-{cfg.word_embedding_dim}-{cfg.max_title_length}"
    if cfg.glove_path:
        key_emb += "-glove"
    key_graph = f"{cfg.SAG_hops}-{cfg.SAG_neighbors}"
    key_embed = "" if cfg.sag_embedder == "hash" else f"-{cfg.sag_embedder}"
    return {
        "cache": cache,
        "dicts": os.path.join(cache, "dicts.json"),
        "vocab": os.path.join(cache, f"vocabulary-{key_vocab}.json"),
        "embedding": os.path.join(cache, f"word_embedding-{key_emb}.npy"),
        "news": os.path.join(cache, f"news-{key_vocab}.npz"),
        "graph": os.path.join(cache, f"news_graph-{key_graph}{key_embed}.npz"),
        "behaviors": os.path.join(cache, f"behaviors-{cfg.max_history_num}.npz"),
        "augmented": os.path.join(cache, f"augmented_news-{cfg.augmented_news_num}{key_embed}.npz"),
    }


def _read_news_tsv(path: str):
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            parts = line.split("\t")
            news_id, category, sub_category, title, abstract = parts[:5]
            yield news_id, category, sub_category, title, abstract


def _read_behaviors_tsv(path: str):
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            imp_id, user_id, time, history, impressions = line.split("\t")
            yield imp_id, user_id, history.strip(), impressions.strip()


def _rows_by_category(roots: Dict[str, str], cat_dict: Dict[str, int]):
    """Per category, (domain, news_ID, title, abstract) of each news once, in
    file order; domain 'test' for news first seen in the test split."""
    rows: Dict[str, List[Tuple[str, str, str, str]]] = {c: [] for c in cat_dict}
    seen = set()
    for i, split in enumerate(SPLITS):
        domain = "train_dev" if i < 2 else "test"
        for news_id, cat, _, title, abstract in _read_news_tsv(
                os.path.join(roots[split], "news.tsv")):
            if news_id not in seen:
                seen.add(news_id)
                rows[cat].append((domain, news_id, title, abstract))
    return rows


def preprocess(cfg: Config, verbose: bool = False) -> None:
    """Build every cached artifact that is missing; each is checked on its
    own, so a run that stopped half way resumes. The word table reads
    `cfg.glove_path`; the SAG's similarity products run on `cfg.device`."""
    device = cfg.device
    p = _paths(cfg)
    os.makedirs(p["cache"], exist_ok=True)
    roots = {s: os.path.join(cfg.data_root, cfg.dataset, s) for s in SPLITS}

    # 1. dictionaries (user / news / category / subCategory)
    if not os.path.exists(p["dicts"]):
        user_dict: Dict[str, int] = {"<UNK>": 0}
        news_dict: Dict[str, int] = {"<PAD>": 0}
        cat_dict: Dict[str, int] = {}
        subcat_dict: Dict[str, int] = {}
        for _, user_id, _, _ in _read_behaviors_tsv(os.path.join(roots["train"],
                                                                 "behaviors.tsv")):
            if user_id not in user_dict:
                user_dict[user_id] = len(user_dict)
        for split in SPLITS:
            for news_id, cat, subcat, _, _ in _read_news_tsv(os.path.join(roots[split],
                                                                          "news.tsv")):
                if news_id not in news_dict:
                    news_dict[news_id] = len(news_dict)
                    if cat not in cat_dict:
                        cat_dict[cat] = len(cat_dict)
                    if subcat not in subcat_dict:
                        subcat_dict[subcat] = len(subcat_dict)
        with open(p["dicts"], "w", encoding="utf-8") as f:
            json.dump({"user": user_dict, "news": news_dict, "category": cat_dict,
                       "subCategory": subcat_dict}, f)
    with open(p["dicts"], "r", encoding="utf-8") as f:
        dicts = json.load(f)
    news_dict, cat_dict = dicts["news"], dicts["category"]

    # 2. vocabulary
    if not os.path.exists(p["vocab"]):
        def streams():
            seen = set()
            for i, split in enumerate(SPLITS):
                titles = []
                for news_id, _, _, title, _ in _read_news_tsv(os.path.join(roots[split],
                                                                           "news.tsv")):
                    if news_id not in seen:
                        seen.add(news_id)
                        titles.append(title)
                yield i, titles

        vocab = tok.build_vocabulary(streams(), cfg.word_threshold)
        with open(p["vocab"], "w", encoding="utf-8") as f:
            json.dump(vocab, f)
    with open(p["vocab"], "r", encoding="utf-8") as f:
        vocab = json.load(f)

    # 3. word embedding
    if not os.path.exists(p["embedding"]):
        emb = tok.build_word_embedding(vocab, cfg.word_embedding_dim, cfg.glove_path or None,
                                       seed=cfg.seed)
        np.save(p["embedding"], emb)

    # 4. tokenized titles and each news's category
    if not os.path.exists(p["news"]):
        n = len(news_dict)
        title_text = np.zeros((n, cfg.max_title_length), np.int32)
        title_mask = np.zeros((n, cfg.max_title_length), bool)
        news_category = np.zeros((n,), np.int16)
        seen = set()
        for split in SPLITS:
            for news_id, cat, _, title, _ in _read_news_tsv(os.path.join(roots[split],
                                                                         "news.tsv")):
                if news_id in seen:
                    continue
                seen.add(news_id)
                idx = news_dict[news_id]
                title_text[idx], title_mask[idx] = tok.encode_title(title, vocab,
                                                                    cfg.max_title_length)
                news_category[idx] = cat_dict[cat]
        np.savez_compressed(p["news"], title_text=title_text, title_mask=title_mask,
                            news_category=news_category)

    embedder = None
    # 5. SAG news graph
    if not os.path.exists(p["graph"]):
        embedder = sag_mod.get_embedder(cfg.sag_embedder, cfg.sag_embedder_model,
                                           device)
        node_id, graph, mask = sag_mod.construct_sag(
            _rows_by_category(roots, cat_dict), news_dict, cfg.SAG_neighbors, cfg.SAG_hops,
            cfg.news_graph_size, embedder=embedder,
            exclude_test_from_corpus=cfg.dataset != "MIND-large", seed=cfg.seed,
            device=device)
        # self-loops added once here (the reference adds them at load)
        graph |= np.eye(cfg.news_graph_size, dtype=bool)[None]
        np.savez_compressed(p["graph"], news_node_id=node_id, news_graph=graph,
                            news_graph_mask=mask)

    # 5b. SA news sequence (the NRMS family)
    if cfg.model_family == "nrms" and not os.path.exists(p["augmented"]):
        embedder = embedder or sag_mod.get_embedder(cfg.sag_embedder,
                                                    cfg.sag_embedder_model, device)
        aug = sag_mod.construct_sa_sequence(
            _rows_by_category(roots, cat_dict), news_dict, cfg.augmented_news_num,
            embedder=embedder, exclude_test_from_corpus=cfg.dataset != "MIND-large",
            seed=cfg.seed, device=device)
        np.savez_compressed(p["augmented"], augmented_news=aug)

    # 6. behaviors (index encoding)
    if not os.path.exists(p["behaviors"]):
        news_category = np.load(p["news"])["news_category"]
        out: Dict[str, np.ndarray] = {}
        for split in SPLITS:
            ragged = _parse_behaviors(os.path.join(roots[split], "behaviors.tsv"), news_dict)
            out.update(_assemble_split(cfg, split, ragged, news_category, len(cat_dict)))
        np.savez_compressed(p["behaviors"], **out)
    if verbose:
        print(f"[corpus] artifacts ready under {p['cache']}", flush=True)


def _parse_behaviors(path: str, news_dict: Dict[str, int]) -> Dict[str, np.ndarray]:
    """behaviors.tsv -> ragged (flat, offsets) arrays, by the native parser."""
    return native.parse_behaviors_native(path, news_dict)


def _parse_behaviors_py(path: str, news_dict: Dict[str, int]) -> Dict[str, np.ndarray]:
    """The plain version of `_parse_behaviors` (the same arrays on
    well-formed files)."""
    out = {
        "history_flat": [], "history_offsets": [0],
        "clicks_flat": [], "clicks_offsets": [0],
        "nonclicks_flat": [], "nonclicks_offsets": [0],
        "cand_flat": [], "label_flat": [], "cand_offsets": [0],
    }
    for _, _, history, impressions in _read_behaviors_tsv(path):
        if history:
            out["history_flat"].extend(news_dict[x] for x in history.split(" "))
        out["history_offsets"].append(len(out["history_flat"]))
        for imp in impressions.split(" "):
            if imp.endswith("-1"):
                idx, label = news_dict[imp[:-2]], 1
                out["clicks_flat"].append(idx)
            elif imp.endswith("-0"):
                idx, label = news_dict[imp[:-2]], 0
                out["nonclicks_flat"].append(idx)
            else:  # unlabeled (MIND-large test)
                idx, label = news_dict[imp], -1
            out["cand_flat"].append(idx)
            out["label_flat"].append(label)
        out["cand_offsets"].append(len(out["cand_flat"]))
        out["clicks_offsets"].append(len(out["clicks_flat"]))
        out["nonclicks_offsets"].append(len(out["nonclicks_flat"]))
    dtypes = {"label_flat": np.int8}
    return {k: np.asarray(v, dtypes.get(k, np.int64 if "offsets" in k else np.int32))
            for k, v in out.items()}


def _assemble_split(cfg: Config, split: str, ragged: Dict[str, np.ndarray],
                    news_category: np.ndarray, category_num: int) -> Dict[str, np.ndarray]:
    """The per-split arrays from the ragged ones: tail-truncated padded
    histories with per-slot categories, and either per-positive train
    samples or per-item eval rows."""
    H, C = cfg.max_history_num, category_num
    h_off = ragged["history_offsets"]
    rows = len(h_off) - 1
    lengths = np.diff(h_off)
    take = np.minimum(lengths, H)
    starts = h_off[1:] - take  # tail truncation
    slot = np.arange(H)[None, :]
    valid = slot < take[:, None]
    gather = np.minimum(starts[:, None] + slot, len(ragged["history_flat"]) - 1)
    history_idx = np.where(
        valid, ragged["history_flat"][gather] if len(ragged["history_flat"]) else 0, 0
    ).astype(np.int32)
    cat_idx = np.where(valid, news_category[history_idx], C).astype(np.int16)
    out = {f"{split}_history_idx": history_idx, f"{split}_cat_idx": cat_idx}
    if split == "train":
        clicks_per_row = np.diff(ragged["clicks_offsets"])
        nonclicks_per_row = np.diff(ragged["nonclicks_offsets"])
        out["train_pos"] = ragged["clicks_flat"].astype(np.int32)
        out["train_behavior_row"] = np.repeat(np.arange(rows, dtype=np.int32), clicks_per_row)
        # each sample's negative pool is its row's non-clicks
        n_samples = len(out["train_pos"])
        sample_rows = out["train_behavior_row"]
        sizes = nonclicks_per_row[sample_rows]
        neg_off = np.zeros(n_samples + 1, np.int64)
        np.cumsum(sizes, out=neg_off[1:])
        row_start = ragged["nonclicks_offsets"][:-1]
        flat_idx = np.repeat(row_start[sample_rows], sizes) + _ragged_arange(sizes)
        out["train_neg_flat"] = ragged["nonclicks_flat"][flat_idx].astype(np.int32)
        out["train_neg_offsets"] = neg_off
    else:
        items_per_row = np.diff(ragged["cand_offsets"])
        out[f"{split}_cand"] = ragged["cand_flat"].astype(np.int32)
        out[f"{split}_imp_index"] = np.repeat(np.arange(rows, dtype=np.int32), items_per_row)
        # an unlabeled split (MIND-large test) is flagged before the clamp
        out[f"{split}_unlabeled"] = np.any(ragged["label_flat"] < 0)
        out[f"{split}_labels"] = np.maximum(ragged["label_flat"], 0).astype(np.int8)
    return out


def _ragged_arange(sizes: np.ndarray) -> np.ndarray:
    """[0..s0-1, 0..s1-1, ...] for a vector of segment sizes."""
    total = int(sizes.sum())
    ids = np.arange(total)
    seg_starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
    return ids - seg_starts


@dataclass
class Split:
    history_idx: np.ndarray  # [rows, H]
    cat_idx: np.ndarray  # [rows, H]


class Tables(NamedTuple):
    """The corpus's MSA-DIGAT tables as numpy arrays (`CorpusTables` fields)."""

    news_title_text: np.ndarray
    news_title_mask: np.ndarray
    news_node_id: np.ndarray
    news_graph: np.ndarray
    news_graph_mask: np.ndarray


class NRMSArrays(NamedTuple):
    """The corpus's NRMS tables as numpy arrays (`NRMSTables` fields)."""

    news_title_text: np.ndarray
    news_title_mask: np.ndarray
    augmented_news: np.ndarray


class Corpus:
    """Runtime store: loads the cached artifacts and fills the corpus-sized
    fields of `cfg` (vocabulary_size, category_num, user_num)."""

    def __init__(self, cfg: Config):
        p = _paths(cfg)
        with open(p["dicts"], "r", encoding="utf-8") as f:
            dicts = json.load(f)
        with open(p["vocab"], "r", encoding="utf-8") as f:
            self.vocab = json.load(f)
        cfg.vocabulary_size = len(self.vocab)
        cfg.category_num = len(dicts["category"])
        cfg.user_num = len(dicts["user"])
        self.news_dict = dicts["news"]
        self.news_num = len(self.news_dict)

        news = np.load(p["news"])
        self.news_title_text = news["title_text"]
        self.news_title_mask = news["title_mask"]
        self.news_category = news["news_category"]
        self.word_embedding = np.load(p["embedding"])

        graph = np.load(p["graph"])
        self.news_node_id = graph["news_node_id"]
        self.news_graph = graph["news_graph"]
        self.news_graph_mask = graph["news_graph_mask"].copy()
        # the candidate's own slot never joins the global attention
        self.news_graph_mask[:, 0] = 0

        self.augmented_news = None
        if os.path.exists(p["augmented"]):
            self.augmented_news = np.load(p["augmented"])["augmented_news"]

        b = np.load(p["behaviors"])
        self.splits = {s: Split(b[f"{s}_history_idx"], b[f"{s}_cat_idx"]) for s in SPLITS}
        self.train_pos = b["train_pos"]
        self.train_neg_flat = b["train_neg_flat"]
        self.train_neg_offsets = b["train_neg_offsets"]
        self.train_behavior_row = b["train_behavior_row"]
        for s in ("dev", "test"):
            setattr(self, f"{s}_cand", b[f"{s}_cand"])
            setattr(self, f"{s}_imp_index", b[f"{s}_imp_index"])
            setattr(self, f"{s}_labels", b[f"{s}_labels"])
            # caches written before the flag existed: all-zero labels
            setattr(self, f"{s}_unlabeled",
                    bool(b[f"{s}_unlabeled"]) if f"{s}_unlabeled" in b
                    else b[f"{s}_labels"].sum() == 0)

    def tables(self) -> Tables:
        return Tables(self.news_title_text, self.news_title_mask, self.news_node_id,
                      self.news_graph, self.news_graph_mask)

    def nrms_tables(self) -> NRMSArrays:
        if self.augmented_news is None:
            raise ValueError("augmented-news artifact missing; preprocess with "
                             "model_family='nrms'")
        return NRMSArrays(self.news_title_text, self.news_title_mask, self.augmented_news)
