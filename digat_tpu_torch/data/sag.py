"""Semantic-augmented news graph (SAG) construction: the port's own copy of
`digat_tpu/data/sag.py`.

Per category (the reference's offline pipeline):
  1. dedup news by title, with the empty-text fallbacks (title <-> content
     swaps) and title-prefixed duplicated contents;
  2. embed titles and contents (`get_embedder`: the `hash` embedder's
     deterministic bag-of-token vectors, or a pretrained sentence encoder,
     the port's MPNet or the sentence-transformers package);
  3. average the four cosine channels (title-title, content-content,
     title-content, content-title) and take the top M + 1 against the
     corpus side (train + dev only on MIND-small), as batched matrix
     products and a sort on the entry point's device;
  4. per news, walk its group's top list, skip any group holding the news
     itself, keep each group's first id, stop at M; news with no text get M
     random neighbours at cosine 0.

`expand_graph` then grows each news's graph breadth first to `hops` with
the reference's rules: hop 0 takes all M neighbours, deeper hops stop at
cosine < 0.5 or after M - 1 neighbours, and revisited nodes gain edges
without being enqueued again. It runs in the port's C++ loader
(`digat_tpu_torch/native`), as the JAX package's default path does;
`use_native=False` runs its plain Python body.

Top-k order. `jax.lax.top_k` puts the lower index first among equal
values, and `torch.topk` promises no order among ties, so the top list here
is a stable descending sort of each row (`torch.sort(..., stable=True)`):
equal values keep index order, the lower index first. The sums are fp32 on
either device (TF32 off), so the card and the CPU can still order two
values within an ulp of each other differently."""

from __future__ import annotations

import hashlib
from collections import Counter
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from digat_tpu_torch.native import bindings as native
from digat_tpu_torch.runtime import exact_fp32, resolve_device

SIMILARITY_THRESHOLD = 0.5
TOPK_CHUNK = 2048  # rows of the full side per product and sort


def hash_embedder(texts: Sequence[str], dim: int = 128) -> np.ndarray:
    """Deterministic bag-of-token embeddings: each token hashes to a fixed
    pseudo-random vector; a text embeds as the normalized token sum."""
    out = np.zeros((len(texts), dim), np.float32)
    cache: Dict[str, np.ndarray] = {}
    for i, text in enumerate(texts):
        acc = np.zeros(dim, np.float32)
        for tok in text.lower().split():
            v = cache.get(tok)
            if v is None:
                h = hashlib.blake2b(tok.encode("utf-8"), digest_size=8).digest()
                rng = np.random.default_rng(int.from_bytes(h, "little"))
                v = rng.standard_normal(dim).astype(np.float32)
                cache[tok] = v
            acc += v
        n = np.linalg.norm(acc)
        out[i] = acc / n if n > 0 else acc
    return out


DEFAULT_ST_MODEL = "sentence-transformers/all-mpnet-base-v2"


def sentence_transformer_embedder(model_name: str = DEFAULT_ST_MODEL):
    """An embedder backed by the sentence-transformers package (the
    reference's frozen PLM); importable only where that package is."""
    from sentence_transformers import SentenceTransformer

    model = SentenceTransformer(model_name)

    def embed(texts: Sequence[str], dim: int = 0) -> np.ndarray:
        return np.asarray(model.encode(list(texts)))

    return embed


def get_embedder(name: str, model_name: str = DEFAULT_ST_MODEL, device=None):
    """The embedder of the config's `sag_embedder`, routed as the JAX package
    routes it: 'hash' (no pretrained model), 'sentence_transformer' (the
    sentence-transformers package), 'jax_mpnet' (the port's own MPNet
    forward, `plm.mpnet`, on `device`: CUDA unless the caller names one;
    `model_name` is a local checkpoint directory, read through
    `transformers`). The last keeps its JAX name, so that a JAX command line
    and its graph cache carry over. A missing package raises ImportError
    naming it; nothing falls back to 'hash'."""
    if name == "hash":
        return hash_embedder
    if name == "sentence_transformer":
        try:
            return sentence_transformer_embedder(model_name)
        except ImportError as e:
            raise ImportError(
                f"sag_embedder='sentence_transformer' needs the sentence-transformers package "
                f"(model {model_name}); install it or use sag_embedder='hash'") from e
    if name == "jax_mpnet":
        from digat_tpu_torch.plm.mpnet import pretrained_embedder

        return pretrained_embedder(model_name, device=device)
    raise ValueError(f"unknown sag_embedder {name!r}")


def dedup_category_news(
    rows: Sequence[Tuple[str, str, str, str]],
) -> Tuple[Dict[str, int], Dict[int, List[str]], List[str], List[str], List[str]]:
    """`rows`: (domain, news_ID, title, content) for one category, in file
    order. Returns (news->group, group->news list, titles, contents,
    empty_news_IDs)."""
    content_of: Dict[str, str] = {}
    by_title: Dict[str, List[str]] = {}
    empty: List[str] = []
    seen = set()
    for _, news_id, title, content in rows:
        if news_id in seen:
            continue
        seen.add(news_id)
        title = title.lower().replace("é", "e")
        content = content.lower().replace("é", "e")
        if title == "" and content != "":
            title = content
        elif title != "" and content == "":
            content = title
        elif title == "" and content == "":
            empty.append(news_id)
            continue
        content_of[news_id] = content
        by_title.setdefault(title, []).append(news_id)

    news_to_group: Dict[str, int] = {}
    group_news: Dict[int, List[str]] = {}
    titles: List[str] = []
    contents: List[str] = []
    for i, title in enumerate(by_title):
        titles.append(title)
        group_news[i] = []
        chosen = ""
        for news_id in by_title[title]:
            c = content_of[news_id]
            if c != "" and chosen == "":
                chosen = c
            news_to_group[news_id] = i
            group_news[i].append(news_id)
        contents.append(chosen if chosen else title)
    # duplicated contents get disambiguated with a title prefix
    dup = {c for c, n in Counter(contents).items() if n > 1}
    for i in range(len(contents)):
        if contents[i] in dup:
            contents[i] = titles[i] + " " + contents[i]
    return news_to_group, group_news, titles, contents, empty


def average_topk(
    full_title_emb: np.ndarray,
    full_content_emb: np.ndarray,
    corpus_title_emb: np.ndarray,
    corpus_content_emb: np.ndarray,
    top_m: int,
    batch: int = TOPK_CHUNK,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Average of the four cosine channels and the top M + 1 of each
    full-side row against the corpus side -> (values [n, k] float32,
    indices [n, k] int64), on `device` (CUDA unless the caller names one),
    `batch` rows a chunk. Equal values keep index order."""
    device = resolve_device(device)
    if device.type == "cuda":
        exact_fp32()

    def norm(x):
        n = np.linalg.norm(x, axis=1, keepdims=True)
        return torch.from_numpy((x / np.maximum(n, 1e-12)).astype(np.float32)).to(device)

    ft, fc = norm(full_title_emb), norm(full_content_emb)
    ct, cc = norm(corpus_title_emb).t(), norm(corpus_content_emb).t()
    k = min(top_m + 1, ct.shape[1])
    vals, idxs = [], []
    for s in range(0, ft.shape[0], batch):
        ft_b, fc_b = ft[s:s + batch], fc[s:s + batch]
        sims = (ft_b @ ct + fc_b @ cc + ft_b @ cc + fc_b @ ct) / 4.0
        v, i = torch.sort(sims, dim=1, descending=True, stable=True)
        vals.append(v[:, :k].cpu())
        idxs.append(i[:, :k].cpu())
    return torch.cat(vals).numpy(), torch.cat(idxs).numpy()


def neighbor_lists(
    full_group_news: Dict[int, List[str]],
    corpus_group_news: Dict[int, List[str]],
    top_vals: np.ndarray,
    top_idx: np.ndarray,
    top_m: int,
    empty_news: Sequence[str],
    category_news_ids: Sequence[str],
    rng: np.random.Generator,
) -> Dict[str, List[Tuple[str, float]]]:
    """Per-news neighbour lists from the top-k of its dedup group."""
    result: Dict[str, List[Tuple[str, float]]] = {}
    m = min(top_m, max(len(corpus_group_news) - 1, 0))
    for gi, members in full_group_news.items():
        vals, idx = top_vals[gi], top_idx[gi]
        for news_id in members:
            lst: List[Tuple[str, float]] = []
            for j in range(len(idx)):
                group = corpus_group_news[int(idx[j])]
                if news_id in group:
                    continue
                lst.append((group[0], float(vals[j])))
                if len(lst) == m:
                    break
            result[news_id] = lst
    cand = list(category_news_ids)
    for news_id in empty_news:
        picks = rng.choice(len(cand), size=min(m + 1, len(cand)), replace=False)
        lst = []
        for p in picks:
            if cand[p] != news_id:
                lst.append((cand[p], 0.0))
                if len(lst) == m:
                    break
        result[news_id] = lst
    return result


def expand_graph(
    similarity: Dict[str, List[Tuple[str, float]]],
    news_id_dict: Dict[str, int],
    top_m: int,
    hops: int,
    node_num: int,
    use_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-news breadth-first expansion to `hops` with the 0.5-threshold
    pruning. Returns (news_node_ID [N, G] int32, news_graph [N, G, G] bool,
    news_graph_mask [N, G] bool). Row 0 (the <PAD> news) stays empty.
    Self-loops are not added here (`corpus.preprocess` adds them).

    By default the lists go to the native BFS in index form (news index
    order, cosines as float32: exact, since they come from fp32 sums);
    `use_native=False` runs this Python body, its plain version."""
    if use_native:
        idx, cos, off = [], [], [0]
        for news_id, _ in sorted(news_id_dict.items(), key=lambda kv: kv[1]):
            for nbr, c in similarity[news_id]:
                idx.append(news_id_dict[nbr])
                cos.append(c)
            off.append(len(idx))
        return native.expand_graph_native(
            np.asarray(idx, np.int32), np.asarray(cos, np.float32), np.asarray(off, np.int64),
            top_m, hops, node_num, SIMILARITY_THRESHOLD)
    news_num = len(news_id_dict)
    inv = {v: k for k, v in news_id_dict.items()}
    node_id = np.zeros((news_num, node_num), np.int32)
    graph = np.zeros((news_num, node_num, node_num), bool)
    mask = np.zeros((news_num, node_num), bool)
    mask[:, 0] = 1
    for i in range(1, news_num):
        node_id[i, 0] = i
        pos = {i: 0}
        depths = [0] * node_num
        head, rear = 0, 1
        while head < rear:
            if depths[head] == hops:
                head += 1
                continue
            nbrs = similarity[inv[node_id[i, head]]]
            for index, (nbr_id, cos) in enumerate(nbrs):
                if depths[head] > 0 and (cos < SIMILARITY_THRESHOLD or index == top_m - 1):
                    break
                j = news_id_dict[nbr_id]
                if j not in pos:
                    node_id[i, rear] = j
                    mask[i, rear] = 1
                    pos[j] = rear
                    graph[i, head, rear] = True
                    graph[i, rear, head] = True
                    depths[rear] = depths[head] + 1
                    rear += 1
                else:
                    p = pos[j]
                    graph[i, head, p] = True
                    graph[i, p, head] = True
            head += 1
    return node_id, graph, mask


def visualize_graph(
    path: str,
    news_index: int,
    node_id: np.ndarray,
    graph: np.ndarray,
    titles: Dict[int, str],
) -> None:
    """A readable dump of one news graph: the edge list with titles, then
    the adjacency matrix (the reference's debugging helper; the same bytes
    as the JAX package's)."""
    n = node_id.shape[1]
    with open(path, "w", encoding="utf-8") as f:
        f.write("Node1\tNode2\tTitle1\tTitle2\n")
        for i in range(n):
            for j in range(n):
                if graph[news_index, i, j]:
                    t1 = titles.get(int(node_id[news_index, i]), "")
                    t2 = titles.get(int(node_id[news_index, j]), "")
                    f.write(f"{i}\t{j}\t{t1}\t{t2}\n")
        f.write("\nnews graph\n")
        for i in range(n):
            f.write("\t".join(str(int(graph[news_index, i, j])) for j in range(n)))
            f.write("\n")


def mine_similarity(
    news_rows_by_category: Dict[str, List[Tuple[str, str, str, str]]],
    news_id_dict: Dict[str, int],
    top_m: int,
    embedder: Callable[[Sequence[str]], np.ndarray] = hash_embedder,
    exclude_test_from_corpus: bool = True,
    seed: int = 0,
    device=None,
) -> Dict[str, List[Tuple[str, float]]]:
    """Per-news top-M neighbour lists across all categories (the average
    channel). `news_rows_by_category`: per category, rows (domain, news_ID,
    title, content), domain 'train_dev' or 'test'; the corpus (candidate)
    side leaves out test-domain news when `exclude_test_from_corpus`
    (MIND-small)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    similarity: Dict[str, List[Tuple[str, float]]] = {}
    for rows in news_rows_by_category.values():
        if not rows:
            continue
        corpus_rows = [r for r in rows if r[0] != "test"] if exclude_test_from_corpus else rows
        if not corpus_rows:
            continue
        _, full_groups, f_titles, f_contents, f_empty = dedup_category_news(rows)
        _, corp_groups, c_titles, c_contents, _ = dedup_category_news(corpus_rows)
        if not c_titles:
            continue
        if f_titles:
            vals, idx = average_topk(embedder(f_titles), embedder(f_contents),
                                     embedder(c_titles), embedder(c_contents), top_m,
                                     device=device)
        else:
            vals = np.zeros((0, 1), np.float32)
            idx = np.zeros((0, 1), np.int64)
        cat_ids = [r[1] for r in rows]
        similarity.update(neighbor_lists(full_groups, corp_groups, vals, idx, top_m, f_empty,
                                         cat_ids, rng))
    for news_id in news_id_dict:
        similarity.setdefault(news_id, [])
    return similarity


def construct_sag(
    news_rows_by_category: Dict[str, List[Tuple[str, str, str, str]]],
    news_id_dict: Dict[str, int],
    top_m: int,
    hops: int,
    node_num: int,
    embedder: Callable[[Sequence[str]], np.ndarray] = hash_embedder,
    exclude_test_from_corpus: bool = True,
    seed: int = 0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The per-news SAG graphs of the whole corpus."""
    similarity = mine_similarity(news_rows_by_category, news_id_dict, top_m, embedder,
                                 exclude_test_from_corpus, seed, device)
    return expand_graph(similarity, news_id_dict, top_m, hops, node_num)


def construct_sa_sequence(
    news_rows_by_category: Dict[str, List[Tuple[str, str, str, str]]],
    news_id_dict: Dict[str, int],
    top_m: int,
    embedder: Callable[[Sequence[str]], np.ndarray] = hash_embedder,
    exclude_test_from_corpus: bool = True,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Flat semantic-augmentation matrix [news_num, top_m] int32 of
    neighbour news ids (0-padded): the SA strategy's artifact, no
    expansion."""
    similarity = mine_similarity(news_rows_by_category, news_id_dict, top_m, embedder,
                                 exclude_test_from_corpus, seed, device)
    out = np.zeros((len(news_id_dict), top_m), np.int32)
    for news_id, idx in news_id_dict.items():
        if idx == 0:
            continue
        for j, (nbr, _) in enumerate(similarity[news_id][:top_m]):
            out[idx, j] = news_id_dict[nbr]
    return out
