"""Synthetic MIND-format dataset generator: the port's own copy of
`digat_tpu/data/synthetic.py`, which writes the same bytes from the same
arguments.

Produces news.tsv / behaviors.tsv files with the exact column layout of the
Microsoft MIND dataset so the full preprocessing + training + eval stack can
run without downloads (tests, benchmarks, machines with no network). Titles are
sampled from a small topical vocabulary per category so SAG similarity
mining finds genuine structure, and click behavior follows a latent
user-category preference so training has signal.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

_CATEGORIES = [
    "news", "sports", "finance", "travel", "lifestyle", "video",
    "foodanddrink", "weather", "autos", "health", "entertainment", "music",
]

_TOPIC_WORDS = {
    c: [f"{c}word{i}" for i in range(40)] for c in _CATEGORIES
}
_COMMON_WORDS = [f"common{i}" for i in range(60)]


def generate(
    root: str,
    *,
    news_num: int = 400,
    categories: int = 6,
    train_behaviors: int = 300,
    dev_behaviors: int = 60,
    test_behaviors: int = 60,
    users: int = 80,
    max_impressions: int = 10,
    seed: int = 0,
    pref_alpha: float = 0.5,
    click_base: float = 0.15,
    click_scale: float = 0.8,
    min_history: int = 0,
    max_history: int = 20,
) -> None:
    """Write train/dev/test splits under `root` in MIND layout.

    `pref_alpha` controls how peaked the latent user-category preference is
    (smaller = sharper = more learnable clicks); `click_base`/`click_scale`
    set P(click) = base + scale * pref[category]. Defaults keep the
    original weak-signal behavior; the parity study uses sharper values so
    both frameworks have headroom to separate from AUC=0.5."""
    rng = np.random.default_rng(seed)
    cats = _CATEGORIES[:categories]

    news_ids = [f"N{i}" for i in range(1, news_num + 1)]
    news_cat = [cats[rng.integers(len(cats))] for _ in news_ids]

    def make_title(c: str) -> str:
        n = rng.integers(4, 12)
        words: List[str] = []
        for _ in range(n):
            if rng.random() < 0.6:
                words.append(_TOPIC_WORDS[c][rng.integers(40)])
            else:
                words.append(_COMMON_WORDS[rng.integers(60)])
        if rng.random() < 0.2:
            words.append(str(rng.integers(2000, 2030)))
        return " ".join(words)

    titles = [make_title(c) for c in news_cat]
    abstracts = [make_title(c) if rng.random() < 0.8 else "" for c in news_cat]

    # split the news pool: first 85% known at train time, rest only dev/test
    n_train = int(news_num * 0.7)
    n_dev = int(news_num * 0.85)
    split_news = {
        "train": range(0, n_train),
        "dev": range(n_train, n_dev),
        "test": range(n_dev, news_num),
    }

    user_pref = rng.dirichlet(np.ones(len(cats)) * pref_alpha, size=users)  # [U, C]
    cat_of = np.asarray([cats.index(c) for c in news_cat])

    def write_news(path: str, extra: range) -> None:
        with open(path, "w", encoding="utf-8") as f:
            pool = list(split_news["train"]) + list(extra)
            for i in pool:
                f.write(
                    f"{news_ids[i]}\t{news_cat[i]}\tsub{news_cat[i]}\t"
                    f"{titles[i]}\t{abstracts[i]}\turl\t[]\t[]\n"
                )

    def sample_behaviors(path: str, count: int, visible: np.ndarray, start_id: int):
        with open(path, "w", encoding="utf-8") as f:
            for b in range(count):
                u = rng.integers(users)
                pref = user_pref[u]
                p_news = pref[cat_of[visible]]
                p_news = p_news / p_news.sum()
                hist_len = rng.integers(min_history, max_history)
                history = rng.choice(visible, size=hist_len, replace=False, p=p_news)
                n_imp = rng.integers(2, max_impressions + 1)
                imp = rng.choice(visible, size=n_imp, replace=False)
                clicks = (
                    rng.random(n_imp)
                    < click_base + click_scale * pref[cat_of[imp]]
                ).astype(int)
                if clicks.sum() == 0:
                    clicks[rng.integers(n_imp)] = 1
                if clicks.sum() == n_imp:
                    clicks[rng.integers(n_imp)] = 0
                imps = " ".join(
                    f"{news_ids[i]}-{c}" for i, c in zip(imp, clicks)
                )
                hist = " ".join(news_ids[i] for i in history)
                f.write(f"{start_id + b}\tU{u}\t11/11/2019 9:05:58 AM\t{hist}\t{imps}\n")

    for split, extra, nb, sid in [
        ("train", range(0, 0), train_behaviors, 1),
        ("dev", split_news["dev"], dev_behaviors, 100001),
        ("test", split_news["test"], test_behaviors, 200001),
    ]:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        write_news(os.path.join(root, split, "news.tsv"), extra)
        visible = np.asarray(
            list(split_news["train"])
            + (list(extra) if split != "train" else [])
        )
        sample_behaviors(os.path.join(root, split, "behaviors.tsv"), nb, visible, sid)
