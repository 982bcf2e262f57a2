"""The port's data pipeline and official-scorer files against `digat_tpu`,
on the CPU.

  * `data.synthetic.generate` writes the JAX generator's bytes, and with the
    prod cell's corpus settings it rebuilds the TSV files of the JAX study's
    refprot cell (parity_runs_refprot/data/MIND-small) byte for byte; the
    GloVe writer of scripts/torch_parity_cells.py rebuilds its glove.txt;
  * `data.tokenize` and `data.prepare.split_behaviors` give the JAX results
    (equal arrays, equal lists);
  * `data.corpus.preprocess` writes every artifact of `_paths`, each equal
    to the JAX package's, and each package's `Corpus` reads the other's;
  * `data.sag` built on the CPU equals the JAX package's news graph of the
    refprot corpus (parity_runs_refprot/ref/run/news_graph-2-5-MIND-small.pkl)
    in every row; equal cosines put the lower index first, as
    `jax.lax.top_k` does;
  * `eval.metrics`: the truth file, the rank-file reader and the official
    scorer give the JAX files and numbers."""

import importlib.util
import json
import os
import pathlib
import pickle
import sys
import types

import numpy as np
import pytest

from digat_tpu.config import Config as JaxConfig
from digat_tpu.data import corpus as jax_corpus
from digat_tpu.data import prepare as jax_prepare
from digat_tpu.data import sag as jax_sag
from digat_tpu.data import synthetic as jax_synthetic
from digat_tpu.data import tokenize as jax_tok
from digat_tpu.eval import metrics as JM
from digat_tpu_torch.config import Config
from digat_tpu_torch.data import corpus, prepare, sag, synthetic
from digat_tpu_torch.data import tokenize as tok
from digat_tpu_torch.eval import metrics as PM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFPROT = os.path.join(REPO, "parity_runs_refprot")
REFPROT_DATA = os.path.join(REFPROT, "data", "MIND-small")
SPLITS = ("train", "dev", "test")


def _cells():
    spec = importlib.util.spec_from_file_location(
        "torch_parity_cells", os.path.join(REPO, "scripts", "torch_parity_cells.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): pathlib.Path(d, f).read_bytes()
            for d, _, fs in os.walk(root) for f in fs}


def test_synthetic_matches_jax_generator(tmp_path):
    synthetic.generate(str(tmp_path / "port"))
    jax_synthetic.generate(str(tmp_path / "jax"))
    port, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(want) == sorted(f"{s}/{n}" for s in SPLITS
                                                  for n in ("news.tsv", "behaviors.tsv"))
    assert port == want


def test_synthetic_and_glove_rebuild_the_refprot_cell(tmp_path):
    cells = _cells()
    root = tmp_path / "MIND-small"
    synthetic.generate(str(root), **cells.PROD_DATASET)
    assert _files(root) == _files(REFPROT_DATA)
    cells.gen_glove(str(root), str(tmp_path / "glove.txt"), cells.PROD_GEOMETRY[
        "word_embedding_dim"])
    with open(os.path.join(REFPROT, "glove.txt"), "rb") as f:
        assert (tmp_path / "glove.txt").read_bytes() == f.read()


def _titles(split):
    with open(os.path.join(REFPROT_DATA, split, "news.tsv"), encoding="utf-8") as f:
        return [line.split("\t")[3] for line in f if line.strip()]


def test_tokenize_matches_jax(tmp_path):
    texts = ["Héllo, World! 2019 cafés", "a|b;c?d.e 3.5 -7 x1", "", "NUM 12 twelve"]
    for t in texts:
        assert tok.tokenize(t) == jax_tok.tokenize(t)
    for s in ("3.5", "-7", "1e3", "x1", "nan", "twelve"):
        assert tok.is_number(s) == jax_tok.is_number(s)
    streams = [(i, _titles(s)) for i, s in enumerate(SPLITS)]
    vocab = tok.build_vocabulary(streams, 3)
    assert vocab == jax_tok.build_vocabulary(streams, 3) and len(vocab) > 100
    for title in _titles("dev")[:50] + texts:
        for L in (7, 16, 32):
            got, want = tok.encode_title(title, vocab, L), jax_tok.encode_title(title, vocab, L)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    glove = os.path.join(REFPROT, "glove.txt")
    for path, dim in ((glove, 300), (None, 24)):
        got = tok.build_word_embedding(vocab, dim, path, seed=3)
        want = jax_tok.build_word_embedding(vocab, dim, path, seed=3)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_split_behaviors_matches_jax():
    with open(os.path.join(REFPROT_DATA, "train", "behaviors.tsv"), encoding="utf-8") as f:
        lines = [l for l in f if l.strip()]
    for seed in (0, 5):
        got = prepare.split_behaviors(lines, seed)
        assert got == jax_prepare.split_behaviors(lines, seed)
        assert len(got[0]) == int(len(lines) * prepare.TRAIN_RATIO)


def test_prepare_without_data_names_the_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not download") as e:
        prepare.prepare("MIND-small", str(tmp_path))
    assert os.path.join("download", "train", "behaviors.tsv") in str(e.value)
    root = tmp_path / "MIND-small"
    for s in SPLITS:  # an existing layout is left alone
        (root / s).mkdir(parents=True)
        (root / s / "behaviors.tsv").write_text("x")
    prepare.prepare("MIND-small", str(tmp_path))
    assert sorted(os.listdir(root)) == sorted(SPLITS)


_GEO = dict(dataset="synthetic", max_title_length=12, max_history_num=10, SAG_neighbors=3,
            SAG_hops=2, word_embedding_dim=16, augmented_news_num=4, model_family="nrms")


def _load(path):
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith(".npy"):
        return {"": np.load(path)}
    return dict(np.load(path))


def test_preprocess_matches_jax_and_caches_cross_read(tmp_path):
    """Every artifact, on a synthetic corpus with a GloVe file: JSON equal,
    every array equal; then each package's Corpus reads the other's cache."""
    src = tmp_path / "src"
    synthetic.generate(str(src / "synthetic"), news_num=150, train_behaviors=80,
                       dev_behaviors=20, test_behaviors=20, users=30)
    glove = tmp_path / "glove.txt"
    _cells().gen_glove(str(src / "synthetic"), str(glove), 16)
    roots = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        d.mkdir()
        os.symlink(src / "synthetic", d / "synthetic")
        roots[name] = str(d)
    pcfg = Config(data_root=roots["port"], glove_path=str(glove), device="cpu", **_GEO)
    jcfg = JaxConfig(data_root=roots["jax"], glove_path=str(glove), use_pallas=False, **_GEO)
    corpus.preprocess(pcfg)
    jax_corpus.preprocess(jcfg)
    ppaths, jpaths = corpus._paths(pcfg), jax_corpus._paths(jcfg)
    assert {k: os.path.relpath(v, roots["port"]) for k, v in ppaths.items()} == \
        {k: os.path.relpath(v, roots["jax"]) for k, v in jpaths.items()}
    for key, path in ppaths.items():
        if key == "cache":
            continue
        got, want = _load(path), _load(jpaths[key])
        if path.endswith(".json"):
            assert got == want, key
            continue
        assert sorted(got) == sorted(want), key
        for name in want:
            assert got[name].dtype == want[name].dtype, (key, name)
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{key} {name}")
    # each package reads the other's cache
    jread = jax_corpus.Corpus(JaxConfig(data_root=roots["port"], glove_path=str(glove),
                                        use_pallas=False, **_GEO))
    pread = corpus.Corpus(Config(data_root=roots["jax"], glove_path=str(glove), device="cpu",
                                 **_GEO))
    assert pread.news_dict == jread.news_dict and pread.vocab == jread.vocab
    for name in ("news_title_text", "news_title_mask", "news_node_id", "news_graph",
                 "news_graph_mask", "word_embedding", "augmented_news", "train_pos",
                 "train_neg_flat", "train_neg_offsets", "train_behavior_row", "dev_cand",
                 "dev_imp_index", "dev_labels", "test_cand", "test_labels"):
        np.testing.assert_array_equal(getattr(pread, name), getattr(jread, name), err_msg=name)
    for s in SPLITS:
        np.testing.assert_array_equal(pread.splits[s].history_idx, jread.splits[s].history_idx)
        np.testing.assert_array_equal(pread.splits[s].cat_idx, jread.splits[s].cat_idx)
    assert pread.test_unlabeled == jread.test_unlabeled is False
    tables = pread.tables()
    np.testing.assert_array_equal(tables.news_graph, np.asarray(jread.tables().news_graph))
    np.testing.assert_array_equal(pread.nrms_tables().augmented_news,
                                  np.asarray(jread.nrms_tables().augmented_news))


def test_sag_matches_jax_news_graph_of_refprot():
    """The port's SAG of the refprot corpus (hash embedder, 5 neighbours, 2
    hops), built on the CPU, equals the JAX package's graph, which the JAX
    study pickled for the reference harness. No row differs, so no near-tie
    of the fp32 cosine sums has to be stated."""
    with open(os.path.join(REFPROT, "data", "MIND-small-cache", "dicts.json")) as f:
        dicts = json.load(f)
    with open(os.path.join(REFPROT, "ref", "run", "news_graph-2-5-MIND-small.pkl"), "rb") as f:
        want = pickle.load(f)
    roots = {s: os.path.join(REFPROT_DATA, s) for s in SPLITS}
    node_id, graph, mask = sag.construct_sag(corpus._rows_by_category(roots, dicts["category"]),
                                             dicts["news"], 5, 2, 26, seed=0, device="cpu")
    graph |= np.eye(26, dtype=bool)[None]
    assert node_id.shape == want["news_node_ID"].shape == (3001, 26)
    np.testing.assert_array_equal(node_id, want["news_node_ID"])
    np.testing.assert_array_equal(graph, want["news_graph"])
    np.testing.assert_array_equal(mask, want["news_graph_mask"])


def test_topk_ties_put_the_lower_index_first():
    """Equal cosine values keep index order (lower first), as jax.lax.top_k:
    a corpus of repeated rows gives exact ties."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 8)).astype(np.float32)
    corpus_t = np.stack([b, a, b, a, a, b, a]).astype(np.float32)
    full = np.stack([a, b, a + b]).astype(np.float32)
    vals, idx = sag.average_topk(full, full, corpus_t, corpus_t, 5, device="cpu")
    jvals, jidx = jax_sag.average_topk(full, full, corpus_t, corpus_t, 5)
    np.testing.assert_array_equal(idx[0][:4], [1, 3, 4, 6])
    np.testing.assert_array_equal(idx[1][:3], [0, 2, 5])
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_allclose(vals, np.asarray(jvals), rtol=0, atol=1e-6)
    assert idx.dtype == np.int64 and vals.dtype == np.float32


def test_pretrained_embedders_are_not_ported(monkeypatch):
    """(Named for the refusal it replaced.) `get_embedder` routes the three
    names as the JAX package does: `hash` to the hash embedder (its vectors
    the JAX package's), `sentence_transformer` to the sentence-transformers
    package (stubbed here), `jax_mpnet` to the port's MPNet (test_torch_mpnet
    drives it); a missing package raises ImportError naming it, never a
    fall-back to `hash`; any other name raises ValueError."""
    assert sag.get_embedder("hash") is sag.hash_embedder
    texts = ["Sports news today", "sports NEWS", ""]
    np.testing.assert_array_equal(sag.hash_embedder(texts), jax_sag.hash_embedder(texts))
    assert sag.DEFAULT_ST_MODEL == jax_sag.DEFAULT_ST_MODEL

    calls = {}

    class FakeST:
        def __init__(self, model_name):
            calls["model"] = model_name

        def encode(self, texts):
            calls["n"] = len(texts)
            return sag.hash_embedder(texts, dim=32)

    fake = types.ModuleType("sentence_transformers")
    fake.SentenceTransformer = FakeST
    monkeypatch.setitem(sys.modules, "sentence_transformers", fake)
    embed = sag.get_embedder("sentence_transformer", "fake/model")
    np.testing.assert_array_equal(embed(texts), sag.hash_embedder(texts, dim=32))
    assert calls == {"model": "fake/model", "n": 3}

    monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    with pytest.raises(ImportError, match="sentence-transformers"):
        sag.get_embedder("sentence_transformer")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        sag.get_embedder("jax_mpnet", "/nonexistent/checkpoint", device="cpu")
    with pytest.raises(ValueError, match="unknown sag_embedder"):
        sag.get_embedder("glove")


def test_truth_rank_files_and_scorer_match_jax(tmp_path):
    behaviors = os.path.join(REFPROT_DATA, "dev", "behaviors.tsv")
    PM.write_truth_file(behaviors, tmp_path / "port.txt")
    JM.write_truth_file(behaviors, tmp_path / "jax.txt")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    truth = PM.read_rank_or_truth_file(tmp_path / "port.txt")
    for a, b in zip(truth, JM.read_rank_or_truth_file(tmp_path / "jax.txt")):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    PM.write_rank_file(tmp_path / "rank.txt", [rng.normal(size=len(t)) for t in truth])
    got = PM.scoring_from_files(tmp_path / "port.txt", tmp_path / "rank.txt")
    assert got == JM.scoring_from_files(tmp_path / "jax.txt", tmp_path / "rank.txt")
    assert all(0 < m < 1 for m in got)
    # an unlabeled split writes no truth file
    unl = tmp_path / "unlabeled.tsv"
    unl.write_text("1\tU1\t11/11/2019 9:05:58 AM\tN1\tN2 N3\n")
    PM.write_truth_file(str(unl), tmp_path / "none.txt")
    assert not (tmp_path / "none.txt").exists()
    # the scorer's command line
    (tmp_path / "in" / "ref").mkdir(parents=True)
    (tmp_path / "in" / "res").mkdir()
    os.replace(tmp_path / "port.txt", tmp_path / "in" / "ref" / "truth.txt")
    os.replace(tmp_path / "rank.txt", tmp_path / "in" / "res" / "prediction.txt")
    PM.main([str(tmp_path / "in"), str(tmp_path / "out")])
    assert (tmp_path / "out" / "scores.txt").read_text().startswith(f"AUC:{got[0]:.4f}")
