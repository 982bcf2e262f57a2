"""The port's native host loader (`digat_tpu_torch/native`) on the CPU.

`g++` builds the port's loader into `digat_tpu_torch/_build/` here as on
the card's host. The JAX package's library is built from its own
`loader.cpp` into a temporary directory (its bindings' library path is
pointed there), so nothing is written under `digat_tpu/`.

  (a) the three entry points bit for bit against the JAX package's native
      bindings: the cases of tests/test_native.py, seeded random files (a
      GloVe file past 1 MiB, so its threads' chunk joins are crossed, with
      and without a last newline) and every malformed line on which the
      JAX package's native and Python paths differ (the port follows the
      native path, the JAX package's default);
  (b) the native entry points against the port's plain versions on
      well-formed files;
  (c) `data.sag.expand_graph` at its default (native) against the JAX
      package's Python body (`use_native=False`) at hops 2 and 3 with a
      cosine at exactly the 0.5 threshold;
  (d) a build that fails raises out of every entry point and `preprocess`:
      nothing falls back to the Python loops;
  (e) two processes building at once leave one library, and both load it."""

import os
import subprocess
import sys

import numpy as np
import pytest

from digat_tpu.data import sag as jax_sag
from digat_tpu.native import bindings as jax_native
from digat_tpu_torch.config import Config
from digat_tpu_torch.data import corpus, sag, synthetic
from digat_tpu_torch.data import tokenize as tok
from digat_tpu_torch.native import bindings as native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEHAVIOR_KEYS = ("history_flat", "history_offsets", "clicks_flat", "clicks_offsets",
                 "nonclicks_flat", "nonclicks_offsets", "cand_flat", "label_flat",
                 "cand_offsets")


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's bindings on a library built from its own source in
    a temporary directory (never beside that source)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", str(tmp_path_factory.mktemp("jax_native") / "_native.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_failed", False)
        assert jax_native.available()
        yield jax_native


def assert_same_behaviors(got, want):
    assert sorted(got) == sorted(want) == sorted(BEHAVIOR_KEYS)
    for k in BEHAVIOR_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_same_glove(got, want):
    assert got[0] == want[0]
    assert got[1].dtype == want[1].dtype == np.float32
    assert got[1].shape == want[1].shape
    # bit for bit, infinities and signed zeros included
    assert got[1].tobytes() == want[1].tobytes()


def assert_same_graph(got, want):
    for a, b, name in zip(got, want, ("node_id", "graph", "mask")):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def random_similarity(rng, n, top_m, half_at=0):
    """Seeded neighbour lists over n news (index 0 the <PAD> news, no list):
    top_m distinct neighbours each, cosines descending float32; `half_at`
    lists hold a cosine of exactly 0.5 (the threshold)."""
    news_id_dict = {"<PAD>": 0, **{f"N{i}": i for i in range(1, n)}}
    inv = {v: k for k, v in news_id_dict.items()}
    similarity = {"<PAD>": []}
    for i in range(1, n):
        nbrs = rng.choice(np.arange(1, n), size=top_m, replace=False)
        cos = np.sort(rng.random(top_m).astype(np.float32))[::-1]
        if i <= half_at:
            cos[rng.integers(top_m)] = 0.5
            cos = np.sort(cos)[::-1]
        similarity[inv[i]] = [(inv[j], float(c)) for j, c in zip(nbrs, cos)]
    return similarity, news_id_dict


def flat(similarity, news_id_dict):
    idx, cos, off = [], [], [0]
    for news_id, _ in sorted(news_id_dict.items(), key=lambda kv: kv[1]):
        for nbr, c in similarity[news_id]:
            idx.append(news_id_dict[nbr])
            cos.append(c)
        off.append(len(idx))
    return np.asarray(idx, np.int32), np.asarray(cos, np.float32), np.asarray(off, np.int64)


def write_behaviors(path, rng, ids, rows, unlabeled=False):
    with open(path, "w", encoding="utf-8") as f:
        for r in range(rows):
            hist = " ".join(rng.choice(ids, rng.integers(0, 10), replace=False))
            imps = " ".join(
                x if unlabeled else f"{x}-{rng.integers(0, 2)}"
                for x in rng.choice(ids, rng.integers(1, 8), replace=False))
            f.write(f"{r}\tU{r}\t11/11/2019 9:05:58 AM\t{hist}\t{imps}\n")


def write_glove(path, rng, rows, dim, last_newline=True):
    lines = [f"w{i} " + " ".join("%.6g" % x for x in rng.standard_normal(dim))
             for i in range(rows)]
    text = "\n".join(lines) + ("\n" if last_newline else "")
    path.write_text(text, encoding="utf-8")
    return len(text.encode())


# ---------------------------------------------------------------------------
# (a) the cases of tests/test_native.py, port native against JAX native
# ---------------------------------------------------------------------------
def test_library_builds_into_build_dir_only():
    native.library()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == native.SOURCE.parent.parent / "_build"
    assert native.source_hash() in path.name
    assert not [p for p in native.SOURCE.parent.iterdir() if p.suffix == ".so"]


def test_expand_graph_matches_jax_native(jax_lib):
    rng = np.random.default_rng(0)
    top_m, hops = 4, 2
    similarity, news_id_dict = random_similarity(rng, 40, top_m)
    node_num = 1 + top_m + top_m * (top_m - 1)
    args = (*flat(similarity, news_id_dict), top_m, hops, node_num, sag.SIMILARITY_THRESHOLD)
    got = native.expand_graph_native(*args)
    assert_same_graph(got, jax_lib.expand_graph_native(*args))
    assert_same_graph(got, sag.expand_graph(similarity, news_id_dict, top_m, hops, node_num,
                                            use_native=False))


def test_parse_behaviors_matches_jax_native(jax_lib, tmp_path):
    news_dict = {"<PAD>": 0, "N1": 1, "N2": 2, "N3": 3, "N44": 4}
    path = str(tmp_path / "behaviors.tsv")
    lines = [
        "1\tU1\ttime\tN1 N2\tN3-1 N44-0 N1-0",
        "2\tU2\ttime\t\tN2-1 N3-0",  # empty history
        "3\tU3\ttime\tN44\tN1 N2",  # unlabeled (MIND-large test)
    ]
    with open(path, "w") as f:
        f.write("\r\n".join(lines) + "\n")
    got = native.parse_behaviors_native(path, news_dict)
    assert_same_behaviors(got, jax_lib.parse_behaviors_native(path, news_dict))
    assert got["history_flat"].tolist() == [1, 2, 4]
    assert got["cand_flat"].tolist() == [3, 4, 1, 2, 3, 1, 2]
    assert got["label_flat"].tolist() == [1, 0, 0, 1, 0, -1, -1]
    assert got["cand_offsets"].tolist() == [0, 3, 5, 7]


def test_parse_behaviors_scales_matches_jax_native(jax_lib, tmp_path):
    rng = np.random.default_rng(1)
    news_dict = {"<PAD>": 0, **{f"N{i}": i for i in range(1, 500)}}
    path = str(tmp_path / "behaviors.tsv")
    write_behaviors(path, rng, list(news_dict)[1:], 2000)
    got = native.parse_behaviors_native(path, news_dict)
    assert_same_behaviors(got, jax_lib.parse_behaviors_native(path, news_dict))
    assert len(got["cand_offsets"]) == 2001
    assert len(got["clicks_flat"]) + len(got["nonclicks_flat"]) == len(got["cand_flat"])


def test_parse_glove_matches_jax_native(jax_lib, tmp_path):
    dim = 4
    rng = np.random.default_rng(7)
    lines = [f"w{i} " + " ".join("%.6g" % x for x in rng.standard_normal(dim))
             for i in range(500)]
    lines += [
        "café -1.5 2e-3 0.25 3",  # unicode word
        "w3 9 8 7 6",  # duplicate word: the last row wins
        "short 1.0 2.0",  # too few fields: skipped
        "long 1 2 3 4 5",  # too many fields: skipped
        "trail 1 2 3 4   ",  # rstripped, then taken
        "",  # empty line: skipped
        ". . . 1 2 3 4",  # a word with spaces: skipped
    ]
    path = tmp_path / "glove.txt"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    got = native.parse_glove_native(str(path), dim)
    assert_same_glove(got, jax_lib.parse_glove_native(str(path), dim))
    assert_same_glove(got, tok._load_glove_txt_py(str(path), dim))
    assert "short" not in got[0] and "long" not in got[0] and "café" in got[0]
    assert got[1][got[0]["w3"]].tolist() == [9, 8, 7, 6]


def test_parse_glove_overflow_and_underflow_matches_jax_native(jax_lib, tmp_path):
    """1e999 becomes inf and 1e-999 becomes 0, through strtod."""
    path = tmp_path / "glove.txt"
    path.write_text("big 1e999 -1e999\ntiny 1e-999 -1e-999\nok 1.5 -2.5\n", encoding="utf-8")
    got = native.parse_glove_native(str(path), 2)
    assert_same_glove(got, jax_lib.parse_glove_native(str(path), 2))
    assert_same_glove(got, tok._load_glove_txt_py(str(path), 2))
    assert np.isposinf(got[1][got[0]["big"]][0]) and np.isneginf(got[1][got[0]["big"]][1])
    assert got[1][got[0]["tiny"]][0] == 0.0


def test_load_glove_empty_or_malformed_file_raises(tmp_path):
    """No parsed row is an error, not a (0, dim) matrix whose mean and std
    would be NaN."""
    empty = tmp_path / "empty.txt"
    empty.write_text("", encoding="utf-8")
    malformed = tmp_path / "malformed.txt"
    malformed.write_text("a 1 2\nb 3\n", encoding="utf-8")
    for path in (empty, malformed):
        with pytest.raises(ValueError, match="no valid GloVe rows"):
            tok.load_glove_txt(str(path), 4)


def test_missing_or_unreadable_file_raises_the_plain_error(tmp_path):
    """The plain version's OSError, from the native path with no fall-through
    (the JAX package's native GloVe path raises NativeParseError and reaches
    this error only by falling through to Python)."""
    missing = str(tmp_path / "does_not_exist.txt")
    with pytest.raises(FileNotFoundError):
        tok._load_glove_txt_py(missing, 4)
    with pytest.raises(FileNotFoundError):
        native.parse_glove_native(missing, 4)
    with pytest.raises(FileNotFoundError):
        tok.load_glove_txt(missing, 4)
    with pytest.raises(FileNotFoundError):
        corpus._parse_behaviors(missing, {"<PAD>": 0})
    with pytest.raises(IsADirectoryError):
        tok.load_glove_txt(str(tmp_path), 4)
    with pytest.raises(IsADirectoryError):
        corpus._parse_behaviors(str(tmp_path), {"<PAD>": 0})


def test_failed_parse_raises_native_parse_error(monkeypatch, tmp_path):
    """A parse the library reports as failed (ok = 0) raises, whatever the
    file: here the library is handed a path that vanished after the check."""
    path = tmp_path / "glove.txt"
    path.write_text("a 1 2\n", encoding="utf-8")
    monkeypatch.setattr(native, "_check_readable", lambda p: os.unlink(p))
    with pytest.raises(native.NativeParseError):
        native.parse_glove_native(str(path), 2)
    path.write_text("1\tU\tt\tN1\tN1-1\n", encoding="utf-8")
    with pytest.raises(native.NativeParseError):
        native.parse_behaviors_native(str(path), {"<PAD>": 0, "N1": 1})


# ---------------------------------------------------------------------------
# (a) + (b): seeded random well-formed files, against JAX native and plain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("last_newline", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_glove_past_one_mib_matches_jax_native_and_plain(jax_lib, tmp_path, seed, last_newline):
    """Past 1 MiB the parse splits over the host's threads: no row lost or
    doubled at a chunk join, the last line taken without its newline."""
    rng = np.random.default_rng(100 + seed)
    path = tmp_path / "glove.txt"
    rows, dim = 4000, 48
    size = write_glove(path, rng, rows, dim, last_newline)
    assert size > 1 << 20
    got = native.parse_glove_native(str(path), dim)
    assert_same_glove(got, jax_lib.parse_glove_native(str(path), dim))
    assert_same_glove(got, tok._load_glove_txt_py(str(path), dim))
    assert got[1].shape == (rows, dim) and list(got[0].values()) == list(range(rows))
    assert_same_glove(tok.load_glove_txt(str(path), dim), got)


@pytest.mark.parametrize("unlabeled", [False, True])
def test_random_behaviors_match_jax_native_and_plain(jax_lib, tmp_path, unlabeled):
    rng = np.random.default_rng(3 + unlabeled)
    news_dict = {"<PAD>": 0, **{f"N{i}": i for i in range(1, 300)}}
    path = str(tmp_path / "behaviors.tsv")
    write_behaviors(path, rng, list(news_dict)[1:], 800, unlabeled)
    got = native.parse_behaviors_native(path, news_dict)
    assert_same_behaviors(got, jax_lib.parse_behaviors_native(path, news_dict))
    assert_same_behaviors(got, corpus._parse_behaviors_py(path, news_dict))
    assert_same_behaviors(corpus._parse_behaviors(path, news_dict), got)


def test_generated_corpus_behaviors_match_jax_native_and_plain(jax_lib, tmp_path):
    """Every split of the port's generator's corpus (the CLI cells' files)."""
    root = tmp_path / "MIND-small"
    synthetic.generate(str(root), news_num=300, train_behaviors=200, dev_behaviors=60,
                       test_behaviors=60, users=40, seed=5)
    news_dict = {"<PAD>": 0}
    for split in corpus.SPLITS:
        for news_id, *_ in corpus._read_news_tsv(str(root / split / "news.tsv")):
            news_dict.setdefault(news_id, len(news_dict))
    for split in corpus.SPLITS:
        path = str(root / split / "behaviors.tsv")
        got = native.parse_behaviors_native(path, news_dict)
        assert_same_behaviors(got, jax_lib.parse_behaviors_native(path, news_dict))
        assert_same_behaviors(got, corpus._parse_behaviors_py(path, news_dict))


@pytest.mark.parametrize("top_m,hops", [(5, 2), (4, 3), (1, 2)])
def test_random_graph_matches_jax_native_and_plain(jax_lib, top_m, hops):
    rng = np.random.default_rng(10 * top_m + hops)
    similarity, news_id_dict = random_similarity(rng, 120, top_m, half_at=40)
    node_num = 1 + sum(top_m * (top_m - 1) ** h for h in range(hops))
    args = (*flat(similarity, news_id_dict), top_m, hops, node_num, sag.SIMILARITY_THRESHOLD)
    got = native.expand_graph_native(*args)
    assert_same_graph(got, jax_lib.expand_graph_native(*args))
    assert_same_graph(got, sag.expand_graph(similarity, news_id_dict, top_m, hops, node_num,
                                            use_native=False))


# ---------------------------------------------------------------------------
# (a) malformed lines: the JAX package's native and Python paths differ; the
#     port's native path gives the JAX native path's bits
# ---------------------------------------------------------------------------
_NEWS = {"<PAD>": 0, "N1": 1, "N2": 2, "N3": 3}
_BAD_BEHAVIORS = {
    # an unknown news id is dropped (Python: KeyError)
    "unknown id": ("1\tU1\tt\tN1 N9 N2\tN3-1 N9-0 N2-0\n", KeyError),
    # an empty token (a double space) is skipped (Python: KeyError on "")
    "double space": ("1\tU1\tt\tN1  N2\tN3-1  N2-0\n", KeyError),
    # a line with fewer than four tabs is skipped (Python: ValueError)
    "three tabs": ("1\tU1\tt\tN1 N2\n2\tU2\tt\tN2\tN1-1\n", ValueError),
    # CRLF is stripped
    "crlf": ("1\tU1\tt\tN1 N2\tN3-1 N2-0\r\n2\tU2\tt\t\tN1-0\r\n", None),
    # a token "-1" of two characters is looked up whole (Python: KeyError on "")
    "bare -1": ("1\tU1\tt\tN1\tN3-1 -1 N2-0\n", KeyError),
}


@pytest.mark.parametrize("case", sorted(_BAD_BEHAVIORS))
def test_malformed_behaviors_match_jax_native(jax_lib, tmp_path, case):
    text, plain_error = _BAD_BEHAVIORS[case]
    path = tmp_path / "behaviors.tsv"
    path.write_bytes(text.encode())
    dicts = [_NEWS] + ([{**_NEWS, "-1": 4}] if case == "bare -1" else [])
    for news_dict in dicts:
        got = native.parse_behaviors_native(str(path), news_dict)
        assert_same_behaviors(got, jax_lib.parse_behaviors_native(str(path), news_dict))
        if plain_error is None:
            assert_same_behaviors(got, corpus._parse_behaviors_py(str(path), news_dict))
        else:
            with pytest.raises(plain_error):
                corpus._parse_behaviors_py(str(path), news_dict)
    if case == "unknown id":
        assert got["history_flat"].tolist() == [1, 2]
        assert got["cand_flat"].tolist() == [3, 2]
    if case == "three tabs":
        assert got["history_offsets"].tolist() == [0, 1]  # one row, the second line's
    if case == "bare -1":
        # absent from the dictionary: dropped; present: an unlabeled candidate
        assert native.parse_behaviors_native(str(path), _NEWS)["cand_flat"].tolist() == [3, 2]
        assert got["cand_flat"].tolist() == [3, 4, 2]
        assert got["label_flat"].tolist() == [1, -1, 0]


_BAD_GLOVE = {
    # a number that fails to parse: the line is skipped (Python: ValueError)
    "bad number": ("a 1 2\nb 1 x\nc 3 4\n", ValueError),
    # the rstrip set is ASCII: a trailing NBSP rejects the line (Python
    # strips it and takes the line)
    "nbsp": ("a 1 2\nb 3 4\u00a0\n", "differs"),
    # a leading '+' is accepted
    "plus": ("a +1.5 2\nb 3 +4e2\n", None),
    # out of range: inf and 0, through strtod
    "range": ("a 1e999 -1e-999\nb 1e-999 -1e999\n", None),
}


@pytest.mark.parametrize("case", sorted(_BAD_GLOVE))
def test_malformed_glove_matches_jax_native(jax_lib, tmp_path, case):
    text, plain = _BAD_GLOVE[case]
    path = tmp_path / "glove.txt"
    path.write_bytes(text.encode())
    got = native.parse_glove_native(str(path), 2)
    assert_same_glove(got, jax_lib.parse_glove_native(str(path), 2))
    if plain is None:
        assert_same_glove(got, tok._load_glove_txt_py(str(path), 2))
    elif plain == "differs":
        assert sorted(got[0]) == ["a"]
        assert sorted(tok._load_glove_txt_py(str(path), 2)[0]) == ["a", "b"]
    else:
        with pytest.raises(plain):
            tok._load_glove_txt_py(str(path), 2)
    if case == "bad number":
        assert sorted(got[0]) == ["a", "c"]
    if case == "range":
        assert got[1].tolist() == [[np.inf, -0.0], [0.0, -np.inf]]


def test_expand_graph_refuses_lists_past_node_num():
    """The library writes into [node_num] rows: lists that could grow a
    graph past them raise before the call."""
    similarity, news_id_dict = random_similarity(np.random.default_rng(2), 30, 4)
    with pytest.raises(ValueError, match="past node_num"):
        sag.expand_graph(similarity, news_id_dict, 4, 2, 12)
    with pytest.raises(ValueError, match="malformed"):
        native.expand_graph_native(np.asarray([5], np.int32), np.asarray([0.9], np.float32),
                                   np.asarray([0, 1, 1], np.int64), 1, 1, 2, 0.5)


# ---------------------------------------------------------------------------
# (c) the port's default against the JAX package's Python body
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hops", [2, 3])
def test_expand_graph_default_matches_jax_python_body(hops):
    """tests/test_native.py's own comparison calls `sag.expand_graph` at its
    default, which is native there too: this one holds the port's native
    default against JAX's Python body."""
    top_m = 4
    rng = np.random.default_rng(20 + hops)
    similarity, news_id_dict = random_similarity(rng, 150, top_m, half_at=60)
    assert sum(c == 0.5 for lst in similarity.values() for _, c in lst) >= 60
    node_num = 1 + sum(top_m * (top_m - 1) ** h for h in range(hops))
    got = sag.expand_graph(similarity, news_id_dict, top_m, hops, node_num)
    want = jax_sag.expand_graph(similarity, news_id_dict, top_m, hops, node_num,
                                use_native=False)
    assert_same_graph(got, want)
    # the 0.5 cosines are kept past hop 0 (the rule prunes below 0.5 only)
    assert got[2].sum(1).max() > 1 + top_m


# ---------------------------------------------------------------------------
# (d) a failed build raises; nothing falls back to Python
# ---------------------------------------------------------------------------
@pytest.fixture(params=["missing compiler", "failing compiler"])
def broken_build(request, monkeypatch, tmp_path):
    compiler = str(tmp_path / "no-such-compiler") if request.param == "missing compiler" \
        else "false"
    monkeypatch.setattr(native, "COMPILER", compiler)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    return request.param


def test_failed_build_raises_from_every_entry_point(broken_build, tmp_path):
    glove = tmp_path / "glove.txt"
    glove.write_text("a 1 2\n", encoding="utf-8")
    behaviors = tmp_path / "behaviors.tsv"
    behaviors.write_text("1\tU1\tt\tN1\tN1-1\n", encoding="utf-8")
    similarity, news_id_dict = random_similarity(np.random.default_rng(0), 10, 3)
    match = "cannot run" if broken_build == "missing compiler" else "failed"
    calls = (lambda: tok.load_glove_txt(str(glove), 2),
             lambda: corpus._parse_behaviors(str(behaviors), {"<PAD>": 0, "N1": 1}),
             lambda: sag.expand_graph(similarity, news_id_dict, 3, 2, 10))
    for call in calls:
        with pytest.raises(native.NativeBuildError, match=match) as e:
            call()
        assert native.COMPILER in str(e.value)  # the command is in the message
    assert not list((tmp_path / "_build").glob("*"))  # no library, no temporary left


def test_failed_build_fails_preprocess(broken_build, tmp_path):
    synthetic.generate(str(tmp_path / "synthetic"), news_num=60, train_behaviors=20,
                       dev_behaviors=10, test_behaviors=10, users=10)
    cfg = Config(dataset="synthetic", data_root=str(tmp_path), device="cpu",
                 max_title_length=8, max_history_num=6, SAG_neighbors=3, SAG_hops=2,
                 word_embedding_dim=8)
    with pytest.raises(native.NativeBuildError):
        corpus.preprocess(cfg, verbose=False)
    paths = corpus._paths(cfg)
    assert not os.path.exists(paths["graph"]) and not os.path.exists(paths["behaviors"])


# ---------------------------------------------------------------------------
# (e) two processes building at once
# ---------------------------------------------------------------------------
_BUILDER = r"""
import sys
from pathlib import Path
from digat_tpu_torch.native import bindings as native
native.BUILD_DIR = Path(sys.argv[1])
path, seconds = native.build_library()
stoi, vecs = native.parse_glove_native(sys.argv[2], 2)
print(path.name, stoi, vecs.tolist())
"""


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    glove = tmp_path / "glove.txt"
    glove.write_text("a 1 2\nb 3 4\n", encoding="utf-8")
    build = tmp_path / "_build"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(build), str(glove)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    name = outs[0][0].split()[0]
    assert outs[0][0].strip() == f"{name} {{'a': 0, 'b': 1}} [[1.0, 2.0], [3.0, 4.0]]"
    assert sorted(p.name for p in build.iterdir()) == [name]
    assert name == native.library_path().name
