"""The port's native host loader: the port's own copy of `digat_tpu/native`.

`loader.cpp` holds the three host-side hot paths of the data preparation:
the SAG's breadth-first expansion, the behaviors.tsv parse and the
multithreaded GloVe parse. `bindings.py` builds it with `g++` into
`digat_tpu_torch/_build/` at first use and calls it through ctypes.
`data.sag.expand_graph`, `data.corpus.preprocess` and
`data.tokenize.load_glove_txt` go through it; their plain Python versions
stay beside them for the tests. A failed build raises: nothing falls back
to the Python loops."""

from digat_tpu_torch.native.bindings import (
    NativeBuildError,
    NativeParseError,
    expand_graph_native,
    parse_behaviors_native,
    parse_glove_native,
)

__all__ = [
    "NativeBuildError",
    "NativeParseError",
    "expand_graph_native",
    "parse_behaviors_native",
    "parse_glove_native",
]
