"""Port's graph layer against the JAX package: spec registry, CSR graphs,
alias tables, every PaddedGraph field (FN-Base and FN-Cache), and the
layout carried across from the JAX build."""
import numpy as np
import pytest

from repro.core.alias import build_alias_rows as jax_build_alias_rows
from repro.core.graph import PaddedGraph as JaxPaddedGraph
from repro.core.transition import brute_force_probs as jax_brute
from repro.data import open_graph as jax_open_graph
from repro_torch.convert import padded_graph_from_numpy
from repro_torch.core.alias import build_alias_rows
from repro_torch.core.graph import FIELDS, PaddedGraph
from repro_torch.core.transition import brute_force_probs
from repro_torch.data.ingest import parse_spec
from repro_torch.data.store import open_graph

SPECS = ["wec:k=8,deg=12,seed=1", "skew:s=4,k=9,deg=20,seed=3"]


def _assert_same_csr(a, b):
    assert a.n == b.n
    for f in ("row_ptr", "col", "wgt"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("spec", SPECS + [
    "er:k=7,deg=6,seed=2", "rmat:k=8,deg=8,a=0.45,b=0.22,c=0.22,d=0.11",
    "skew:s=3,k=8,deg=10,seed=1,relabel=degree",
    "sbm:n=200,c=4,pin=0.06,pout=0.004,seed=1,relabel=degree"])
def test_open_graph_matches(spec):
    a, b = open_graph(spec), jax_open_graph(spec)
    _assert_same_csr(a.graph, b.graph)
    for side in ("labels", "perm"):
        x, y = getattr(a, side), getattr(b, side)
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(x, y)
    assert a.version == 0


def test_spec_errors():
    assert parse_spec("wec:k=3,deg=4") == ("wec", None, {"k": "3",
                                                         "deg": "4"})
    for bad in ("wec:k=8,degree=3", "nope:k=3", "wec:k=8,relabel=x", ":k=1"):
        with pytest.raises(ValueError):
            open_graph(bad)


def test_build_alias_rows_matches():
    rng = np.random.default_rng(0)
    w = rng.random((300, 57)).astype(np.float32) * 3
    live = rng.integers(0, 58, 300)
    w[np.arange(57)[None, :] >= live[:, None]] = 0.0
    w[:5] = 1.0                          # uniform rows: every entry large
    got, want = build_alias_rows(w), jax_build_alias_rows(w)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("cap", [None, 32])
def test_padded_graph_fields_match(spec, cap):
    """Every field of the FN-Base (cap=None) and FN-Cache (cap=32) layouts
    equals the JAX build's, integer and float alike."""
    g = open_graph(spec).graph
    ours = PaddedGraph.build(g, cap=cap, device="cpu")
    theirs = JaxPaddedGraph.build(jax_open_graph(spec).graph, cap=cap)
    assert (ours.n, ours.cap, ours.hot_cap) == (theirs.n, theirs.cap,
                                                theirs.hot_cap)
    for f in FIELDS:
        x, y = getattr(ours, f).numpy(), np.asarray(getattr(theirs, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    if cap is not None:                  # the FN-Cache layout has a hot set
        assert int(ours.hot_pos.max()) >= 0


def test_carried_layout_equals_own_build():
    spec = SPECS[1]
    theirs = JaxPaddedGraph.build(jax_open_graph(spec).graph, cap=32)
    fields = {f: np.asarray(getattr(theirs, f)) for f in FIELDS}
    carried = padded_graph_from_numpy(fields, theirs.n, theirs.cap,
                                      theirs.hot_cap, device="cpu")
    own = PaddedGraph.build(open_graph(spec).graph, cap=32, device="cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(carried, f).numpy(),
                              getattr(own, f).numpy()), f
    with pytest.raises(ValueError):
        padded_graph_from_numpy(fields, theirs.n, theirs.cap + 1,
                                theirs.hot_cap, device="cpu")


def test_brute_force_probs_match():
    g, jg = open_graph(SPECS[0]).graph, jax_open_graph(SPECS[0]).graph
    for u, v in [(0, int(g.neighbors(0)[0])), (5, int(g.neighbors(5)[-1]))]:
        assert brute_force_probs(g, u, v, 0.5, 2.0) == \
            jax_brute(jg, u, v, 0.5, 2.0)
