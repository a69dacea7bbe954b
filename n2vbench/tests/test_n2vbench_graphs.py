"""The RMAT copy, the frozen counts and the busy-share union against
hand-worked small cases."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from n2vbench import graphs, profiling
from n2vbench.counts import node2vec_step, node2vec_walk, sgns_fused, \
    train_step


def _edges(g):
    rp, col, _ = g.numpy()
    return {(v, int(x)) for v in range(g.n) for x in col[rp[v]:rp[v + 1]]}


def test_rmat_quadrants():
    """b = 1 puts every edge in the top-right corner: 0 -> 2^k - 1; with
    c = 1 every edge is 2^k - 1 -> 0; both give the one undirected edge."""
    gen = torch.Generator().manual_seed(3)
    src, dst = graphs.rmat_edges(3, 5, (0, 1, 0, 0), gen, "cpu")
    assert src.tolist() == [0] * 5 and dst.tolist() == [7] * 5
    src, dst = graphs.rmat_edges(3, 5, (0, 0, 1, 0), gen, "cpu")
    assert src.tolist() == [7] * 5 and dst.tolist() == [0] * 5
    g = graphs.csr_from_edges(8, src, dst)
    assert _edges(g) == {(0, 7), (7, 0)}
    assert g.row_ptr.tolist() == [0, 1, 1, 1, 1, 1, 1, 1, 2]


def test_csr_symmetrises_dedups_and_sorts():
    src = torch.tensor([2, 0, 2, 1, 3, 3])
    dst = torch.tensor([0, 2, 1, 1, 0, 2])
    g = graphs.csr_from_edges(4, src, dst)
    # self loop 1-1 dropped, 0-2 once, rows sorted
    assert _edges(g) == {(0, 2), (2, 0), (1, 2), (2, 1), (0, 3), (3, 0),
                         (2, 3), (3, 2)}
    rp, col, wgt = g.numpy()
    assert rp.tolist() == [0, 2, 3, 6, 8]
    assert col.tolist() == [2, 3, 2, 0, 1, 3, 0, 2]
    assert wgt.tolist() == [1.0] * 8 and col.dtype == np.int32


def test_rmat_graph_is_seeded_and_sized():
    cfg = {"k": 8, "avg_degree": 10, "rmat": [0.25, 0.25, 0.25, 0.25]}
    a = graphs.rmat_graph(cfg, 2 ** 31 + 5, "cpu")
    b = graphs.rmat_graph(cfg, 2 ** 31 + 5, "cpu")
    c = graphs.rmat_graph(cfg, 2 ** 31 + 6, "cpu")
    assert torch.equal(a.col, b.col) and not torch.equal(a.row_ptr,
                                                         c.row_ptr)
    assert a.n == 256 and 2200 < a.m <= 2560
    with pytest.raises(ValueError):
        graphs.rmat_edges(2, 3, (0.5, 0.5, 0.5, 0), None, "cpu")


def test_node2vec_step_count():
    """Degrees 1, 2, 3 of vertices 0, 1, 2; one walker 0 -> 1 -> 2 -> 1:
    launch 1 reads v=1's row (8*2) and u=0's ids (4*1), launch 2 reads
    v=2's row (8*3) and u=1's ids (4*2); 28 bytes a walker each."""
    deg = np.array([1, 2, 3])
    walks = np.array([[1, 2, 1]])
    got = node2vec_step.bytes_per_launch(deg, np.array([0]), walks)
    assert got == ((16 + 4) + (24 + 8)) / 2 + 28


def test_node2vec_walk_count():
    """The same walk in one launch: the start's ids once (4*1), v=1's and
    v=2's rows (8*2 + 8*3), 8 a walker, 16 a walker and superstep."""
    deg = np.array([1, 2, 3])
    walks = np.array([[1, 2, 1]])
    got = node2vec_walk.bytes_per_launch(deg, np.array([0]), walks)
    assert got == 4 + 16 + 24 + 8 + 2 * 16


def test_sgns_and_step_counts():
    assert sgns_fused.bytes_per_launch(2, 1, 4) == 8 * 2 * 4 * 3 + \
        4 * 2 * 4 + 8
    assert train_step.bytes_per_step(10, 4, 2, 1) == 48 * 40 + \
        8 * 2 * 4 * 3 + 4 * 2 * 4
    assert train_step.flops_per_step(10, 4, 2, 1) == 6 * 2 * 4 * 2 + \
        14 * 2 * 40


def test_busy_share_is_a_union():
    """Two kernels that overlap on two streams count once: busy 3 of a
    window of 4, never more than the window."""
    t = profiling.Trace(window_s=4e-9, start_ns=0, end_ns=4, host=[],
                        device=[("a", 0, 2), ("b", 1, 3), ("c", 3, 3)])
    assert profiling.busy_seconds(t) == pytest.approx(3e-9)
    t.device.append(("d", -5, 10))
    assert profiling.busy_seconds(t) == pytest.approx(4e-9)
    assert profiling.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_idle_gaps_are_named_by_the_host():
    t = profiling.Trace(window_s=1e-5, start_ns=0, end_ns=10000,
                        device=[("k", 0, 2000), ("Memcpy DtoH", 8000,
                                                 10000)],
                        host=[("n2vbench.consume", 0, 10000),
                              ("aten::sort", 2500, 7000)])
    assert profiling.idle_gaps(t) == [["aten::sort", 6e-6]]
    assert len(profiling.kernels(t)) == 1
    assert profiling.matching(t, "k") == (1, 2e-6)
