"""The benchmark's graphs: RMAT edges drawn on the device from the seed,
symmetrised, deduplicated and packed into a CSR with sorted rows.

RMAT (Chakrabarti et al., SDM'04) as Fast-Node2Vec §4.1 reads it: each
of ``n * avg_degree / 2`` edges picks one quadrant per level of the 2^k
adjacency matrix, the row bit with P = c + d, then the column bit with
P = b / (a + b) in the top half and d / (c + d) in the bottom one. Self
loops are dropped and every edge is kept in both directions once; every
weight is 1 (the paper's graphs are unweighted).

The draws come from one ``torch.Generator`` on the run's device, seeded
from the run's seed, in two calls a level: the same seed gives the same
graph on the same kind of device.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CSR:
    """A CSR graph on one device: ``row_ptr`` [n+1] int64, ``col`` [m]
    int32 sorted within each row, ``wgt`` [m] float32."""
    n: int
    row_ptr: torch.Tensor
    col: torch.Tensor
    wgt: torch.Tensor

    @property
    def m(self) -> int:
        return int(self.col.shape[0])

    @property
    def deg(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    def numpy(self):
        """(row_ptr int64, col int32, wgt float32) on the host."""
        return (self.row_ptr.cpu().numpy(), self.col.cpu().numpy(),
                self.wgt.cpu().numpy())


def rmat_edges(k: int, num_edges: int, abcd, gen: torch.Generator,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_edges`` directed RMAT edges over 2^k vertices."""
    a, b, c, d = (float(x) for x in abcd)
    if abs(a + b + c + d - 1.0) > 1e-6:
        raise ValueError(f"RMAT probabilities must sum to 1, got {abcd}")
    p_row = c + d
    p_col_top = b / max(a + b, 1e-12)
    p_col_bottom = d / max(c + d, 1e-12)
    src = torch.zeros(num_edges, dtype=torch.int64, device=device)
    dst = torch.zeros(num_edges, dtype=torch.int64, device=device)
    for _ in range(k):
        row = torch.rand(num_edges, generator=gen, device=device) < p_row
        p_col = torch.where(row, p_col_bottom, p_col_top)
        col = torch.rand(num_edges, generator=gen, device=device) < p_col
        src = src * 2 + row
        dst = dst * 2 + col
    return src, dst


def csr_from_edges(n: int, src: torch.Tensor, dst: torch.Tensor) -> CSR:
    """Undirected CSR of an edge list: self loops dropped, each edge in
    both directions once, rows sorted."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = torch.unique(torch.cat([src * n + dst, dst * n + src]))
    src, dst = key // n, key % n
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return CSR(n=n, row_ptr=row_ptr, col=dst.to(torch.int32),
               wgt=torch.ones(dst.shape[0], dtype=torch.float32,
                              device=src.device))


def rmat_graph(cfg: dict, seed: int, device) -> CSR:
    """The configuration's RMAT graph (``k``, ``avg_degree``, ``rmat``
    [a, b, c, d]) from ``seed``."""
    k = int(cfg["k"])
    n = 1 << k
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    src, dst = rmat_edges(k, int(n * float(cfg["avg_degree"]) / 2),
                          cfg["rmat"], gen, device)
    return csr_from_edges(n, src, dst)


def degree_summary(g: CSR) -> dict:
    deg = g.deg
    return {"n": g.n, "m": g.m, "max_degree": int(deg.max()),
            "isolated": int((deg == 0).sum())}


def hot_count(g: CSR, cap) -> int:
    """Vertices whose degree exceeds ``cap`` (FN-Cache's hot set)."""
    return 0 if cap is None else int((g.deg > int(cap)).sum())
