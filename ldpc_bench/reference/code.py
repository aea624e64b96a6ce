"""The code of a configuration: its parity-check matrix, the order in which
each node reads its edges, and systematic encoding.

Two families, as a configuration file's ``code`` states them:

- ``qc``: a circulant-exponent base matrix and its lift ``z`` (IEEE
  802.11n-2009 Annex R): entry e >= 0 is the z x z identity shifted so that
  block row i has its one in column (i + e) mod z; -1 is a zero block.
- ``ira``: an address table (ETSI EN 302 307 Annex B): bit m of information
  group g (``group`` bits a group) checks the parity rows (x + m q) mod
  (n - k) of each address x of the group, q = (n - k) / group; the parity
  part is the staircase (parity j in rows j and j + 1).

Edge order (``inbox``): the order in which a node folds its incoming
messages. ``natural`` reads a check's edges by ascending variable and a
variable's by ascending check. ``address`` (q-group IRA codes) reads a
check's information edges by the address x = (r - (c mod group) q) mod
(n - k) they came from, then its parity edges, the one below the diagonal
first; a variable's information edges by the same address, a parity
variable's diagonal edge first. Ties keep the natural order.

Encoding is systematic, the information bits first: the parity p solves
B p = A u over GF(2) for H = [A | B]; by a prefix XOR where B is the
staircase, else by B's dense inverse.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


def parity_check(code: dict) -> sp.csr_matrix:
    """The 0/1 parity-check matrix [n - k, n] of a configuration's code."""
    if code["family"] == "qc":
        base, z = np.asarray(code["base"]), int(code["z"])
        rows, cols, r = [], [], np.arange(z)
        for bi, bj in zip(*np.nonzero(base >= 0)):
            rows.append(bi * z + r)
            cols.append(bj * z + (r + base[bi, bj]) % z)
        shape = (base.shape[0] * z, base.shape[1] * z)
    elif code["family"] == "ira":
        n, k, group = int(code["n"]), int(code["k"]), int(code["group"])
        m = n - k
        q = m // group
        bit = np.arange(group)
        rows, cols = [], []
        for g, addresses in enumerate(code["addresses"]):
            for x in addresses:
                rows.append((x + bit * q) % m)
                cols.append(g * group + bit)
        rows += [np.arange(m), np.arange(1, m)]
        cols += [k + np.arange(m), k + np.arange(m - 1)]
        shape = (m, n)
    else:
        raise ValueError(f"unknown code family {code['family']!r}")
    r, c = np.concatenate(rows), np.concatenate(cols)
    H = sp.csr_matrix((np.ones(r.size, np.int8), (r, c)), shape=shape)
    H.sum_duplicates()
    H.data[:] = 1
    return H


@dataclasses.dataclass(frozen=True)
class Graph:
    """A parity-check matrix as edges and degree groups. Edge e is the e-th
    nonzero of H in row-major order (check ``edge_check[e]``, variable
    ``edge_var[e]``). ``check_groups`` and ``var_groups`` map a degree d to
    (node ids [n], edge ids [d, n]): slot j of a node is the j-th edge it
    reads."""

    n_vars: int
    n_checks: int
    edge_check: np.ndarray
    edge_var: np.ndarray
    check_groups: dict
    var_groups: dict

    @property
    def n_edges(self) -> int:
        return self.edge_var.size


def _groups(node_of_edge: np.ndarray, sort_key: np.ndarray, n_nodes: int) -> dict:
    order = np.lexsort((np.arange(node_of_edge.size), sort_key, node_of_edge))
    degree = np.bincount(node_of_edge, minlength=n_nodes)
    start = np.concatenate([[0], np.cumsum(degree)])
    groups = {}
    for d in np.unique(degree):
        nodes = np.nonzero(degree == d)[0]
        slots = start[nodes][None, :] + np.arange(d)[:, None]
        groups[int(d)] = (nodes, order[slots])
    return groups


def graph(H: sp.csr_matrix, code: dict) -> Graph:
    """The edges of ``H`` and each node's inbox in the configuration's
    ``inbox`` order."""
    H = sp.csr_matrix(H)
    m, n = H.shape
    check = np.repeat(np.arange(m), np.diff(H.indptr))
    var = H.indices.astype(np.int64)
    inbox = code.get("inbox", "natural")
    if inbox == "natural":
        check_key, var_key = var, check
    elif inbox == "address":
        k, group = n - m, int(code["group"])
        q = m // group
        address = (check - (var % group) * q) % m
        check_key = np.where(var < k, address, m + (var - k - check) + 1)
        var_key = np.where(var < k, address, m + (check - (var - k)))
    else:
        raise ValueError(f"unknown inbox order {inbox!r}")
    return Graph(n, m, check, var, _groups(check, check_key, m), _groups(var, var_key, n))


def _gf2_inverse(B: np.ndarray) -> np.ndarray:
    """Dense GF(2) inverse by Gauss-Jordan elimination."""
    m = B.shape[0]
    work = np.concatenate([B.astype(np.uint8) & 1, np.eye(m, dtype=np.uint8)], axis=1)
    for col in range(m):
        pivot = col + np.flatnonzero(work[col:, col])
        if pivot.size == 0:
            raise ValueError("the parity part of H is singular over GF(2)")
        work[[col, pivot[0]]] = work[[pivot[0], col]]
        rows = np.flatnonzero(work[:, col])
        rows = rows[rows != col]
        work[rows] ^= work[col]
    return work[:, m:]


class Encoder:
    """Systematic encoder of H on ``device``: info bits [k, batch] ->
    codewords [n, batch] int8."""

    def __init__(self, H: sp.csr_matrix, device: torch.device | str):
        H = sp.csr_matrix(H)
        m, n = H.shape
        self.k = n - m
        A, B = H[:, : self.k].tocsr(), H[:, self.k:].tocsr()
        self.staircase = (B != sp.eye(m, format="csr") + sp.eye(m, k=-1, format="csr")).nnz == 0
        device = torch.device(device)
        deg = np.diff(A.indptr)
        cols = np.full((m, int(deg.max())), self.k, dtype=np.int64)  # index k: a zero row
        for r in range(m):
            cols[r, : deg[r]] = A.indices[A.indptr[r]:A.indptr[r + 1]]
        self.cols = torch.as_tensor(cols, device=device)
        self.inverse = None if self.staircase else torch.as_tensor(
            _gf2_inverse(B.toarray()).astype(np.float32), device=device)

    def __call__(self, info: torch.Tensor) -> torch.Tensor:
        u = torch.cat([info.to(torch.int32), info.new_zeros((1, info.shape[1]), dtype=torch.int32)])
        s = u[self.cols].sum(dim=1) & 1  # [m, batch]
        if self.staircase:
            parity = torch.cumsum(s, dim=0) & 1
        else:
            parity = torch.round(self.inverse.double() @ s.double()).to(torch.int64) & 1
        return torch.cat([info.to(torch.int8), parity.to(torch.int8)])
