"""Tanner-graph edge layout for vectorized message passing.

The reference stores messages in per-node "inbox" vectors addressed with
start-offset + target-cell indirection computed in four duplicated copies of
``map_node_connections`` (discrete_LDPC_decoder.py:88-130,
discrete_LDPC_decoder_irreg.py:121-170). The equivalent below keeps
the same two canonical edge orders —

- **CN order**: edges enumerated row-by-row of H (CSR), i.e. the check-node
  inbox layout; slot ``(c, j)`` holds the message arriving at check node ``c``
  from its ``j``-th neighbor variable node.
- **VN order**: edges enumerated column-by-column (CSC), i.e. the
  variable-node inbox layout.

— but replaces per-work-item pointer chasing with two global permutation
vectors (pure gathers, XLA/Pallas friendly) plus *degree-grouped* dense index
matrices so each same-degree group of nodes is processed as one dense
``[num_nodes_of_degree, degree]`` block with static shapes under ``jit``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class DegreeGroup:
    """All nodes of one degree, with their edge slots in the node-order layout.

    ``edge_slots[i, j]`` is the flat edge index (in CN order for check-node
    groups, VN order for variable-node groups) of the ``j``-th edge of the
    ``i``-th node in this group.
    """

    degree: int
    node_ids: np.ndarray  # [n] int32, node indices of this degree
    edge_slots: np.ndarray  # [n, degree] int32, flat edge indices


@dataclasses.dataclass(frozen=True)
class TannerGraph:
    """Static decode-time view of a parity-check matrix."""

    n_vars: int
    n_checks: int
    n_edges: int
    # Degrees per node.
    vn_degree: np.ndarray  # [n_vars] int32
    cn_degree: np.ndarray  # [n_checks] int32
    # Edge endpoint lookups.
    cn_edge_var: np.ndarray  # [n_edges] int32: variable node of each CN-order edge
    vn_edge_check: np.ndarray  # [n_edges] int32: check node of each VN-order edge
    vn_edge_var: np.ndarray  # [n_edges] int32: variable node of each VN-order edge
    # Permutations between the two layouts (pure gathers):
    #   vn_layout_msgs = cn_layout_msgs[cn_slot_of_vn_edge]
    #   cn_layout_msgs = vn_layout_msgs[vn_slot_of_cn_edge]
    cn_slot_of_vn_edge: np.ndarray  # [n_edges] int32
    vn_slot_of_cn_edge: np.ndarray  # [n_edges] int32
    # Degree-grouped dense layouts.
    cn_groups: tuple[DegreeGroup, ...]
    vn_groups: tuple[DegreeGroup, ...]
    # Node-order starts (CSR/CSC indptr), kept for syndrome/segment ops.
    cn_start: np.ndarray  # [n_checks + 1] int64
    vn_start: np.ndarray  # [n_vars + 1] int64

    @property
    def d_c_max(self) -> int:
        return int(self.cn_degree.max())

    @property
    def d_v_max(self) -> int:
        return int(self.vn_degree.max())

    @property
    def code_rate(self) -> float:
        """Design rate 1 - mean(d_v)/mean(d_c), the reference's R_c
        (discrete_LDPC_decoder_irreg.py:69-100)."""
        from .ensembles import node_degree_distributions, code_rate_from_distributions

        d_v_dist, d_c_dist = node_degree_distributions(
            self.vn_degree, self.cn_degree
        )
        return code_rate_from_distributions(d_v_dist, d_c_dist)

    @property
    def data_len(self) -> int:
        """Number of systematic bits, exactly N - M. The reference computes
        ``int(R_c * N)`` from float-normalized degree distributions
        (discrete_LDPC_decoder_irreg.py:59), which floors to N - M - 1 for the
        DVB-S2 profile (R_c rounds below 0.5); we use the exact value so the
        counted prefix matches the encoder's systematic length."""
        return self.n_vars - self.n_checks

    @classmethod
    def from_check_matrix(cls, H: sp.spmatrix) -> "TannerGraph":
        H = sp.csr_matrix(H)
        H.sum_duplicates()
        H.data[:] = 1
        n_checks, n_vars = H.shape
        n_edges = H.nnz

        csc = H.tocsc()
        cn_degree = np.diff(H.indptr).astype(np.int32)
        vn_degree = np.diff(csc.indptr).astype(np.int32)

        # Flat-position matrix trick (generalizing the reference's H_copy loop,
        # discrete_LDPC_decoder_irreg.py:146-162): store each edge's CN-order
        # position as data, reorder to CSC to learn the permutation.
        pos = sp.csr_matrix(
            (np.arange(n_edges, dtype=np.int64), H.indices, H.indptr), shape=H.shape
        )
        cn_slot_of_vn_edge = pos.tocsc().data.astype(np.int32)
        vn_slot_of_cn_edge = np.empty(n_edges, dtype=np.int32)
        vn_slot_of_cn_edge[cn_slot_of_vn_edge] = np.arange(n_edges, dtype=np.int32)

        cn_edge_var = H.indices.astype(np.int32)
        vn_edge_check = csc.indices.astype(np.int32)
        vn_edge_var = np.repeat(
            np.arange(n_vars, dtype=np.int32), vn_degree
        )

        def build_groups(degrees: np.ndarray, start: np.ndarray) -> tuple[DegreeGroup, ...]:
            groups = []
            for d in np.unique(degrees):
                node_ids = np.nonzero(degrees == d)[0].astype(np.int32)
                slots = start[node_ids][:, None] + np.arange(int(d), dtype=np.int64)
                groups.append(
                    DegreeGroup(
                        degree=int(d),
                        node_ids=node_ids,
                        edge_slots=slots.astype(np.int32),
                    )
                )
            return tuple(groups)

        cn_start = H.indptr.astype(np.int64)
        vn_start = csc.indptr.astype(np.int64)
        return cls(
            n_vars=n_vars,
            n_checks=n_checks,
            n_edges=n_edges,
            vn_degree=vn_degree,
            cn_degree=cn_degree,
            cn_edge_var=cn_edge_var,
            vn_edge_check=vn_edge_check,
            vn_edge_var=vn_edge_var,
            cn_slot_of_vn_edge=cn_slot_of_vn_edge,
            vn_slot_of_cn_edge=vn_slot_of_cn_edge,
            cn_groups=build_groups(cn_degree, cn_start),
            vn_groups=build_groups(vn_degree, vn_start),
            cn_start=cn_start,
            vn_start=vn_start,
        )
