"""Decode layout: degree-grouped, slot-major edge ordering.

Port of ``decode/graph_arrays.py`` ``DecodeLayout``. All edges of
same-degree nodes are contiguous and slot-major: a degree-d group's block
holds d planes of ``num_nodes`` rows, plane j being "message j of every
node", so a node update is elementwise over planes. Moving messages between
the check-node (CN) view and the variable-node (VN) view is one row
permutation.

On the GPU a permutation is an index gather, or a routed write through its
inverse, so the JAX package's run/transpose decomposition of the
permutations (``PermutationPlan``, a TPU gather workaround) is not ported:
the layout carries plain index arrays.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..codes.graph import TannerGraph


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One node-degree group: rows [offset, offset + degree*num_nodes) of the
    view, plane j at [offset + j*num_nodes, offset + (j+1)*num_nodes)."""

    degree: int
    offset: int
    num_nodes: int
    node_ids: np.ndarray  # [num_nodes] int32 original node indices


class LayoutTensors(NamedTuple):
    """The layout's index arrays as int64 tensors on one device."""

    to_vn_perm: torch.Tensor
    to_cn_perm: torch.Tensor
    cn_edge_var: torch.Tensor
    vn_node_order: torch.Tensor
    vn_node_unperm: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DecodeLayout:
    n_vars: int
    n_checks: int
    n_edges: int
    d_c_max: int
    d_v_max: int
    data_len: int
    code_rate: float

    cn_groups: tuple[GroupSpec, ...]
    vn_groups: tuple[GroupSpec, ...]

    # Row permutations between the views (int32):
    #   vn_view = cn_view[to_vn_perm];  cn_view = vn_view[to_cn_perm]
    to_vn_perm: np.ndarray
    to_cn_perm: np.ndarray
    # Their inverses, for routing on write: CN-view row r goes to VN-view row
    # cn_to_vn_row[r], VN-view row r to CN-view row vn_to_cn_row[r].
    cn_to_vn_row: np.ndarray
    vn_to_cn_row: np.ndarray
    # Variable node of each CN-view row (seeds the CN view with channel
    # clusters).
    cn_edge_var: np.ndarray
    # Variable node of each group-ordered VN node (gathers channel values).
    vn_node_order: np.ndarray
    # Inverse of vn_node_order: group-order position of each variable.
    vn_node_unperm: np.ndarray

    _tensors: dict = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False
    )

    @classmethod
    def from_graph(
        cls,
        g: TannerGraph,
        cn_node_key: np.ndarray | None = None,
        vn_node_key: np.ndarray | None = None,
        cn_edge_key: np.ndarray | None = None,
        vn_edge_key: np.ndarray | None = None,
    ) -> "DecodeLayout":
        """Build the layout. The optional node keys reorder nodes within each
        degree group (ascending key); the edge keys (indexed by CSR / CSC
        edge position) reorder each node's inbox slots. Message passing does
        not depend on either; outputs are always in natural variable order.
        """

        def reorder(groups, key, edge_key):
            out = []
            for grp in groups:
                node_ids, slots = grp.node_ids, grp.edge_slots
                if edge_key is not None:
                    order = np.argsort(
                        np.asarray(edge_key)[slots], axis=1, kind="stable"
                    )
                    slots = np.take_along_axis(slots, order, axis=1)
                if key is not None:
                    order = np.argsort(
                        np.asarray(key)[node_ids], kind="stable"
                    )
                    node_ids, slots = node_ids[order], slots[order]
                out.append((grp.degree, node_ids, slots))
            return out

        cn_groups_g = reorder(g.cn_groups, cn_node_key, cn_edge_key)
        vn_groups_g = reorder(g.vn_groups, vn_node_key, vn_edge_key)

        def slot_major(groups):
            return np.concatenate([slots.T.ravel() for _, _, slots in groups])

        cn_slots = slot_major(cn_groups_g)
        vn_slots = slot_major(vn_groups_g)
        cn_pos = np.empty(g.n_edges, dtype=np.int64)
        cn_pos[cn_slots] = np.arange(g.n_edges)
        vn_pos = np.empty(g.n_edges, dtype=np.int64)
        vn_pos[vn_slots] = np.arange(g.n_edges)

        to_vn_perm = cn_pos[g.cn_slot_of_vn_edge[vn_slots]]
        to_cn_perm = vn_pos[g.vn_slot_of_cn_edge[cn_slots]]

        def specs(groups) -> tuple[GroupSpec, ...]:
            out, off = [], 0
            for degree, node_ids, _ in groups:
                out.append(
                    GroupSpec(
                        degree=int(degree),
                        offset=off,
                        num_nodes=int(node_ids.size),
                        node_ids=np.asarray(node_ids, dtype=np.int32),
                    )
                )
                off += node_ids.size * degree
            return tuple(out)

        vn_node_order = np.concatenate([ids for _, ids, _ in vn_groups_g])
        vn_node_unperm = np.empty(g.n_vars, dtype=np.int64)
        vn_node_unperm[vn_node_order] = np.arange(g.n_vars)
        i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
        return cls(
            n_vars=g.n_vars,
            n_checks=g.n_checks,
            n_edges=g.n_edges,
            d_c_max=g.d_c_max,
            d_v_max=g.d_v_max,
            data_len=g.data_len,
            code_rate=g.code_rate,
            cn_groups=specs(cn_groups_g),
            vn_groups=specs(vn_groups_g),
            to_vn_perm=i32(to_vn_perm),
            to_cn_perm=i32(to_cn_perm),
            cn_to_vn_row=i32(np.argsort(to_vn_perm)),
            vn_to_cn_row=i32(np.argsort(to_cn_perm)),
            cn_edge_var=i32(g.cn_edge_var[cn_slots]),
            vn_node_order=i32(vn_node_order),
            vn_node_unperm=i32(vn_node_unperm),
        )

    def tensors(self, device: torch.device | str) -> LayoutTensors:
        """The index arrays as int64 tensors on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._tensors:
            t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
            self._tensors[device] = LayoutTensors(
                to_vn_perm=t(self.to_vn_perm),
                to_cn_perm=t(self.to_cn_perm),
                cn_edge_var=t(self.cn_edge_var),
                vn_node_order=t(self.vn_node_order),
                vn_node_unperm=t(self.vn_node_unperm),
            )
        return self._tensors[device]
