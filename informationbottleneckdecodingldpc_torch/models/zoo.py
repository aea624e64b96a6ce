"""Named codes, wrapping the JAX package's numpy-only model zoo.

``get_model(name)`` returns the JAX ``ModelSpec``'s settings unchanged; only
``make_layout`` differs, returning the port's :class:`DecodeLayout` built with
the model's structured node and edge orders.
"""

from __future__ import annotations

import dataclasses

import scipy.sparse as sp

from informationbottleneckdecodingldpc_tpu.codes.graph import TannerGraph
from informationbottleneckdecodingldpc_tpu.models import zoo as _reference

from ..decode.graph_arrays import DecodeLayout

MODELS = _reference.MODELS


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A model of the JAX zoo; its settings read through to ``reference``."""

    reference: _reference.ModelSpec

    def __getattr__(self, name):
        # Only called for names the wrapper lacks: the zoo's settings.
        if name == "reference":
            raise AttributeError(name)
        return getattr(self.reference, name)

    def make_layout(self, H: sp.csr_matrix | None = None) -> DecodeLayout:
        """TannerGraph + the port's DecodeLayout with this model's ordering."""
        spec = self.reference
        if H is None:
            H = spec.make_h()
        g = TannerGraph.from_check_matrix(H)
        keys = spec.layout_keys() if spec.layout_keys else (None, None)
        ekeys = (
            spec.layout_edge_keys(H) if spec.layout_edge_keys else (None, None)
        )
        return DecodeLayout.from_graph(
            g,
            cn_node_key=keys[0],
            vn_node_key=keys[1],
            cn_edge_key=ekeys[0],
            vn_edge_key=ekeys[1],
        )


def get_model(name: str) -> ModelSpec:
    return ModelSpec(_reference.get_model(name))
