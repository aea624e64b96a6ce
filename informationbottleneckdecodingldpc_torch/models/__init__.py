"""Named end-to-end codes with the port's decode layout."""

from .zoo import MODELS, ModelSpec, get_model

__all__ = ["MODELS", "ModelSpec", "get_model"]
