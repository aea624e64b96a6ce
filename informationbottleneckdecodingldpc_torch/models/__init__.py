"""Named end-to-end codes with the port's decode layout, and the cache of
decoder configs built for them."""

from .artifacts import config_path, get_or_build_config
from .zoo import MODELS, ModelSpec, get_model

__all__ = ["MODELS", "ModelSpec", "config_path", "get_model", "get_or_build_config"]
