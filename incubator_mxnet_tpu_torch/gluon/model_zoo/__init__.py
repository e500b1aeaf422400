"""Model zoo of the port."""

from .convert import load_jax_params
from .gpt import GPTDecoder, get_gpt

__all__ = ["GPTDecoder", "get_gpt", "load_jax_params"]
