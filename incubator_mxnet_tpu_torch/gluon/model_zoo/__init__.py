"""Model zoo of the port."""

from . import vision
from .convert import load_jax_params
from .gpt import GPTDecoder, get_gpt
from .vision import get_model

__all__ = ["GPTDecoder", "get_gpt", "get_model", "load_jax_params",
           "vision"]
