"""``mx.sym`` / ``mx.symbol``: symbol graphs (the part export and import
need; counterpart of the JAX package's ``symbol/``)."""

from .symbol import Group, Symbol, Variable, load, load_json, var

__all__ = ["Group", "Symbol", "Variable", "load", "load_json", "var"]
