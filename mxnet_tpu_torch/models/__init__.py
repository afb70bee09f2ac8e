"""Model families of the port (this slice: the GPT-2 family)."""
from . import gpt

__all__ = ["gpt"]
