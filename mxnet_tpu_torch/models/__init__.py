"""Model families of the port: BERT (pretraining) and the GPT-2 family."""
from . import bert, gpt

__all__ = ["bert", "gpt"]
