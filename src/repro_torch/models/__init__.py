"""The LM stack's serving path on PyTorch: every configuration's shapes
(:class:`ModelConfig`) and, for the dense and hybrid families, the model
(:class:`LanguageModel`)."""

from .config import ModelConfig
from .model import LanguageModel

__all__ = ["ModelConfig", "LanguageModel"]
