"""The LM stack on PyTorch: every configuration's shapes
(:class:`ModelConfig`) and the model of all ten architectures
(:class:`LanguageModel`): dense, hybrid, mixture-of-experts,
encoder-decoder, vision and xLSTM."""

from .config import ModelConfig
from .model import LanguageModel

__all__ = ["ModelConfig", "LanguageModel"]
