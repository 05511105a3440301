"""Serving step factories (the training steps come with a later slice)."""

from .serve import make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step"]
