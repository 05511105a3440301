"""Training and serving step factories."""

from .serve import make_decode_step, make_prefill_step
from .step import make_eval_step, make_manual_dp_train_step, make_train_step

__all__ = [
    "make_train_step", "make_eval_step", "make_manual_dp_train_step",
    "make_prefill_step", "make_decode_step",
]
