from .adamw import AdamW, OptState
from .schedule import warmup_cosine
from .compression import quantize_int8, dequantize_int8, compressed_allreduce

__all__ = [
    "AdamW", "OptState", "warmup_cosine",
    "quantize_int8", "dequantize_int8", "compressed_allreduce",
]
