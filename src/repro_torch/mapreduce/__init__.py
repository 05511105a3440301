"""Paper §IV-B: a MapReduce engine implemented on the Bind model (the port
of ``repro.mapreduce``)."""

from .engine import KVPairs
from .sort import sort_integers

__all__ = ["KVPairs", "sort_integers"]
