"""Serving: the packed W4A16 engine and token sampling."""

from .engine import KVCache, QuantizedLlama
from .sampling import SamplingParams, sample_token

__all__ = ["KVCache", "QuantizedLlama", "SamplingParams", "sample_token"]
