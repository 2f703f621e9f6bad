"""Serving: the packed engine, continuous batching and token sampling."""

from .batching import ContinuousBatchingEngine, Request
from .engine import KVCache, QuantizedLlama
from .sampling import SamplingParams, sample_token

__all__ = ["ContinuousBatchingEngine", "KVCache", "QuantizedLlama",
           "Request", "SamplingParams", "sample_token"]
