"""Benchmark timing (Google Benchmark analog).

Counters follow the reference: items/s, bytes/s, per-phase ms (SURVEY §6),
emitted as JSON (scripts/parse_results.py consumes them into CSV).
"""

from .harness import time_fn  # noqa: F401
