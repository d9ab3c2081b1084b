"""The 95th percentile of every gap, in milliseconds, between two
consecutive tokens of a request whose later token arrived in the window;
prefills admitted between two decode steps lengthen the gaps they fall
into."""
from bench.harness import quantile


def read(rec: dict):
    return quantile(rec.get("itl_ms", []), 0.95)
