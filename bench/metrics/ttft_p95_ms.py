"""The 95th percentile, over every request whose first token arrived in the
window, of the milliseconds from the client sending it to that token."""
from bench.harness import quantile


def read(rec: dict):
    return quantile(rec.get("ttft_ms", []), 0.95)
