"""The one generator of traffic: it reads a mix's parameters and the
configuration's, and makes the requests or batches of a run from its seed.

Every seed gives the same work in another order. A serving mix is a
repetition of blocks of ``block`` requests; each block holds the same
pairs of prompt and output length, spread evenly over the mix's ranges
(``prompt_len``, ``output_len``, inclusive) and paired by a fixed
shuffle, and the seed orders each block and draws the token ids. So a
window that takes some hundreds of requests takes nearly the same
lengths on every seed.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

PAIRING_SEED = 0      # fixes which output length goes with which prompt


def lengths(mix: dict) -> list:
    """The block's ``(prompt_len, output_len)`` pairs, in a fixed order."""
    k = mix["block"]
    lo, hi = mix["prompt_len"]
    prompts = [lo + int((i + 0.5) / k * (hi - lo + 1)) for i in range(k)]
    olo, ohi = mix["output_len"]
    outs = [olo + int((i + 0.5) / k * (ohi - olo + 1)) for i in range(k)]
    pair = np.random.default_rng(PAIRING_SEED).permutation(k)
    return [(prompts[i], outs[j]) for i, j in enumerate(pair)]


def requests(mix: dict, cfg: dict, seed: int) -> Iterator[Tuple[np.ndarray,
                                                                int]]:
    """Endless ``(prompt token ids, max_new)``: blocks of the mix's pairs,
    each block in an order drawn from ``seed``, token ids uniform over the
    configuration's vocabulary."""
    rng = np.random.default_rng(int(seed))
    block = lengths(mix)
    while True:
        for i in rng.permutation(len(block)):
            s, n = block[i]
            yield rng.integers(0, cfg["vocab"], s, dtype=np.int64), n


class Batches:
    """A training mix's batches, made on the device from the seed: step
    ``i`` takes the next ``batch`` rows of ``seq + 1`` token ids, uniform
    over the vocabulary (the last ``seq`` of each row are its targets)."""

    def __init__(self, mix: dict, cfg: dict, seed: int, device):
        import torch
        self.shape = (mix["batch"], mix["seq"] + 1)
        self.vocab = cfg["vocab"]
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(int(seed) + 1)

    def next(self) -> dict:
        import torch
        rows = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device)
        return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
