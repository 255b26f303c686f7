"""LM requests for a closed loop of clients: a prompt of uniformly random
token ids and the number of tokens to generate (greedy, no stop token).

Lengths come in blocks of ``block`` requests. Every block holds the same
prompt lengths and the same output lengths, each log-uniform over its
range at evenly spaced quantiles, in an order of the block's own (prompt
and output lengths shuffled apart) drawn from the mix's ``order_seed``:
the lengths, and so the closed loop's admissions and its steps, are the
same in every run, and the run's seed draws the token ids (and the
weights). A seed that reordered the lengths would move which requests
meet in one step's admissions, and a tail of some tens of requests with
it. A prompt longer than ``round_above``
tokens is rounded to the nearest multiple of ``round_to``: the served
prefill attends in blocks of 512 tokens and takes a prompt of at most
512 tokens or a multiple of 512.

Parameters (the workload file's ``traffic``): ``block``, ``prompt_len``
[low, high], ``output_len`` [low, high], ``round_above``, ``round_to``,
``order_seed``. Request i is a function of the seed and i alone.
"""
from __future__ import annotations

import math

import numpy as np

from perfbench import weights


def _lengths(n: int, low: int, high: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(math.log(low) + q * (math.log(high)
                                               - math.log(low)))).astype(int)


def prompt_lengths(params: dict) -> np.ndarray:
    """One block's prompt lengths, in quantile order."""
    out = _lengths(params["block"], *params["prompt_len"])
    big = out > params["round_above"]
    r = params["round_to"]
    out[big] = np.maximum(r, np.rint(out[big] / r).astype(int) * r)
    return out


def output_lengths(params: dict) -> np.ndarray:
    return _lengths(params["block"], *params["output_len"])


class Requests:
    """Request i of the stream: (prompt int32 [S], gen_len)."""

    def __init__(self, params: dict, cfg: dict, seed: int):
        self.params, self.seed = params, seed
        self.vocab = cfg["vocab_size"]
        self._prompts = prompt_lengths(params)
        self._outputs = output_lengths(params)
        self._blocks: dict = {}

    def _block(self, b: int):
        if b not in self._blocks:
            order = np.random.default_rng(weights.subseed(
                self.params["order_seed"], f"order{b}"))
            s = self._prompts[order.permutation(len(self._prompts))]
            g = self._outputs[order.permutation(len(self._outputs))]
            rng = np.random.default_rng(weights.subseed(self.seed,
                                                        f"chat{b}"))
            toks = [rng.integers(0, self.vocab, n, dtype=np.int32)
                    for n in s]
            self._blocks = {b: list(zip(toks, g.tolist()))}
        return self._blocks[b]

    def __getitem__(self, i: int) -> tuple:
        n = self.params["block"]
        return self._block(i // n)[i % n]


def make(params: dict, cfg: dict, seed: int, device=None) -> Requests:
    return Requests(params, cfg, seed)
