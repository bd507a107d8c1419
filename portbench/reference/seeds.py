"""Frozen copies of how a seed becomes a request's inputs.

`derived_seed` is the serving API's rule for a chunk's generator (numpy's
SeedSequence over the words, the top bit dropped); `request_plan` its rule
for cutting a request into ladder buckets (full top-bucket chunks, then the
smallest bucket that holds the tail); `chunk_start` the draws a chunk of
`bucket` samples makes from its generator before the reverse process: the
starting state, then the two words of the Philox key.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def derived_seed(*words: int) -> int:
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def request_plan(n: int, buckets: Sequence[int]) -> List[int]:
    ladder = sorted(buckets)
    top = ladder[-1]
    plan = [top] * (n // top)
    rest = n % top
    if rest:
        plan.append(next(b for b in ladder if rest <= b))
    return plan or [ladder[0]]


def chunk_start(seed: int, chunk: int, bucket: int, latent: int,
                device) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(x_T of the chunk's `bucket` rows, the Philox key) of chunk `chunk`
    of a request served with `seed`."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, chunk))
    x = torch.randn((bucket, latent), generator=gen, device=device)
    key = torch.randint(0, 2**31 - 1, (2,), generator=gen, device=device).tolist()
    return x, (int(key[0]), int(key[1]))
