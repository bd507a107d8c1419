"""The one generator of requests, driven by a traffic file's parameters.

A traffic file (`portbench/traffic/<name>.json`) is data:

- `loop`: "closed" (one client that keeps `in_flight` requests issued
  through `SamplingService.sample_async`, issuing the next before fetching
  the oldest) or "open" (arrivals on a schedule through
  `CoalescingBatcher.submit`, whatever the backlog, with the batcher's
  settings under `batcher`);
- the request: `classes` "grid" (each of `class_ids` repeated `per_class`
  times: one fixed request) or "uniform" (`sizes`, each a request's image
  count, and classes uniform over the configuration's);
- what else an image carries is the family's (`conditions`): each condition
  it declares with a count is drawn uniform over that many values from the
  seed, classes first, then colours (a grid's colours once, for the one
  fixed request); a family that declares no colours draws exactly what a
  mix drew before families, in the same order;
- open loop: `rate_per_s` requests a second and `client_threads`;
- `lead_s`: seconds of traffic before the window opens; `check_requests`: how
  many requests of the window the output check recomputes.

An open schedule is a fixed amount of work for a given rate and length: the
request count is rate x length, the sizes cycle through `sizes`, and the gaps
are the exponential distribution's quantiles at (i + 1/2) / n; the seed only
orders them (and draws the classes), so every seed offers the same work. It
orders them within blocks: each run of len(`sizes`) requests holds every
size once, and each run of GAP_BLOCK arrivals takes one gap from each of
GAP_BLOCK strata of the quantiles, so that any stretch of the schedule
offers nearly the same images whatever the seed, while the arrivals inside
a block keep the exponential gaps' bursts.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

GAP_BLOCK = 50


CONDITIONS = ("classes", "colors")  # the service's per-image arguments, in drawing order


class Planned(NamedTuple):
    due: float  # seconds after the schedule's start (open loop)
    classes: np.ndarray
    colors: Optional[np.ndarray] = None  # None where the family declares no colours


def _rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), tag]))


def grid_classes(traffic: dict) -> np.ndarray:
    return np.repeat(np.asarray(traffic["class_ids"], np.int64), traffic["per_class"])


def _declared(conditions: dict) -> dict:
    unknown = set(conditions) - set(CONDITIONS)
    if unknown or "classes" not in conditions:
        raise ValueError(f"conditions {sorted(conditions)}: a family declares 'classes' "
                         f"and may add 'colors', nothing else")
    return conditions


def _draw(conditions: dict, size: int, rng: np.random.Generator):
    """(classes, colours) of a request of `size` images, drawn from `rng` in
    that order: classes without a count are zeros, colours without one None."""
    count = conditions["classes"]
    classes = np.zeros((size,), np.int64) if count is None else rng.integers(0, int(count), size)
    count = conditions.get("colors")
    return classes, None if count is None else rng.integers(0, int(count), size)


def grid_request(traffic: dict, conditions: dict, seed: int):
    """(classes, colours) of the closed loop's one request: the grid's
    classes and, where the family declares colours, colours drawn once from
    the seed (None where it does not)."""
    classes = grid_classes(traffic)
    count = _declared(conditions).get("colors")
    return classes, None if count is None else _rng(seed, 2).integers(0, int(count), len(classes))


def request_sizes(traffic: dict) -> List[int]:
    """Every image count a request of this mix can have."""
    if traffic["classes"] == "grid":
        return [len(grid_classes(traffic))]
    return sorted(set(traffic["sizes"]))


def open_schedule(traffic: dict, conditions: dict, seconds: float, seed: int) -> List[Planned]:
    """The arrivals of `seconds` of open-loop traffic (the lead-in included),
    each with the conditions the family declares (`conditions`)."""
    _declared(conditions)
    rate = float(traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    rng = _rng(seed, 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = _block_shuffle(_strata(gaps, GAP_BLOCK, rng), GAP_BLOCK, rng)
    sizes = _block_shuffle(np.resize(np.asarray(traffic["sizes"], np.int64), n),
                           len(traffic["sizes"]), rng)
    t = np.cumsum(gaps) - gaps[0]
    out = []
    for due, size in zip(t, sizes):
        if due >= seconds:
            break
        out.append(Planned(float(due), *_draw(conditions, int(size), rng)))
    return out


def _strata(sorted_values: np.ndarray, block: int, rng: np.random.Generator) -> np.ndarray:
    """The sorted values dealt into blocks of `block`, one from each of
    `block` strata of consecutive values, which block gets which member of a
    stratum drawn at random; values past a whole number of blocks, spread
    over the range, go last."""
    n = len(sorted_values)
    rest = np.unique(np.round(np.linspace(0, n - 1, n % block)).astype(np.int64))
    body = np.delete(sorted_values, rest)
    m = len(body) // block
    strata = rng.permuted(body[:m * block].reshape(block, m), axis=1)
    return np.concatenate([strata.T.reshape(-1), body[m * block:], sorted_values[rest]])


def _block_shuffle(values: np.ndarray, block: int, rng: np.random.Generator) -> np.ndarray:
    """The values with each run of `block` (and the remainder) permuted."""
    out = values.copy()
    for start in range(0, len(out), block):
        out[start:start + block] = rng.permutation(out[start:start + block])
    return out


def client_threads(traffic: dict) -> int:
    return int(traffic["client_threads"])
