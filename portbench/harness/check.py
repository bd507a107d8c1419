"""Whether what the window served is right.

After the window, a sample of its requests drawn from the seed (the largest
request size in it where the mix has several) is recomputed by the family's
plain reference (`reference(...)` of `families/<family>.py`; the latent
family's is `portbench/reference/`) from the same seeded weights, made
anew, and compared image by image. Before that, each sampled request is
placed: its answer must be, byte for byte, a run of rows of one dispatch the
service returned while the request was waiting, at rows whose classes (and
colours, where the request has them) are the request's own; a request whose
answer no dispatch holds is `unplaced` (the batcher's fan-out handed it rows
that are not its own). A request of the window that raised or never came
back is `missing`.

The numbers compared, each against its limit in the configuration file
(`check.limits`):
- `image_gap`: the largest, over the sampled images, of an image's mean
  absolute difference from the reference's, in uint8 levels;
- `unplaced`, `missing`: counts, limit 0.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.reference import sampler as ref
from portbench.reference.seeds import request_plan


def sample(requests: List, n: int, seed: int) -> List:
    """`n` requests drawn from the seed, the largest size among them."""
    if not requests:
        return []
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    pick = list(rng.choice(len(requests), size=min(n, len(requests)), replace=False))
    largest = max(len(r.classes) for r in requests)
    if all(len(requests[i].classes) < largest for i in pick):
        sizes = [i for i, r in enumerate(requests) if len(r.classes) == largest]
        pick[0] = sizes[int(rng.integers(len(sizes)))]
    return [requests[i] for i in sorted(set(int(i) for i in pick))]


def _same(got: Optional[np.ndarray], want: Optional[np.ndarray]) -> bool:
    """Equal conditions: both absent, or both present and equal."""
    if got is None or want is None:
        return got is None and want is None
    return np.array_equal(got, want)


def place(request, dispatches) -> Optional[Tuple[object, int]]:
    """(dispatch, first row) whose returned rows are the request's answer,
    at rows whose classes and colours are the request's."""
    n = len(request.classes)
    for d in dispatches:
        if d.out is None or d.t_call < request.t_send or d.t_call > request.t_done:
            continue
        for o in range(len(d.classes) - n + 1):
            if (np.array_equal(d.classes[o:o + n], request.classes)
                    and _same(None if d.colors is None else d.colors[o:o + n], request.colors)
                    and np.array_equal(d.out[o:o + n], request.result)):
                return d, o
    return None


def rows_of(d, first: int, n: int, buckets) -> List[ref.Row]:
    """The latent reference's rows for dispatch rows first .. first + n - 1."""
    plan = request_plan(len(d.classes), buckets)
    starts = np.cumsum([0] + plan[:-1])
    out = []
    for j in range(first, first + n):
        c = int(np.searchsorted(starts, j, side="right") - 1)
        out.append(ref.Row(d.seed, c, plan[c], j - int(starts[c]), int(d.classes[j])))
    return out


def image_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each image's mean absolute difference, uint8 levels."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return diff.reshape(diff.shape[0], -1).mean(axis=1)


def check(family, cfg: dict, traffic: dict, run, dispatches, seed: int, device,
          control: bool = False) -> Dict:
    """{'numbers': {name: value}, 'limits': {name: limit}, 'correct': bool,
    'gaps': per-image gaps}: the window's sampled requests against the
    family's reference. With `control`, also 'control': the same for the
    reference's own images at the control's precision in the program's
    place."""
    window = run.in_window()
    missing = sum(1 for r in window if r.result is None)
    answered = [r for r in window if r.result is not None]
    picked = sample(answered, int(traffic["check_requests"]), seed)
    placed, got, unplaced = [], [], 0
    for r in picked:
        where = place(r, dispatches)
        if where is None:
            unplaced += 1
            continue
        placed.append((*where, len(r.classes)))
        got.append(r.result)
    gaps = ctl = np.zeros((0,))
    if placed:
        params, stats = family.make(cfg, seed, device)
        want = family.reference(params, stats, cfg, placed, "program")
        gaps = image_gaps(np.concatenate(got), want)
        if control:
            ctl = image_gaps(family.reference(params, stats, cfg, placed, "control"), want)
        del params, stats
        gc.collect()
    limits = dict(cfg["check"]["limits"])
    out = _verdict(gaps, unplaced, missing, limits)
    out.update(requests=len(picked), images=len(gaps))
    if control:
        out["control"] = _verdict(ctl, 0, 0, limits)
    return out


def _verdict(gaps: np.ndarray, unplaced: int, missing: int, limits: Dict) -> Dict:
    numbers = {"image_gap": float(gaps.max()) if gaps.size else float("nan"),
               "unplaced": unplaced, "missing": missing}
    correct = bool(gaps.size) and all(numbers[k] <= limits[k] for k in numbers)
    return {"numbers": numbers, "limits": limits, "correct": correct, "gaps": gaps}
