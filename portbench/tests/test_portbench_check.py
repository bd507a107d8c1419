"""The output check at a test size on the CPU: the sound program passes; the
control (the reference one precision lower in the program's place) and
each fault a serving cell can have, planted under the timed path, fail.

The port runs its kernels' plain twins on the CPU, so this drives the whole
run but the look for a card: set-up, the window through the same entry,
the placement of each answer and the reference. The test configurations
(`tests/data/configs/`) carry limits of their own, set from CPU readings
at their size (the sound program reads at most ~0.2 levels, the control
5.3-6.1).
"""
import time

import numpy as np
import pytest
import torch

from portbench.harness import cell

SEED = 2**31 + 4242
CELLS = ("tiny_flagship.grid", "tiny_v2.online", "tiny_flagship.online")


def _run(spec, name, control=False):
    return cell.run(spec, name, SEED, 3.0, False, torch.device("cpu"), time.perf_counter(),
                    metric_names=[], control=control)["verdict"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct_and_control_is_not(tiny_spec, name):
    v = _run(tiny_spec, name, control=True)
    assert v["correct"], v["numbers"]
    assert v["images"] > 0 and v["numbers"]["unplaced"] == 0
    assert not v["control"]["correct"], v["control"]["numbers"]


def _state_unchanged(monkeypatch):
    from flowerdiff_torch.kernels import full_sampler

    monkeypatch.setattr(full_sampler.ReverseProcess, "__call__",
                        lambda self, inputs, **kw: inputs.x.clone())


def _half_left_out(monkeypatch):
    from flowerdiff_torch.kernels import full_sampler

    orig = full_sampler.ReverseProcess.__call__

    def half(self, inputs, **kw):
        out = orig(self, inputs, **kw)
        b = out.shape[0]
        out[b // 2:] = inputs.x[b // 2:]
        return out

    monkeypatch.setattr(full_sampler.ReverseProcess, "__call__", half)


def _answer_altered(monkeypatch):
    from flowerdiff_torch import serving

    orig = serving.SamplingService._decode

    def swapped(self, latents):
        img = orig(self, latents)
        idx = torch.arange(img.shape[0]) ^ 1  # rows 0 <-> 1, 2 <-> 3, ...
        return img[idx.clamp(max=img.shape[0] - 1)]

    monkeypatch.setattr(serving.SamplingService, "_decode", swapped)


def _fan_out_shifted(monkeypatch):
    from flowerdiff_torch import serving_http

    def shifted(items, out):
        start = 0
        for p in items:
            n = p.classes.shape[0]
            p.result = np.roll(out, 1, axis=0)[start:start + n]
            start += n
            p.done.set()

    monkeypatch.setattr(serving_http.CoalescingBatcher, "_distribute", staticmethod(shifted))


FAULTS = [(c, f) for c in CELLS for f in (_state_unchanged, _half_left_out, _answer_altered)]
FAULTS += [(c, _fan_out_shifted) for c in CELLS if c.endswith(".online")]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_spec, monkeypatch, name, fault):
    fault(monkeypatch)
    v = _run(tiny_spec, name)
    assert not v["correct"], v["numbers"]
