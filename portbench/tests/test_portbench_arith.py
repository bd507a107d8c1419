"""The yardstick's arithmetic from the configuration's shapes."""
import json

import pytest

from portbench.harness import arith

from conftest import ROOT


def _cfg(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())


def test_flagship_bound_at_the_guided_64_bucket():
    # the bound chip_smoke.py::sampler_bound_ms printed for the flagship at
    # the guided 64 bucket: operations set it
    cfg = _cfg("flagship")
    assert round(arith.process_bound_s(cfg, 64) * 1e3, 3) == 1.652
    steps = 1000
    ops = steps * (1_619_001_344 / 989e12 + 60 * 64 * 256 / 67e12)
    assert arith.process_bound_s(cfg, 64) == pytest.approx(ops, rel=1e-12)


def test_denoiser_row():
    assert arith.denoiser_row_flops(_cfg("flagship")["denoiser"]) == 12_713_984
    # v2 adds the skip's 256 x 256 product
    assert arith.denoiser_row_flops(_cfg("v2")["denoiser"]) == 12_713_984 + 2 * 256 * 256


def test_decoder_counted_by_hand():
    conv3 = lambda c_in, c_out, side: 2 * c_in * c_out * 9 * side * side  # noqa: E731
    up = lambda c_in, c_out, side_in: 2 * c_in * c_out * 16 * side_in ** 2  # noqa: E731
    sa = lambda side: 2 * 2 * 49 * side * side  # noqa: E731
    ca = lambda c: 2 * (2 * c * (c // 8))  # noqa: E731
    want = (2 * 256 * 512 + 2 * 512 * 512 * 64
            + 2 * conv3(512, 512, 8) + ca(512) + sa(8)
            + up(512, 256, 8)
            + 2 * conv3(256, 256, 16) + ca(256) + sa(16)
            + up(256, 128, 16)
            + 2 * conv3(128, 128, 32) + ca(128) + sa(32)
            + up(128, 64, 32)
            + conv3(64, 32, 64) + conv3(32, 3, 64))
    assert want == 2_809_570_560
    assert arith.decoder_flops(_cfg("flagship")["decoder"]) == want


def test_image_flops():
    flag, v2 = _cfg("flagship"), _cfg("v2")
    assert arith.image_flops(flag) == 2 * 1000 * 12_713_984 + 2_809_570_560
    assert arith.image_flops(v2) == 1000 * (12_713_984 + 131_072) + 2_809_570_560
