"""The CUDA kernels against their plain twins, on the card.

Marked `cuda`: each test skips where torch sees no CUDA device. Run them on
a machine with an H100 with `python -m pytest tests/test_torch_port_cuda.py`.
Widths are small multiples of 8; chip_smoke.py covers the flagship shapes.
"""
import pytest
import torch

from flowerdiff_torch.kernels.full_sampler import reverse_step, reverse_step_plain
from flowerdiff_torch.kernels.latent_stage import (
    bind_head,
    bind_stage,
    fused_head,
    fused_head_plain,
    fused_stage,
    fused_stage_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _r(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


@pytest.mark.parametrize("b,d,d_out", [(1, 64, 64), (13, 128, 256), (32, 256, 64)])
def test_stage_kernel_matches_twin(gen, b, d, d_out):
    w = dict(scale=d ** -0.5, dtype=torch.bfloat16)
    args = (_r(gen, b, d), _r(gen, b, d), _r(gen, d, d, **w), _r(gen, d, scale=0.1),
            1 + _r(gen, d, scale=0.1), _r(gen, d, scale=0.1), 1 + _r(gen, d, scale=0.1),
            _r(gen, d, scale=0.1), _r(gen, d, d, **w), _r(gen, d, scale=0.1),
            _r(gen, d, d, **w), _r(gen, d, scale=0.1), _r(gen, d_out, d, **w),
            _r(gen, d_out, scale=0.1))
    row = _r(gen, d)
    run = bind_stage(*args[2:])
    before = fused_stage.launches
    got = run(args[0], args[1], row)
    assert fused_stage.launches == before + 1
    ref = fused_stage_plain(*args, row_add=row)
    assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
    assert torch.equal(fused_stage(*args, row_add=row), got)


def test_head_kernel_matches_twin(gen):
    b, dl, de, lat = 9, 64, 32, 128
    w = dict(scale=0.1, dtype=torch.bfloat16)
    args = (_r(gen, b, dl), _r(gen, b, de), _r(gen, b, de), _r(gen, dl, de, **w),
            _r(gen, dl), _r(gen, dl, de, **w), _r(gen, dl), 1 + _r(gen, dl, scale=0.1),
            _r(gen, dl), _r(gen, lat, dl, **w), _r(gen, lat))
    no_products = args[:1] + (None,) * 6 + args[7:]
    adds = dict(row_add=_r(gen, dl), rows_add=_r(gen, b, dl))
    for a, kw in ((args, {}), (args, adds), (no_products, adds)):
        before = fused_head.launches
        got = bind_head(*a[3:])(a[0], a[1], a[2], **kw)
        assert fused_head.launches == before + 1
        ref = fused_head_plain(*a, **kw)
        assert got.shape == (b, lat)
        assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
        assert torch.equal(fused_head(*a, **kw), got)


@pytest.mark.parametrize("guided", [False, True])
def test_reverse_step_kernel_matches_twin(gen, guided):
    b, lat = 5, 24
    x = _r(gen, b, lat)
    eps = _r(gen, 2 * b if guided else b, lat)
    kw = dict(guidance_scale=4.0 if guided else None, clip_x0=1.5, key=(7, 8))
    for t in (0, 1, 400):
        got = reverse_step(eps, x, t, (0.99, 0.5, 0.01), **kw)
        ref = reverse_step_plain(eps, x, t, (0.99, 0.5, 0.01), **kw)
        assert float((got - ref).abs().max()) <= 1e-4


def test_wrappers_reject_bad_cuda_inputs(gen):
    d, bf = 64, torch.bfloat16
    vec = _r(gen, d)
    weights = (_r(gen, d, d, dtype=bf), vec, vec, vec, vec, vec,
               _r(gen, d, d, dtype=bf), vec, _r(gen, d, d, dtype=bf), vec,
               _r(gen, d, d, dtype=bf), vec)
    h = _r(gen, 4, d)
    with pytest.raises(ValueError, match="dtype"):
        fused_stage(h.double(), None, *weights)
    with pytest.raises(ValueError, match="shape"):
        fused_stage(h, _r(gen, 3, d), *weights)
    with pytest.raises(ValueError, match="dtype"):
        fused_stage(h, None, *((weights[0].float(),) + weights[1:]))
    with pytest.raises(ValueError, match="contiguous"):
        fused_stage(_r(gen, d, 4).t(), None, *weights)
    with pytest.raises(ValueError, match="16-byte"):
        fused_stage(_r(gen, 4 * d + 1)[1:].view(4, d), None, *weights)
    with pytest.raises(ValueError):
        reverse_step(_r(gen, 4, d), h, 3, (0.9, 0.5, 0.1), guidance_scale=2.0)
    with pytest.raises(ValueError):
        reverse_step(_r(gen, d, 4).t(), h, 3, (0.9, 0.5, 0.1))
