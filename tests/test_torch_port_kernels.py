"""flowerdiff_torch kernel modules on the CPU (their plain twins) against the
JAX package: the Pallas kernels in interpret mode, `model.apply`, and the
DDPM step math. The CUDA kernels themselves are held against these twins on
the card (chip_smoke.py, tests/test_torch_port_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.diffusion.ddpm import p_sample as jax_p_sample
from flowerdiff.kernels.latent_stage import fused_head as jax_fused_head
from flowerdiff.kernels.latent_stage import fused_stage as jax_fused_stage
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.kernels.denoiser_apply import make_fast_denoiser
from flowerdiff_torch.kernels.full_sampler import (
    philox4x32_10,
    philox_normal,
    reverse_step,
)
from flowerdiff_torch.kernels.latent_stage import (
    bind_head,
    bind_stage,
    fused_head,
    fused_stage,
)
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

# The JAX kernels' own LayerNorm epsilon, passed to the port to match.
JAX_KERNEL_EPS = 1e-5


def _mk(rng, *shape, scale=0.05):
    return rng.normal(size=shape, scale=scale).astype(np.float32)


def _both(arrs, bf16):
    """numpy arrays -> (jax list, torch list); the `bf16` indices are weights,
    bf16 on both sides, (in, out) for JAX and (out, in) for the port."""
    j = [jnp.asarray(a, jnp.bfloat16 if i in bf16 else jnp.float32) for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a.T.copy()).to(torch.bfloat16) if i in bf16
         else torch.from_numpy(a) for i, a in enumerate(arrs)]
    return j, t


@pytest.mark.parametrize("d,d_out", [(128, 128), (128, 256), (256, 128)])
def test_plain_fused_stage_matches_pallas_interpret(d, d_out):
    rng = np.random.default_rng(0)
    b = 8
    arrs = [_mk(rng, b, d), _mk(rng, b, d),
            _mk(rng, d, d), _mk(rng, d), 1 + _mk(rng, d), _mk(rng, d),
            1 + _mk(rng, d), _mk(rng, d),
            _mk(rng, d, d), _mk(rng, d), _mk(rng, d, d), _mk(rng, d),
            _mk(rng, d, d_out), _mk(rng, d_out)]
    j, t = _both(arrs, bf16={2, 8, 10, 12})
    ref = np.asarray(jax_fused_stage(*j, interpret=True))
    got = fused_stage(*t, eps=JAX_KERNEL_EPS).numpy()
    # tolerance of tests/test_kernels.py:44-46
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


def test_plain_fused_stage_row_add_equals_folded_tc():
    rng = np.random.default_rng(1)
    d = 64
    arrs = [_mk(rng, 4, d), _mk(rng, 4, d), _mk(rng, d, d), _mk(rng, d),
            np.ones(d, np.float32), _mk(rng, d), np.ones(d, np.float32), _mk(rng, d),
            _mk(rng, d, d), _mk(rng, d), _mk(rng, d, d), _mk(rng, d),
            _mk(rng, d, d), _mk(rng, d)]
    _, t = _both(arrs, bf16={2, 8, 10, 12})
    row = torch.from_numpy(_mk(rng, d))
    split = fused_stage(*t, row_add=row)
    folded = fused_stage(t[0] + row, *t[1:])
    np.testing.assert_allclose(split.numpy(), folded.numpy(), rtol=0, atol=0)


def test_bound_stage_and_head_equal_unbound():
    """bind_stage / bind_head (weights fixed once, as the sampler uses them)
    compute exactly what fused_stage / fused_head compute."""
    rng = np.random.default_rng(4)
    d, de, lat = 64, 32, 128
    arrs = [_mk(rng, 4, d), _mk(rng, 4, d), _mk(rng, d, d), _mk(rng, d),
            1 + _mk(rng, d), _mk(rng, d), 1 + _mk(rng, d), _mk(rng, d),
            _mk(rng, d, d), _mk(rng, d), _mk(rng, d, d), _mk(rng, d),
            _mk(rng, d, 2 * d), _mk(rng, 2 * d)]
    _, t = _both(arrs, bf16={2, 8, 10, 12})
    row = torch.from_numpy(_mk(rng, d))
    np.testing.assert_array_equal(bind_stage(*t[2:])(t[0], t[1], row_add=row).numpy(),
                                  fused_stage(*t, row_add=row).numpy())
    harrs = [_mk(rng, 4, d), _mk(rng, 4, de), _mk(rng, 4, de), _mk(rng, de, d), _mk(rng, d),
             _mk(rng, de, d), _mk(rng, d), 1 + _mk(rng, d), _mk(rng, d), _mk(rng, d, lat),
             _mk(rng, lat)]
    _, ht = _both(harrs, bf16={3, 5, 9})
    adds = dict(row_add=torch.from_numpy(_mk(rng, d)), rows_add=torch.from_numpy(_mk(rng, 4, d)))
    np.testing.assert_array_equal(bind_head(*ht[3:])(ht[0], ht[1], ht[2], **adds).numpy(),
                                  fused_head(*ht, **adds).numpy())


def test_plain_fused_head_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    b, dl, de, lat = 8, 128, 128, 128
    arrs = [_mk(rng, b, dl), _mk(rng, b, de), _mk(rng, b, de),
            _mk(rng, de, dl), _mk(rng, dl), _mk(rng, de, dl), _mk(rng, dl),
            1 + _mk(rng, dl), _mk(rng, dl), _mk(rng, dl, lat), _mk(rng, lat)]
    j, t = _both(arrs, bf16={3, 5, 9})
    ref = np.asarray(jax_fused_head(*j, interpret=True))
    got = fused_head(*t, eps=JAX_KERNEL_EPS).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_fast_denoiser_matches_flax(variant):
    kw = dict(latent_dim=128, hidden_dims=(128, 256, 128), time_emb_dim=128,
              num_classes=11)
    if variant == "v2":
        kw["global_skip"] = True
    if variant == "v3":
        kw.update(shared_cond_proj=False, num_colors=4)
    tree = init_numpy_params("denoiser", seed=1, **kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    t = np.array([0, 10, 100, 500, 999, 1, 2, 3], np.int32)
    c = (np.arange(8) % 11).astype(np.int32)
    col = (np.arange(8) % 4).astype(np.int32)
    args = (x, t, c, col) if variant == "v3" else (x, t, c)
    ref = np.asarray(JaxDenoiser(**kw).apply(jax.tree.map(jnp.asarray, tree),
                                             *map(jnp.asarray, args)))
    fast = make_fast_denoiser(denoiser_from_params(tree, device="cpu", **kw))
    got = fast(*[torch.from_numpy(a if a.dtype == np.float32 else a.astype(np.int64))
                 for a in args]).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-2 * float(np.abs(ref).max()))


def test_philox_known_answers():
    """Random123's published Philox4x32-10 test vectors."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = philox4x32_10(torch.tensor([ctr[0]]), *ctr[1:], *key)
        assert tuple(int(v) for v in got) == want


def test_philox_normal_moments():
    z = philox_normal(200_000, step=3, key=(11, 22))
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - 1.0) < 0.01
    assert not torch.equal(z[:1000], philox_normal(1000, step=4, key=(11, 22)))


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_plain_reverse_step_matches_jax_p_sample(guided, clip):
    """reverse_step's twin == JAX p_sample fed the same eps combination and
    the same noise (the twin's Philox draws, passed as numpy)."""
    sched_j, sched_t = jax_schedule(50), linear_schedule(50)
    rng = np.random.default_rng(3)
    b, lat, s = 6, 16, 3.5
    x = rng.standard_normal((b, lat)).astype(np.float32)
    eps = rng.standard_normal((2 * b if guided else b, lat)).astype(np.float32)
    for t in (0, 1, 37):
        key = (5, 9)
        coefs = (float(sched_t.alpha[t]), float(sched_t.alpha_bar[t]), float(sched_t.beta[t]))
        got = reverse_step(torch.from_numpy(eps), torch.from_numpy(x), t, coefs,
                           guidance_scale=s if guided else None, clip_x0=clip, key=key)
        e = eps[b:] + s * (eps[:b] - eps[b:]) if guided else eps
        noise = philox_normal(b * lat, t, key).reshape(b, lat).numpy()
        ref = jax_p_sample(sched_j, jnp.asarray(x), jnp.full((b,), t, jnp.int32),
                           jnp.asarray(e), jnp.asarray(noise), clip)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_plain_reverse_step_noise_closed_form():
    """Zero eps from x = 0: x_{t-1} = x_t / sqrt(a_t) + sqrt(b_t) z_t, so
    the final variance follows v <- v / a_t + b_t (none added at t = 0)."""
    sched = linear_schedule(20)
    x = torch.zeros(64, 128)
    eps = torch.zeros_like(x)
    for t in range(19, -1, -1):
        coefs = (float(sched.alpha[t]), float(sched.alpha_bar[t]), float(sched.beta[t]))
        x = reverse_step(eps, x, t, coefs, key=(3, 4))
    v = 0.0
    for t in range(19, 0, -1):
        v = v / float(sched.alpha[t]) + float(sched.beta[t])
    v = v / float(sched.alpha[0])
    np.testing.assert_allclose(float(x.var()), v, rtol=0.1)
    assert abs(float(x.mean())) < 5 * (v / x.numel()) ** 0.5
