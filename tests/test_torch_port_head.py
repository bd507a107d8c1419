"""The head of the kernel sampler's step in its table form, on the CPU.

The port's sampler folds the head's time and condition projections into
tables before its loop (`prepare_fused_sampler`, `_cond_adds`), so its step
calls the head with no base products, the time add as one row (`row_add`)
and the condition adds as rows (`rows_add`; under guidance the null rows
carry the projection's bias alone). That is the form the column-tile kernel
(csrc/latent_head.cu) runs. Here the step's head, as the sampler binds it
(its plain twin on the CPU), is held against the JAX package's
`fused_head(..., interpret=True)` fed the base rows the tables were folded
from, with the model's nonzero biases. The card tests hold the kernel
against this twin (tests/test_torch_port_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.kernels.latent_stage import fused_head as jax_fused_head
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.kernels.full_sampler import _cond_adds, prepare_fused_sampler
from flowerdiff_torch.kernels.latent_stage import _mm
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

DEN = dict(latent_dim=64, hidden_dims=(64, 128, 96), time_emb_dim=64, num_classes=11)
STEPS = 50
# The JAX kernel rounds t_base and c_base to bf16 before their products; the
# port's tables are folded in f32, as the model computes them. That moves the
# LayerNorm's input by up to 2^-9 of each product term, so LayerNorm outputs
# near a bf16 rounding boundary round one ulp (2^-8 of themselves) the other
# way (the readings: 2e-3 to 3.3e-3 of max|ref|). Limit: 1e-2 of max|ref|.
REL = 1e-2
# With the tables folded by the JAX kernel's own rule (bf16 operands, `_mm`)
# only the order of f32 sums and the LayerNorm epsilon differ (the JAX
# kernel's 1e-5 against the model's 1e-6 moves an output by less than 5e-6
# of itself at unit variance; the readings: 1.1e-7 of max|ref|).
REL_SAME_FOLD = 2e-5


def _setup(seed):
    tree = init_numpy_params("denoiser", seed=seed, bias_std=0.5, **DEN)
    model = denoiser_from_params(tree, device="cpu", **DEN)
    return tree["params"], model, prepare_fused_sampler(model, linear_schedule(STEPS))


def _jax_head(p, h, t_base, c_base):
    bf = jnp.bfloat16
    return np.asarray(jax_fused_head(
        jnp.asarray(h), jnp.asarray(t_base), jnp.asarray(c_base),
        jnp.asarray(p["final_time_proj"]["kernel"], bf), jnp.asarray(p["final_time_proj"]["bias"]),
        jnp.asarray(p["final_cond_proj"]["kernel"], bf), jnp.asarray(p["final_cond_proj"]["bias"]),
        jnp.asarray(p["final_norm"]["scale"]), jnp.asarray(p["final_norm"]["bias"]),
        jnp.asarray(p["final"]["kernel"], bf), jnp.asarray(p["final"]["bias"]),
        interpret=True))


@torch.no_grad()
@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("b,t", [(1, 0), (3, 17), (8, 49)])
def test_sampler_head_table_form_matches_pallas_interpret(b, t, guided):
    p, model, prep = _setup(seed=31 + b)
    rows = 2 * b if guided else b
    rng = np.random.default_rng(b)
    h = rng.standard_normal((rows, DEN["hidden_dims"][-1])).astype(np.float32)
    cond = torch.from_numpy((np.arange(b) * 5 + 2) % DEN["num_classes"])
    _, final_add = _cond_adds(prep, cond, None, guided)
    row_add = prep["tadd_final"][t]
    got = prep["head"](torch.from_numpy(h), row_add=row_add, rows_add=final_add).numpy()
    t_row = model.time_emb(torch.tensor([t])).numpy()
    c_base = model.embed_condition(cond, None).numpy()
    t_base = np.repeat(t_row, rows, axis=0)
    if guided:  # the null rows: no condition, the projection's bias only
        c_base = np.concatenate([c_base, np.zeros_like(c_base)])
    ref = _jax_head(p, h, t_base, c_base)
    assert got.shape == ref.shape == (rows, DEN["latent_dim"])
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= REL * scale, (err, scale)
    bf16 = torch.bfloat16
    tw, cw = model.final_time_proj, model.final_cond_proj
    same_fold = prep["head"](
        torch.from_numpy(h), row_add=_mm(torch.from_numpy(t_row), tw.weight.to(bf16), tw.bias)[0],
        rows_add=_mm(torch.from_numpy(c_base), cw.weight.to(bf16), cw.bias)).numpy()
    assert float(np.abs(same_fold - ref).max()) <= REL_SAME_FOLD * scale
    # each add counts: the head without its time row or its condition rows
    # lies far outside the limit
    h_t = torch.from_numpy(h)
    for drop in (dict(rows_add=final_add), dict(row_add=row_add)):
        moved = prep["head"](h_t, **drop).numpy()
        assert float(np.abs(moved - ref).max()) > 5 * REL * scale, drop.keys()

