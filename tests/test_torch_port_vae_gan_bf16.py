"""flowerdiff_torch's VAE-GAN bf16 lane on the CPU against the JAX package:
one step's gradients within twice the reference's own bf16-to-f32 gap
(inputs and helpers: torch_port_vae_gan_common.py).
"""
import jax
import numpy as np
import torch

from torch_port_vae_gan_common import (  # noqa: F401 (fixtures)
    COMMON,
    VAEGANConfig,
    _batches,
    _leaves,
    _port,
    _reference_steps,
    _rel,
    _t,
    gates_array,
    jax_init,
    no_dropout,
    state_dict_to_flax,
    vae_gan_loss_gates,
    vgg_pair,
)


def test_vae_gan_bf16_step_is_within_twice_the_reference_gap(jax_init, vgg_pair, no_dropout):
    """compute_dtype='bfloat16', one step with every gate on: the port's
    gradients against the reference's bf16 gradients, within twice the
    reference's own bf16-to-f32 gap (the relative global norm, the
    generator's and the discriminator's apart). The gradients are read from
    Adam's first moments after the step, mu = (1 - b1) g on both sides (the
    generator's after its clip). Torch autocast rounds at other places than
    flax's dtype (norm outputs stay f32), so the two bf16 runs agree only to
    bf16's own scale. (Losses after more steps are no measure: D's Adam
    steps of size lr on rounding-noise gradients make them scatter.) The
    losses are finite; parameters and moments stay f32."""
    batches = _batches(1, seed=12)
    refs = {dt: _reference_steps(jax_init, vgg_pair, batches, (200,), dt)
            for dt in ("float32", "bfloat16")}
    eps = refs["float32"][2]
    cfg = VAEGANConfig(compute_dtype="bfloat16", **COMMON)
    state, vae, disc, body = _port(jax_init, vgg_pair[1], cfg=cfg)
    (imgs, labels), = batches
    m = body(state, _t(imgs), _t(labels).long(), gates_array(vae_gan_loss_gates(200, 300)),
             draws=(_t(eps[0]), (None, None)))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert all(t.dtype == torch.float32 for t in state.tensors())
    port = {"gen": state_dict_to_flax(dict(zip(state.gen.names, state.gen.mu)), module=vae),
            "disc": state_dict_to_flax(dict(zip(state.disc.names, state.disc.mu)), module=disc)}
    for part in ("gen", "disc"):
        ref32, ref16 = (dict(_leaves(jax.tree.map(np.asarray, refs[dt][0].gen.opt_state[1][0].mu
                                                  if part == "gen" else
                                                  refs[dt][0].disc.opt_state[0].mu)))
                        for dt in ("float32", "bfloat16"))
        got = dict(_leaves(port[part]))
        names = sorted(ref32)
        scale = float(np.sqrt(sum(np.sum(ref32[k] ** 2) for k in names)))
        gap = _rel([ref16[k] for k in names], [ref32[k] for k in names], scale)
        dist = _rel([got[k] for k in names], [ref16[k] for k in names], scale)
        assert 0 < gap < 1 and dist <= 2 * gap, (part, dist, gap)
