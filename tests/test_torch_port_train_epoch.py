"""flowerdiff_torch's whole-epoch train function on the CPU (its plain twin,
`mega_epoch_plain`) against the JAX package's `make_mega_epoch_fn`, whose
Pallas kernel runs in interpret mode off the TPU, and against the port's own
per-step chain. Weights, latents and labels are made with numpy from a seed;
timesteps, noise, keep-mask and dropout masks are drawn here with the
reference's per-step key scheme (`train_epoch.py:365-394`) and injected into
both sides. The CUDA kernels are held against the twin on the card
(chip_smoke.py, tests/test_torch_port_cuda.py).

Limits, f32 lane (the reference tests' own, tests/test_train_epoch_kernel.py):
losses rtol 1e-4 / atol 1e-5; parameters and mu rtol 2e-3 / atol 2e-5 (5e-4 at
the medium width, where near-zero second moments amplify the summation
order through Adam's division); nu rtol 2e-3 / atol 1e-7; step equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.kernels.train_epoch import _adam_state, _replace_adam
from flowerdiff.kernels.train_epoch import make_mega_epoch_fn as jax_make_mega
from flowerdiff.train.latent_ddpm import LatentDiffusionConfig as JaxConfig
from flowerdiff.train.latent_ddpm import create_latent_diffusion_state as jax_create_state
from flowerdiff_torch.kernels import train_epoch as te
from flowerdiff_torch.kernels import train_step as ts
from flowerdiff_torch.train.latent_ddpm import (
    LatentDiffusionConfig,
    create_latent_diffusion_state,
)
from flowerdiff_torch.utils.weights import (
    adam_moments_to_flax,
    init_numpy_params,
    load_adam_moments,
    state_dict_to_flax,
)

TINY = dict(latent_dim=16, hidden_dims=(32, 64, 32), time_emb_dim=16, num_classes=7, n_steps=50)
MEDIUM = dict(latent_dim=64, hidden_dims=(128, 256, 128), time_emb_dim=64, num_classes=26,
              n_steps=100)
F32 = dict(loss=dict(rtol=1e-4, atol=1e-5), w=dict(rtol=2e-3, atol=2e-5),
           nu=dict(rtol=2e-3, atol=1e-7))
HEADS = 8


@dataclasses.dataclass(frozen=True)
class Run:
    """One configuration run through the JAX epoch function: S steps of B."""
    net: dict = dataclasses.field(default_factory=lambda: TINY)
    steps: int = 3
    batch: int = 8
    lane: str = "float32"
    moments: str = "float32"
    start: int = 0           # optimizer step the epoch starts at (moments are then nonzero)
    cfg: tuple = ()          # extra config fields


RUNS = {
    "cond_dropout": Run(cfg=(("dropout_rate", 0.0), ("cond_dropout", 0.2))),
    "dropout": Run(cfg=(("dropout_rate", 0.3), ("cond_dropout", 0.2))),
    # a decay large enough to see, a start inside an SGDR period with nonzero
    # moments, and an EMA copy: one reference run, three cases read it
    "optimizer": Run(start=7, cfg=(("dropout_rate", 0.0), ("weight_decay", 1e-2),
                                   ("ema_decay", 0.9), ("t0", 2))),
    "bf16_moments": Run(moments="bfloat16", cfg=(("dropout_rate", 0.3),)),
    "bf16_lane": Run(lane="bfloat16", moments="bfloat16", cfg=(("dropout_rate", 0.3),)),
    # the global skip adds x_t to the output: the last width equals the latent's
    "v2": Run(net=dict(TINY, latent_dim=32), cfg=(("dropout_rate", 0.3), ("global_skip", True))),
    "medium": Run(net=MEDIUM, steps=2, batch=16,
                  cfg=(("dropout_rate", 0.0), ("cond_dropout", 0.1))),
}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _config_fields(run: Run) -> dict:
    return dict(run.net, steps_per_epoch=run.steps, **dict(run.cfg))


def _inputs(run: Run):
    """Weights (nonzero biases: flax's zeros would hide a dropped term),
    latents, labels and, for a start past step 0, Adam moments whose q and k
    blocks are zero, as training leaves them."""
    net = {k: v for k, v in run.net.items() if k != "n_steps"}
    net["global_skip"] = dict(run.cfg).get("global_skip", False)
    rng = np.random.default_rng(1)
    params = init_numpy_params("denoiser", seed=2, bias_std=0.1, **net)["params"]
    z = rng.standard_normal((run.steps, run.batch, net["latent_dim"])).astype(np.float32)
    labels = rng.integers(0, net["num_classes"], (run.steps, run.batch)).astype(np.int32)
    mu = nu = None
    if run.start:
        mu = jax.tree.map(lambda p: (0.01 * rng.standard_normal(p.shape)).astype(np.float32),
                          params)
        nu = jax.tree.map(lambda p: (1e-4 * rng.random(p.shape) + 1e-6).astype(np.float32),
                          params)
        for tree in (mu, nu):
            for name, leaf in tree.items():
                if name.startswith("attn_"):
                    d = leaf["qkv"]["kernel"].shape[0]
                    leaf["qkv"]["kernel"][:, :2 * d] = 0.0
                    leaf["qkv"]["bias"][:2 * d] = 0.0
    return params, z, labels, mu, nu


def _reference_draws(rng, run: Run, cfg, count0: int):
    """t, eps, keep and the masks of every step, drawn as the reference's
    test lane draws them inside `epoch_fn`."""
    hidden = run.net["hidden_dims"]
    n_masks = 2 * (len(hidden) - 1)
    rate, b = cfg.dropout_rate, run.batch
    t_all, eps_all, keep_all = [], [], []
    masks = [[] for _ in range(n_masks)]
    for i in range(run.steps):
        step_key = jax.random.fold_in(jax.random.fold_in(rng, i), count0 + i)
        _, loss_rng, drop_rng, cfg_rng = jax.random.split(step_key, 4)
        t_key, eps_key = jax.random.split(loss_rng)
        t_all.append(jax.random.randint(t_key, (b,), 0, cfg.n_steps))
        eps_all.append(jax.random.normal(eps_key, (b, cfg.latent_dim)))
        if cfg.cond_dropout > 0.0:
            keep_all.append(jax.random.bernoulli(cfg_rng, 1.0 - cfg.cond_dropout, (b,)))
        else:
            keep_all.append(jnp.ones((b,)))
        mkeys = jax.random.split(drop_rng, n_masks)
        scale = 1.0 / (1.0 - rate) if rate > 0 else 1.0
        for si, dim in enumerate(hidden[:-1]):
            if rate > 0.0:
                mb = jax.random.bernoulli(mkeys[2 * si], 1.0 - rate, (b, dim))
                ma = jnp.repeat(jax.random.bernoulli(mkeys[2 * si + 1], 1.0 - rate, (b, HEADS)),
                                dim // HEADS, axis=1)
                mb, ma = mb.astype(jnp.float32) * scale, ma.astype(jnp.float32) * scale
            else:
                mb = ma = jnp.ones((b, dim), jnp.float32)
            masks[2 * si].append(mb)
            masks[2 * si + 1].append(ma)

    def stack(xs, dtype=np.float32):
        return torch.from_numpy(np.stack([np.asarray(x) for x in xs]).astype(dtype))

    return (stack(t_all, np.int64), stack(eps_all), stack(keep_all), [stack(m) for m in masks])


def _jax_epoch(run: Run):
    """The reference's epoch, and the draws it made: a dict of numpy results."""
    cfg = JaxConfig(**_config_fields(run))
    params, z, labels, mu, nu = _inputs(run)
    state, model, sched = jax_create_state(jax.random.key(0), cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=jparams)
    if cfg.ema_decay is not None:
        state = state.replace(ema_params=jparams)
    if run.start:
        adam = _adam_state(state.opt_state)._replace(
            count=jnp.asarray(run.start, jnp.int32), mu=jax.tree.map(jnp.asarray, mu),
            nu=jax.tree.map(jnp.asarray, nu))
        state = state.replace(step=run.start, opt_state=_replace_adam(state.opt_state, adam))
    rng = jax.random.key(5)
    mega = jax_make_mega(model, cfg, run.steps, run.batch, dtype=_JDT[run.lane],
                         stochastic=False, moments_dtype=_JDT[run.moments])
    new, losses = mega(state, sched, jnp.asarray(z), jnp.asarray(labels), rng)
    adam = _adam_state(new.opt_state)

    def to_numpy(tree):
        return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)

    return dict(losses=np.asarray(losses), params=to_numpy(new.params), mu=to_numpy(adam.mu),
                nu=to_numpy(adam.nu), count=int(adam.count), step=int(new.step),
                ema=None if cfg.ema_decay is None else to_numpy(new.ema_params),
                draws=_reference_draws(rng, run, cfg, run.start))


def _port_state(run: Run, **over):
    cfg = LatentDiffusionConfig(**dict(_config_fields(run), **over))
    params, z, labels, mu, nu = _inputs(run)
    state, model, sched = create_latent_diffusion_state(0, cfg, device="cpu",
                                                        params={"params": params})
    if run.start:
        load_adam_moments(state, mu, nu, run.start)
    return cfg, state, model, sched, torch.from_numpy(z), torch.from_numpy(labels)


def _port_epoch(run: Run, draws, tables=None, **over):
    """The port's epoch on the same inputs: a dict shaped like `_jax_epoch`'s."""
    cfg, state, model, sched, z, labels = _port_state(run, **over)
    if tables is None:
        epoch_fn = te.make_mega_epoch_fn(model, cfg, run.steps, run.batch, dtype=_TDT[run.lane],
                                         stochastic=False, moments_dtype=_TDT[run.moments])
        losses = epoch_fn(state, sched, z, labels, draws=draws)
    else:
        losses, _ = te.mega_epoch_plain(state, sched, z, labels, draws, dtype=_TDT[run.lane],
                                        moments_dtype=_TDT[run.moments], tables=tables)
    mu, nu, count = adam_moments_to_flax(state)
    return dict(losses=losses.numpy(), params=state_dict_to_flax(model), mu=mu, nu=nu,
                count=count, step=state.step,
                ema=None if state.ema is None else state_dict_to_flax(state.ema_params))


@pytest.fixture(scope="module")
def epochs():
    """name -> (reference results, port results), each computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            ref = _jax_epoch(RUNS[name])
            cache[name] = (ref, _port_epoch(RUNS[name], ref["draws"]))
        return cache[name]

    return get


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _close(got, ref, rtol, atol):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert set(got) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, rtol=rtol, atol=atol, err_msg=name)


def _over(got, ref, rtol, atol):
    """The largest |got - ref| / (atol + rtol |ref|) over every leaf: above 1
    the trees are outside the limit."""
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    return max(float(np.max(np.abs(got[k] - r) / (atol + rtol * np.abs(r))))
               for k, r in ref.items())


def _rel_to_leaf_max(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    return max(float(np.abs(got[k] - r).max() / (np.abs(r).max() + 1e-30))
               for k, r in ref.items())


@pytest.mark.parametrize("name,w_atol", [("cond_dropout", 2e-5), ("dropout", 2e-5),
                                         ("v2", 2e-5), ("medium", 5e-4)])
def test_f32_epoch_matches_the_jax_epoch(epochs, name, w_atol):
    """Losses, every parameter, both moments and the step count after one
    epoch, in the f32 lane with f32 moments."""
    ref, got = epochs(name)
    np.testing.assert_allclose(got["losses"], ref["losses"], **F32["loss"])
    assert got["step"] == ref["step"] == got["count"] == ref["count"] == RUNS[name].steps
    _close(got["params"], ref["params"], rtol=2e-3, atol=w_atol)
    _close(got["mu"], ref["mu"], rtol=2e-3, atol=w_atol)
    if name != "medium":  # the reference's medium test leaves nu out, for the same reason
        _close(got["nu"], ref["nu"], **F32["nu"])


def test_epoch_from_a_later_step_matches_the_jax_epoch(epochs):
    """A start at step 7 with nonzero moments: the lr table follows the SGDR
    curve from step 7 and the bias corrections are 1 - b^(8..10)."""
    ref, got = epochs("optimizer")
    np.testing.assert_allclose(got["losses"], ref["losses"], **F32["loss"])
    assert got["step"] == ref["step"] == got["count"] == ref["count"] == 10
    _close(got["params"], ref["params"], **F32["w"])
    _close(got["mu"], ref["mu"], **F32["w"])
    _close(got["nu"], ref["nu"], **F32["nu"])


def test_qk_decay_matches_the_jax_epoch(epochs):
    """q and k never see a gradient but AdamW decays them: the factor
    applied after the epoch follows optax's per-step decay to rtol 1e-5."""
    ref, got = epochs("optimizer")
    start = _inputs(RUNS["optimizer"])[0]["attn_0"]["qkv"]["kernel"][:, :64]
    qk_ref = ref["params"]["attn_0"]["qkv"]["kernel"][:, :64]
    qk_got = got["params"]["attn_0"]["qkv"]["kernel"][:, :64]
    assert not np.allclose(qk_ref, start)  # the decay moved them
    np.testing.assert_allclose(qk_got, qk_ref, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got["params"]["attn_1"]["qkv"]["bias"][:128],
                               ref["params"]["attn_1"]["qkv"]["bias"][:128], rtol=1e-5, atol=1e-8)


def test_epoch_granular_ema_matches_the_jax_epoch(epochs):
    """One blend with decay^S toward the epoch-end weights, not S blends."""
    ref, got = epochs("optimizer")
    _close(got["ema"], ref["ema"], **F32["w"])
    start, end = _inputs(RUNS["optimizer"])[0], got["params"]
    keep = 0.9 ** 3
    one_blend = jax.tree.map(lambda e, p: keep * e + (1 - keep) * p, start, end)
    _close(got["ema"], one_blend, rtol=1e-6, atol=1e-7)


def test_bf16_moments_match_the_jax_epoch(epochs):
    """f32 lane, moments stored in bf16 between the steps. Both sides round
    nearly equal f32 values to bf16, so a stored moment may land one bf16 ulp
    apart (2^-8 of its value, 2^-7 at the bottom of a binade); the update
    uses the unrounded moment, so parameters keep the f32 limits with the
    absolute part widened to 1e-4: one ulp of a stored moment through Adam's
    division at lr 1e-3."""
    ref, got = epochs("bf16_moments")
    np.testing.assert_allclose(got["losses"], ref["losses"], **F32["loss"])
    _close(got["params"], ref["params"], rtol=2e-3, atol=1e-4)
    _close(got["mu"], ref["mu"], rtol=2.0 ** -7, atol=2e-5)
    _close(got["nu"], ref["nu"], rtol=2.0 ** -7, atol=1e-7)
    for _, leaf in _leaves(got["mu"]):  # what the state holds is bf16-representable
        t = torch.from_numpy(leaf)
        assert torch.equal(t, t.to(torch.bfloat16).float())


def test_bf16_lane_matches_the_jax_epoch(epochs):
    """bf16 products, bf16 moments. Both sides round the same operands and
    gradients to bf16 but sum in another order, so a gradient may land a bf16
    ulp apart (tests/test_torch_port_train_kernel.py: 2e-2 of a leaf's
    largest). Moments are compared the same way. Adam divides the first
    moment by the root of the second, so where a gradient is near zero its
    rounding decides the sign of a step of size lr: single weights may differ
    by 2 lr a step, 6e-3 here, and the limit on the parameters is on the
    mean over a leaf, 5% of lr S."""
    ref, got = epochs("bf16_lane")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=5e-3)
    assert got["step"] == ref["step"] == 3
    assert _rel_to_leaf_max(got["mu"], ref["mu"]) <= 2e-2
    assert _rel_to_leaf_max(got["nu"], ref["nu"]) <= 4e-2
    lr_s = 1e-3 * 3
    g, r = dict(_leaves(got["params"])), dict(_leaves(ref["params"]))
    for name in r:
        assert np.abs(g[name] - r[name]).max() <= 2 * lr_s + 1e-6, name
        assert np.abs(g[name] - r[name]).mean() <= 0.05 * lr_s, name


def test_grad_is_bf16_names_the_bf16_lane_s_rounded_gradients():
    """In the bf16 lane the twin's gradients of the leaves `_grad_is_bf16`
    names are bf16 values (the cast's vjp rounds them), the others are not."""
    run = RUNS["bf16_lane"]
    cfg, state, model, sched, z, labels = _port_state(run)
    draws = te.epoch_draws(model, cfg, sched, run.steps, run.batch, 3, 0)
    data = ts.step_data(sched, z[0], labels[0], draws[0][0].long(), draws[1][0], draws[2][0],
                        ts.sinusoid_freqs(model.time_emb_dim))
    _, grads = ts.twin_loss_and_grads(dict(ts.weights_spec(model)), data,
                                      [m[0] for m in draws[3]], dtype=torch.bfloat16)
    names = [k for k in grads if te._grad_is_bf16(k)]
    assert len(names) == 6 + 5 * model.n_stages + 2 and "wf" not in names and "table" in names
    for k, g in grads.items():
        representable = torch.equal(g, g.to(torch.bfloat16).float())
        assert representable == (te._grad_is_bf16(k) or k == "rw"), k


def test_twin_epoch_equals_the_per_step_chain():
    """The epoch twin against the port's own per-step path
    (`make_kernel_denoise_body` + `LatentTrainState.apply_gradients`, the
    chain held against optax in tests/test_torch_port_train.py) on the same
    draws from the same start, without an EMA: losses rtol 1e-5, weights and
    mu to the f32 limits (the chain's bias corrections are Python doubles,
    the epoch's f32), q and k included."""
    run = dataclasses.replace(RUNS["dropout"], cfg=(("dropout_rate", 0.3), ("cond_dropout", 0.2),
                                                    ("weight_decay", 1e-2)))
    cfg, state, model, sched, z, labels = _port_state(run)
    draws = te.epoch_draws(model, cfg, sched, run.steps, run.batch, 11, 0)
    epoch = _port_epoch(run, draws)
    body = ts.make_kernel_denoise_body(model, cfg, dtype=torch.float32)
    losses = [float(body(state, sched, z[i], labels[i], None,
                         draws=(draws[0][i].long(), draws[1][i], draws[2][i],
                                [m[i] for m in draws[3]]))) for i in range(run.steps)]
    np.testing.assert_allclose(epoch["losses"], losses, rtol=1e-5)
    assert state.step == epoch["step"] == run.steps
    _close(epoch["params"], state_dict_to_flax(model), **F32["w"])
    mu, nu, _ = adam_moments_to_flax(state)
    _close(epoch["mu"], mu, **F32["w"])
    _close(epoch["nu"], nu, **F32["nu"])


def test_epoch_fn_refuses_what_it_cannot_run():
    run = RUNS["dropout"]
    cfg, state, model, sched, z, labels = _port_state(run)
    v3 = dict(run.net, shared_cond_proj=False, num_colors=4)
    v3.pop("n_steps")
    _, v3_model, _ = create_latent_diffusion_state(
        0, LatentDiffusionConfig(**v3), device="cpu")
    with pytest.raises(ValueError, match="v1/v2"):
        te.make_mega_epoch_fn(v3_model, cfg, run.steps, run.batch)
    with pytest.raises(ValueError, match="lane"):
        te.make_mega_epoch_fn(model, cfg, run.steps, run.batch, dtype=torch.float16)
    injected = te.make_mega_epoch_fn(model, cfg, run.steps, run.batch, stochastic=False)
    with pytest.raises(ValueError, match="draws"):
        injected(state, sched, z, labels, 0)
    drawing = te.make_mega_epoch_fn(model, cfg, run.steps, run.batch, dtype=torch.float32)
    draws = te.epoch_draws(model, cfg, sched, run.steps, run.batch, 0, 0)
    with pytest.raises(ValueError, match="draws"):
        drawing(state, sched, z, labels, 0, draws=draws)
    with pytest.raises(ValueError, match="shape"):
        drawing(state, sched, z[:2], labels[:2], 0)
    assert state.step == 0
    # the same seed at the same step draws the same epoch; the next epoch differs
    first = drawing(state, sched, z, labels, torch.Generator().manual_seed(4))
    _, state2, _, _, _, _ = _port_state(run)
    again = te.make_mega_epoch_fn(state2.model, cfg, run.steps, run.batch, dtype=torch.float32)(
        state2, sched, z, labels, 4)
    assert torch.equal(first, again) and state.step == run.steps
    assert drawing.launches == 0  # no kernel was launched for CPU weights


@pytest.mark.parametrize("term", ["clip", "decay", "bias_correction", "constant_lr"])
def test_dropping_a_term_moves_the_twin_past_the_limits(term):
    """The f32 limits mean something: with a clip that binds, a decay that
    shows (lr wd S = 3e-2 of a weight against an rtol of 2e-3), a start at
    step 7 and an SGDR period of one epoch, the twin without any one term
    ends more than twice the limit away."""
    run = dataclasses.replace(RUNS["optimizer"], cfg=(
        ("dropout_rate", 0.0), ("lr", 1e-2), ("weight_decay", 1.0), ("grad_clip", 0.1),
        ("t0", 1)))
    cfg, state, model, sched, z, labels = _port_state(run)
    draws = te.epoch_draws(model, cfg, sched, run.steps, run.batch, 2, run.start)
    _, gnorms = te.mega_epoch_plain(state, sched, z, labels, draws, dtype=torch.float32)
    assert float(gnorms.min()) > 2 * cfg.grad_clip  # the clip binds at every step
    ref = _port_epoch(run, draws)
    tables = te.epoch_tables(state.schedule, run.start, run.steps)
    assert tables[0].max() > 2 * tables[0].min() and tables[2].max() < 0.02
    if term == "clip":
        got = _port_epoch(run, draws, grad_clip=float("inf"))
    elif term == "decay":
        got = _port_epoch(run, draws, weight_decay=0.0)
    elif term == "bias_correction":
        got = _port_epoch(run, draws, tables=np.stack([tables[0], np.ones(3), np.ones(3)]))
    else:
        got = _port_epoch(run, draws, tables=np.stack([np.full(3, tables[0, 0])] + list(tables[1:])))
    assert _over(got["params"], ref["params"], **F32["w"]) > 2.0


def test_adam_moments_bridge_round_trips():
    """mu, nu and the count into a state and back, leaf for leaf, the packed
    qkv included; a tree with other leaves is refused."""
    run = RUNS["optimizer"]
    params, _, _, mu, nu = _inputs(run)
    cfg, state, model, sched, z, labels = _port_state(dataclasses.replace(run, start=0))
    assert not any(bool(m.any()) for m in state.mu) and state.step == 0
    load_adam_moments(state, mu, nu, 7)
    assert state.step == 7
    d = model.attn_0.v.weight.shape[0]
    j = state.names.index("attn_0.v.weight")
    np.testing.assert_array_equal(state.mu[j].numpy(), mu["attn_0"]["qkv"]["kernel"][:, 2 * d:].T)
    assert not state.mu[state.names.index("attn_0.q.weight")].any()
    mu2, nu2, count = adam_moments_to_flax(state)
    assert count == 7
    _close(mu2, mu, rtol=0, atol=0)
    _close(nu2, nu, rtol=0, atol=0)
    with pytest.raises(ValueError, match="parameters"):
        load_adam_moments(state, {k: v for k, v in mu.items() if k != "final"}, nu, 7)
