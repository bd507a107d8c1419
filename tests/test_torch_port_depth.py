"""Every denoiser depth and width the JAX kernels hold in VMEM, on the CPU.

The JAX sampler kernel (flowerdiff/kernels/full_sampler.py::_pallas_reverse)
holds every operand whole under `vmem_limit_bytes` = 100 MiB, and nothing
else bounds its depth or widths. Here: `jax_process_bytes` (the operands and
the output that `_pallas_reverse` hands to `pl.pallas_call`, at their JAX
dtypes, held against the call itself); the port's `process_plan` at every
bucket, guided or not, for denoisers at that edge (the deepest uniform nets
at widths 32, 64, 256 and 512, the widest one-stage net, the flagship's
shape with a 3456-wide middle, a ragged deep net, a deep v2 net); the
streamed layout's vector table; the residual-stream nets the card tests
sample past 8 stages, within the card's limit of a change of summation
order; the CPU kernel path (the twins) against
JAX's `fused_sample` in interpret mode at a 12-stage net (two-digit flax
names through the weight bridge) and at a 2112-wide stage; and the train
step's twin at 18 stages against `jax.grad` of JAX's `forward_loss`. The
kernels run at these shapes only on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowerdiff.kernels.full_sampler as jax_fs
from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.kernels.train_step import _nest as jax_nest
from flowerdiff.kernels.train_step import _weights_spec as jax_weights_spec
from flowerdiff.kernels.train_step import forward_loss as jax_forward_loss
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.diffusion.api import FusedDiffusionSampler
from flowerdiff_torch.kernels import latent_stage
from flowerdiff_torch.kernels import train_step as ts
from flowerdiff_torch.kernels.full_sampler import (
    MAX_RESIDENT_STAGES,
    MAX_WIDTH,
    ProcessOperands,
    bind_latent_proj,
    draw_request,
    launch_counts,
    prepare_fused_sampler,
    process_plan,
    process_smem,
    process_vec_floats,
    process_vec_table,
    process_widths,
    run_steps,
)
from flowerdiff_torch.kernels.latent_stage import SMEM_LIMIT
from flowerdiff_torch.serving import DEFAULT_BUCKETS
from flowerdiff_torch.utils.weights import (
    denoiser_from_params,
    init_numpy_params,
    residual_stream,
)

from torch_port_threads import one_thread_per_process  # noqa: F401

VMEM = 100 * 2**20  # the JAX kernel's vmem_limit_bytes
T = 1000            # every preset's schedule


def jax_process_bytes(latent, hidden, batch, n_steps):
    """Bytes of the operands and the output of the JAX kernel's pallas_call
    (`_pallas_reverse`, full_sampler.py:283-307): the seed, x_init (B, L), the
    three (T, 1) schedule columns, Wl and bl, per stage its (T, d) time adds,
    (B, d) condition adds, Wb bb g1 b1 g2 b2 Wv bv Wo bo Wd bd, then the head's
    (T, d) time adds, (B, d) condition adds, g, b, Wf, bf, and the (B, L)
    output; weights bf16, everything else f32 (the seed int32)."""
    n, f32, bf16 = len(hidden) - 1, 4, 2
    total = f32 + batch * latent * f32 + 3 * n_steps * f32
    total += latent * hidden[0] * bf16 + hidden[0] * f32
    for d, do in zip(hidden[:-1], hidden[1:]):
        total += (n_steps * d + batch * d + 7 * d + do) * f32 + (3 * d * d + d * do) * bf16
    dl = hidden[n]
    total += (n_steps * dl + batch * dl + 2 * dl + latent) * f32 + dl * latent * bf16
    return total + batch * latent * f32


def _den(latent, hidden, skip=False, te=None):
    return dict(latent_dim=latent, hidden_dims=tuple(hidden),
                time_emb_dim=te or (32 if latent <= 32 else 64), num_classes=11,
                shared_cond_proj=True, global_skip=skip)


@pytest.mark.parametrize("latent,hidden", [(24, (24, 40, 24)), (40, (48, 16, 96, 40))])
def test_jax_process_bytes_counts_what_the_pallas_call_is_handed(monkeypatch, latent, hidden):
    """The helper against the arrays `_pallas_reverse` passes to
    `pl.pallas_call` (traced with a stand-in that records them), guided."""
    seen = []

    def record(kernel, out_shape, **kw):
        def call(*args):
            seen.append(sum(a.size * a.dtype.itemsize for a in args)
                        + int(np.prod(out_shape.shape)) * out_shape.dtype.itemsize)
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return call

    monkeypatch.setattr(jax_fs.pl, "pallas_call", record)
    den = _den(latent, hidden)
    tree = init_numpy_params("denoiser", seed=1, **den)
    batch, steps = 3, 7
    jax_fs.fused_sample(JaxDenoiser(**den), jax.tree.map(jnp.asarray, tree),
                        jax_schedule(steps), jax.random.key(0), batch,
                        jnp.arange(batch) % 11, stochastic=False, interpret=True,
                        guidance_scale=2.0)
    assert seen == [jax_process_bytes(latent, hidden, batch, steps)]


def _deepest(width, batch):
    """The most stages of `width` (latent too) the JAX kernel holds at `batch`."""
    n = 1
    while jax_process_bytes(width, (width,) * (n + 2), batch, T) <= VMEM:
        n += 1
    return n


# (name, latent, hidden, skip): nets at the JAX kernel's edge
EDGE = ([(f"{n} stages of {w} (the JAX edge at {b})", w, (w,) * (n + 1), False)
         for w in (32, 64, 256, 512) for b in (8, 64, 512) for n in [_deepest(w, b)]]
        + [("one 2601-wide stage", 2601, (2601, 2601), False),
           ("the flagship's shape, 3456 in the middle", 256, (256, 512, 3456, 512, 256), False),
           ("ragged, 40 stages", 40, (48, 96, 200, 136) * 10 + (40,), False),
           ("v2, 200 stages of 64", 64, (64,) * 201, True)])


def test_the_edge_nets_are_at_the_jax_edge():
    """Each uniform net is the deepest the JAX kernel holds at its bucket
    (one stage more passes 100 MiB), and the table in ROADMAP.md holds."""
    for name, lat, hidden, _ in EDGE[:12]:
        b = int(name.rsplit(" ", 1)[1].rstrip(")"))
        assert jax_process_bytes(lat, hidden, b, T) <= VMEM < jax_process_bytes(
            lat, hidden + hidden[-1:], b, T), name
    assert [_deepest(64, b) for b in (8, 64, 512)] == [357, 340, 246]
    assert [_deepest(256, b) for b in (8, 64, 512)] == [66, 63, 49]
    assert [_deepest(512, b) for b in (8, 64, 512)] == [24, 23, 18]
    assert jax_process_bytes(2601, (2601, 2601), 64, T) <= VMEM
    assert jax_process_bytes(256, (256, 512, 3456, 512, 256), 64, T) <= VMEM


@pytest.mark.parametrize("name,latent,hidden,skip", EDGE, ids=[e[0] for e in EDGE])
def test_process_plan_takes_every_net_the_jax_kernel_holds(name, latent, hidden, skip):
    """At every bucket the services launch, guided or not, where the JAX
    kernel holds the net in 100 MiB: a plan, in shared memory, each width
    padded by less than a unit; streamed past MAX_RESIDENT_STAGES stages."""
    taken = 0
    for batch in DEFAULT_BUCKETS:
        if jax_process_bytes(latent, hidden, batch, T) > VMEM:
            continue
        for guided in (True, False):
            plan = process_plan(latent, hidden, skip, batch, guided)
            lat_p, hid_p = process_widths(latent, hidden, plan.cols)
            assert plan.smem == process_smem(lat_p, hid_p, skip, plan.cols, plan.rows,
                                             plan.qbufs, plan.slots, plan.streamed)
            assert plan.smem <= SMEM_LIMIT
            assert plan.streamed or len(hidden) - 1 <= MAX_RESIDENT_STAGES
            rows = batch * (2 if guided else 1)
            assert plan.clusters * plan.rows >= rows
            for w, p in zip((latent, *hidden), (lat_p, *hid_p)):
                assert w <= p < w + max(64, 8 * plan.cols) and p // plan.cols <= 256
            taken += 1
    assert taken >= 2  # at least the 8 bucket, guided and not


def test_the_port_names_its_bound_past_4096():
    """A net the JAX kernel holds only because its other widths are narrow:
    a last hidden width past 4096. The port takes it up to the JAX edge
    (25,706 at the 8 bucket, on the wide layout); past MAX_WIDTH, which no
    last width the JAX kernel holds at any batch reaches, it refuses one,
    naming the bound."""
    assert jax_process_bytes(8, (8, 8, 6000), 8, T) <= VMEM
    assert (jax_process_bytes(8, (8, 8, 25706), 8, T) <= VMEM
            < jax_process_bytes(8, (8, 8, 25707), 8, T))
    assert process_plan(8, (8, 8, 25706), False, 8, True).wide
    assert jax_process_bytes(8, (8, 8, MAX_WIDTH + 1), 1, T) > VMEM
    with pytest.raises(ValueError, match=str(MAX_WIDTH)):
        process_plan(8, (8, 8, MAX_WIDTH + 1), False, 8, True)


def test_streamed_vector_table_holds_each_blocks_slices_in_resident_order():
    """Row c of the streamed vector table is what block c loads into shared
    memory in the resident layout: bl, each stage's bb g1 b1 g2 b2 bv bo bd,
    the head's g, b, bf, each its c-th slice of width / cols."""
    cols, lat, hidden = 4, 64, (64, 128, 64)
    gen = torch.Generator().manual_seed(0)

    def v(d):
        return torch.randn(d, generator=gen)
    stages = tuple((torch.zeros(3, hidden[i]),
                    tuple(v(hidden[i]) for _ in range(7)) + (v(hidden[i + 1]),))
                   for i in range(len(hidden) - 1))
    fixed = (v(hidden[0]), None, torch.zeros(3, hidden[-1]), v(hidden[-1]), v(hidden[-1]), v(lat))
    ops = ProcessOperands(lat, hidden, (), fixed, stages)
    table = process_vec_table(ops, cols)
    assert table.shape == (cols, process_vec_floats(lat, hidden, cols))
    order = ([fixed[0]] + [x for _, vecs in stages for x in vecs]
             + [fixed[3], fixed[4], fixed[5]])
    for c in range(cols):
        want = torch.cat([x[c * x.numel() // cols:(c + 1) * x.numel() // cols] for x in order])
        assert torch.equal(table[c], want)
    # streamed, the vectors and adds take no shared memory
    assert (process_smem(lat, hidden, False, cols, 16, 2, 4)
            - process_smem(lat, hidden, False, cols, 16, 2, 4, streamed=True)
            == -(-table.shape[1] * 4 // 16) * 16 + 16 * sum(hidden) // cols * 4)


def _f64_sums(a, w, b):
    """`latent_stage._mm` with its sums in another order (f64, then f32), as
    the card's products take theirs in another order than the host's."""
    return (a.to(torch.bfloat16).double() @ w.double().t()).float() + b


def test_residual_stream_keeps_a_deep_net_within_the_samplers_limit(monkeypatch):
    """`residual_stream` (the card tests' deep nets): each square stage's
    downsample a permutation of its own (no two stages alike) and its bias
    scaled by 1/sqrt(stages), its branches scaled by 1/sqrt(stages); its
    12-stage v2 net's 20-step guided sample moves by less than the card's
    PROCESS_TOL (3e-2 of max|x|) when the twins' products sum in another
    order, and leaving out the noise, the last stage's condition add, CFG,
    the clip or the skip, or swapping two stages' downsamples, moves it by
    more than twice that."""
    den = _den(64, (64,) * 13, skip=True)
    plain = init_numpy_params("denoiser", seed=3, bias_std=0.3, **den)
    tree = residual_stream(init_numpy_params("denoiser", seed=3, bias_std=0.3, **den))
    p0, p1 = plain["params"], tree["params"]
    np.testing.assert_array_equal(p1["downsample_11"]["kernel"], np.eye(64, dtype=np.float32)[
        np.argsort(p0["downsample_11"]["kernel"][0])])
    np.testing.assert_allclose(p1["downsample_11"]["bias"],
                               p0["downsample_11"]["bias"] / 12 ** 0.5, rtol=1e-6)
    for i in range(11):  # a stage given another stage's downsample would show
        assert not np.array_equal(p1[f"downsample_{i}"]["kernel"],
                                  p1[f"downsample_{i + 1}"]["kernel"])
        assert not np.array_equal(p1[f"downsample_{i}"]["bias"], p1[f"downsample_{i + 1}"]["bias"])
    np.testing.assert_allclose(p1["attn_3"]["out"]["kernel"],
                               p0["attn_3"]["out"]["kernel"] / 12 ** 0.5, rtol=1e-6)
    prep = prepare_fused_sampler(denoiser_from_params(tree, device="cpu", **den),
                                 linear_schedule(20))
    inputs = draw_request(prep, 8, torch.arange(8) % 11, None, torch.Generator().manual_seed(31),
                          None, True)
    kw = dict(stochastic=True, clip_x0=3.0, guidance_scale=7.0)
    ref = run_steps(prep, inputs, **kw)
    tol = 3e-2 * float(ref.abs().max())
    with monkeypatch.context() as m:
        m.setattr(latent_stage, "_mm", _f64_sums)
        other = run_steps(prep, inputs, **kw)
    assert 0 < float((other - ref).abs().max()) <= tol
    adds = list(inputs.stage_adds)
    adds[-1] = torch.zeros_like(adds[-1])
    wl, bl = prep["proj"].weights[:2]
    swapped = copy.deepcopy(tree)
    q = swapped["params"]
    q["downsample_6"], q["downsample_7"] = q["downsample_7"], q["downsample_6"]
    swapped = prepare_fused_sampler(denoiser_from_params(swapped, device="cpu", **den),
                                    linear_schedule(20))
    for out in (run_steps(swapped, inputs, **kw),
                run_steps(prep, inputs, **dict(kw, stochastic=False)),
                run_steps(prep, inputs._replace(stage_adds=tuple(adds)), **kw),
                run_steps(prep, inputs, **dict(kw, guidance_scale=1.0)),
                run_steps(prep, inputs, **dict(kw, clip_x0=None)),
                run_steps(dict(prep, proj=bind_latent_proj(wl, bl)), inputs, **kw)):
        assert float((out - ref).abs().max()) > 2 * tol


# The CPU kernel path against the JAX kernel in interpret mode
STEPS, BATCH, SCALE, CLIP = 5, 4, 2.0, 3.0
JAX_TOL = 3e-2  # tests/test_torch_port_widths.py's, relative to max|JAX|


def _models(den):
    tree = init_numpy_params("denoiser", seed=5, bias_std=0.3, **den)
    # The JAX kernel's null rows drop the condition projections' biases,
    # the port's keep them (the model's rule): zero them on both sides.
    n = len(den["hidden_dims"]) - 1
    for name in [f"time_proj_{i}" for i in range(n)] + ["final_cond_proj"]:
        tree["params"][name]["bias"] = np.zeros_like(tree["params"][name]["bias"])
    model = denoiser_from_params(tree, device="cpu", **den)
    jden = {k: v for k, v in den.items() if k != "global_skip"}
    return model, JaxDenoiser(**jden), jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("latent,hidden", [(32, (32,) * 13), (64, (64, 2112, 64))],
                         ids=["12 stages of 32", "a 2112-wide stage"])
def test_cpu_kernel_path_matches_jax_fused_sample(latent, hidden):
    model, jmodel, jparams = _models(_den(latent, hidden))
    # the bridge put each flax leaf where its name says, two-digit ones too
    assert torch.equal(model.stage("time_proj", len(hidden) - 2).weight.t(),
                       torch.from_numpy(np.array(
                           jparams["params"][f"time_proj_{len(hidden) - 2}"]["kernel"])))
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((BATCH, latent)).astype(np.float32)
    cond = (np.arange(BATCH) * 3) % 11
    ref = np.asarray(jax_fs.fused_sample(jmodel, jparams, jax_schedule(STEPS),
                                         jax.random.key(0), BATCH, jnp.asarray(cond),
                                         stochastic=False, interpret=True,
                                         x_init=jnp.asarray(x0), clip_x0=CLIP,
                                         guidance_scale=SCALE))
    sampler = FusedDiffusionSampler(model, linear_schedule(STEPS), (latent,), clip_x0=CLIP,
                                    guidance_scale=SCALE, device="cpu")
    before = launch_counts()
    got = sampler.sample(BATCH, torch.from_numpy(cond), x_init=torch.from_numpy(x0),
                         stochastic=False).numpy()
    assert launch_counts() == before, "the plain version launched a kernel"
    assert got.shape == ref.shape == (BATCH, latent) and np.isfinite(got).all()
    assert float(np.abs(got - ref).max()) <= JAX_TOL * float(np.abs(ref).max())
    # and the card has a plan for it at both buckets
    for batch in (8, 64):
        plan = process_plan(latent, hidden, False, batch, True)
        assert plan.streamed == (len(hidden) - 1 > MAX_RESIDENT_STAGES)


# The train step's twin at 18 stages against jax.grad of JAX's forward_loss
B, DEPTH, WIDTH = 8, 18, 16
F32_TOL = dict(rtol=5e-4, atol=1e-6)  # tests/test_torch_port_train_kernel.py's
BF16_REL = 2e-2


def _train_case(seed=0):
    kw = _den(WIDTH, (WIDTH,) * (DEPTH + 1), te=16)
    kw["num_classes"] = 7
    rng = np.random.default_rng(seed)
    tree = init_numpy_params("denoiser", seed=seed + 1, bias_std=0.3, **kw)
    for leaf in tree["params"].values():
        if "scale" in leaf:
            leaf["scale"] = (leaf["scale"] + 0.2 * rng.standard_normal(leaf["scale"].shape)
                             ).astype(np.float32)
    sched = linear_schedule(50)
    t = rng.integers(0, 50, B)
    abar = sched.alpha_bar.numpy()[t][:, None]
    half = kw["time_emb_dim"] // 2
    data = {
        "z": rng.standard_normal((B, WIDTH)).astype(np.float32),
        "t_f": t.astype(np.float32)[:, None],
        "sa": np.sqrt(abar).astype(np.float32),
        "s1a": np.sqrt(1.0 - abar).astype(np.float32),
        "eps": rng.standard_normal((B, WIDTH)).astype(np.float32),
        "labels": rng.integers(0, 7, B).astype(np.int32),
        "cond_mask": np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)[:, None],
        "freqs": np.exp(np.arange(half, dtype=np.float32)
                        * np.float32(-np.log(10000.0) / (half - 1))).reshape(1, half),
    }
    masks = []
    for d in kw["hidden_dims"][:-1]:
        mb = (rng.random((B, d)) >= 0.3).astype(np.float32) / 0.7
        ma = (rng.random((B, 8)) >= 0.3).astype(np.float32) / 0.7
        masks += [mb, np.repeat(ma, d // 8, axis=1)]
    return kw, tree, data, masks


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_train_twin_at_18_stages_matches_jax(lane):
    kw, tree, data, masks = _train_case()
    jdt, tdt = (jnp.float32, torch.float32) if lane == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    named = dict(jax_weights_spec(jax.tree.map(jnp.asarray, tree), DEPTH))
    full = {k: jnp.asarray(v) for k, v in data.items() if k != "labels"}
    full["onehot"] = jax.nn.one_hot(jnp.asarray(data["labels"]), 7, dtype=jnp.float32)
    full.update(m_blk=[jnp.asarray(m) for m in masks[0::2]],
                m_attn=[jnp.asarray(m) for m in masks[1::2]])
    ref_loss, ref = jax.value_and_grad(lambda w: jax_forward_loss(
        jax_nest(w, DEPTH), full, n_stages=DEPTH, dtype=jdt, global_skip=False))(named)
    model = denoiser_from_params(tree, device="cpu", **kw)
    spec = dict(ts.weights_spec(model))
    # the leaf order: stage i's leaves at i, whatever the flax names sort to
    assert list(spec) == list(named)
    loss, grads = ts.kernel_loss_and_grads(
        spec, {k: torch.from_numpy(v) for k, v in data.items()},
        [torch.from_numpy(m) for m in masks], dtype=tdt, global_skip=False)
    assert len(grads) == 11 + 14 * DEPTH + 9
    np.testing.assert_allclose(float(loss), float(ref_loss),
                               rtol=1e-5 if lane == "float32" else 2e-3)
    for name, r in ref.items():
        r = np.asarray(r)
        g = grads[name].numpy()
        got = g if name == "table" else g.T if g.ndim == 2 else g.reshape(1, -1)
        assert got.shape == r.shape, name
        if lane == "float32":
            np.testing.assert_allclose(got, r, err_msg=name, **F32_TOL)
        else:
            assert np.abs(got - r).max() <= BF16_REL * np.abs(r).max() + 1e-9, name
