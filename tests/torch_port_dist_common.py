"""Spawned gloo ranks for the port's multi-process CPU tests
(tests/test_torch_port_parallel*.py), and the work each rank does.

`start_ranks(fn, world, workdir, payload)` spawns `world` processes that
join one gloo group through a file under `workdir` (never a fixed TCP
port: the test workers run side by side), each with one thread, and call
`fn(rank, world, payload)`, a function of this module (it imports neither
JAX nor the JAX package, so a rank starts in seconds). Each rank's result is
saved under `workdir`; `join()` returns them in rank order and raises with
a rank's traceback if one failed. Start the ranks, do the test process's
own work (JAX, world size 1), then join.

The work functions take `mesh` as their first argument where the test
process calls them too with mesh=None, the one-process run.
"""
import copy
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn_name, world, workdir, payload, group):
    torch.set_num_threads(1)
    if group:
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                init_method="file://" + os.path.join(workdir, "rendezvous"))
    try:
        result = globals()[fn_name](rank, world, payload)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    def __init__(self, context, world, workdir):
        self.context, self.world, self.workdir = context, world, workdir

    def join(self, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        while not self.context.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in self.context.processes:
                    proc.kill()
                raise TimeoutError(f"{self.world} ranks still running after {timeout} s")
        return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


def start_ranks(fn, world: int, workdir, payload=None, group: bool = True) -> Ranks:
    """group=False: the ranks join no group themselves (`fn` does, e.g. the
    CLI from torchrun's environment)."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    context = mp.start_processes(_entry, args=(fn.__name__, world, workdir, payload, group),
                                 nprocs=world, join=False, start_method="spawn")
    return Ranks(context, world, workdir)


# ---------------------------------------------------------------------- #
# tests/test_torch_port_parallel.py
# ---------------------------------------------------------------------- #

DENOISER = dict(latent_dim=16, hidden_dims=(32, 64, 32), time_emb_dim=16, num_classes=7)
SAMPLER = dict(latent_dim=16, hidden_dims=(16, 32, 16), time_emb_dim=16, num_classes=5)


def denoiser_inputs(n: int = 8):
    rng = np.random.default_rng(0)
    z = rng.standard_normal((n, 16)).astype(np.float32)
    return z, np.arange(n), np.arange(n) % 7


def denoiser(kind: dict, seed: int):
    from flowerdiff_torch.models import ConditionalLatentDenoiser
    from flowerdiff_torch.utils.weights import init_numpy_params, load_denoiser

    model = ConditionalLatentDenoiser(dropout_rate=0.0, **kind)
    return load_denoiser(model, init_numpy_params("denoiser", seed=seed, **kind)).eval()


def tensor_parallel_forward(mesh):
    """The denoiser sharded over "model", each rank on its "data" rows, the
    rows gathered back: (output, block_fc_0's local weight shape)."""
    from flowerdiff_torch.parallel import (
        all_gather_rows,
        latent_denoiser_rules,
        local_rows,
        shard_params,
    )

    model = shard_params(denoiser(DENOISER, 1), mesh, latent_denoiser_rules())
    z, t, c = (torch.from_numpy(a) for a in denoiser_inputs())
    with torch.no_grad():
        out = model(local_rows(mesh, z), local_rows(mesh, t), local_rows(mesh, c))
    return all_gather_rows(mesh, out).numpy(), tuple(model.block_fc_0.weight.shape)


def data_parallel_gradient(mesh):
    """d/dw mean((x @ w)^2) over a 16-row global batch, each rank on its
    rows, averaged over the ranks."""
    from flowerdiff_torch.parallel import all_reduce_mean, local_rows

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32))
    w = torch.ones((8, 8), requires_grad=True)
    loss = torch.mean((local_rows(mesh, x) @ w) ** 2)
    (grad,) = torch.autograd.grad(loss, [w])
    return all_reduce_mean(mesh, [grad])[0].numpy()


def data_parallel_sample(mesh):
    """A 16-row request of 6 steps, its rows split over "data"."""
    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.diffusion.api import DiffusionSampler

    sampler = DiffusionSampler(denoiser(SAMPLER, 0), linear_schedule(6), (16,), device="cpu")
    classes = torch.arange(16) % 5
    return sampler.sample(16, classes, generator=torch.Generator().manual_seed(1),
                          mesh=mesh).numpy()


def parallel_probe(rank, world, _payload):
    """World 4: the mesh shapes and the raise, the 2x2 tensor-parallel
    forward, the data-parallel gradient and sampling over 4 data ranks.
    World 2: the 1x2 tensor-parallel forward."""
    from flowerdiff_torch.parallel import create_mesh

    if world == 2:
        return {"tp_1x2": tensor_parallel_forward(create_mesh(data=1, model=2))}
    out = {"shape_default": tuple(create_mesh().shape),
           "shape_2x2": tuple(create_mesh(data=2, model=2).shape)}
    try:
        create_mesh(data=3, model=2)
        out["raise_3x2"] = None
    except ValueError as exc:
        out["raise_3x2"] = str(exc)
    out["tp_2x2"] = tensor_parallel_forward(create_mesh(data=2, model=2))
    dp = create_mesh()
    out["grad"] = data_parallel_gradient(dp)
    out["sample"] = data_parallel_sample(dp)
    return out


# ---------------------------------------------------------------------- #
# tests/test_torch_port_parallel_train*.py
# ---------------------------------------------------------------------- #


def _leaf_arrays(tensors):
    return [t.detach().numpy().copy() for t in tensors]


def vae_gan_chunks(mesh, p):
    """The VAE-GAN fused chunk from the given weights, with the given
    (global) draws and from seed 3: metrics, the generator's parameters and
    every state tensor (the centers last); "init": the generator's initial
    parameters."""
    from flowerdiff_torch.models import FlowerVAE
    from flowerdiff_torch.train import fused
    from flowerdiff_torch.train.vae_gan import VAEGANConfig, create_vae_gan_state

    cfg = VAEGANConfig(**p["cfg"])
    images, labels = torch.from_numpy(p["images"]), torch.from_numpy(p["labels"]).long()
    idx, gates = torch.from_numpy(np.array(p["idx"])).long(), torch.from_numpy(p["gates"])
    out = {}
    for name, draws, seed in (("injected", p["draws"], 0), ("seeded", None, 3)):
        vae = FlowerVAE(num_classes=cfg.num_classes, latent_dim=cfg.latent_dim,
                        channels=cfg.channels, head_width=cfg.head_width)
        state, vae, disc = create_vae_gan_state(
            0, cfg, vae=vae, device="cpu", g_params={"params": copy.deepcopy(p["gp"])},
            d_params={"params": copy.deepcopy(p["dp"])})
        out["init"] = _leaf_arrays(state.gen.params)
        fn = fused.make_fused_vae_gan_epochs(vae, disc, cfg, None, steps_per_epoch=p["steps"],
                                             mesh=mesh)
        metrics = fn(state, images, labels, idx, gates, seed=seed, draws=draws)
        out[name] = ({k: v.numpy() for k, v in metrics.items()},
                     _leaf_arrays(state.gen.params), _leaf_arrays(state.tensors()))
    return out


def latent_steps(mesh, p):
    """The uncached latent steps through the port's parts (gather, encode,
    the denoise body) with the given global draws, and the fused per-step
    window from generator seed 8: losses and the state's tensors."""
    from flowerdiff_torch.models import FlowerVAE
    from flowerdiff_torch.parallel import local_rows
    from flowerdiff_torch.train import fused
    from flowerdiff_torch.train.latent_ddpm import (
        LatentDiffusionConfig,
        create_latent_diffusion_state,
        make_latent_denoise_body,
        make_latent_encode_fn,
    )
    from flowerdiff_torch.utils.weights import load_vae

    cfg = LatentDiffusionConfig(**p["cfg"])
    vae = load_vae(FlowerVAE(**p["vae_arch"]), p["vae_tree"]).eval()
    images, labels = torch.from_numpy(p["images"]), torch.from_numpy(p["labels"]).long()
    stats = tuple(map(torch.from_numpy, p["stats"]))
    out = {}
    state, model, sched = create_latent_diffusion_state(
        0, cfg, device="cpu", params={"params": copy.deepcopy(p["params"])})
    gather = fused._make_gather(True, 10.0, 0.2, mesh)
    encode, denoise = make_latent_encode_fn(vae), make_latent_denoise_body(model, cfg, mesh)
    losses = []
    for row, aug, noise, draws in zip(p["idx"], p["aug"], p["noise"], p["draws"]):
        row = torch.from_numpy(row).long()
        z = encode(gather(images, row, draws=aug), None, stats, noise=local_rows(mesh, noise))
        losses.append(float(denoise(state, sched, z, labels[local_rows(mesh, row)], None,
                                    draws=local_rows(mesh, draws))))
    out["injected"] = (np.asarray(losses), _leaf_arrays(state.params))

    state, model, sched = create_latent_diffusion_state(
        0, cfg, device="cpu", params={"params": copy.deepcopy(p["params"])})
    fn = fused.make_fused_latent_epochs(model, vae, sched, cfg, steps_per_epoch=p["steps"],
                                        mesh=mesh)
    losses = fn(state, images, labels, None, torch.from_numpy(np.stack(p["idx"])).long(),
                torch.Generator().manual_seed(8), stats)
    out["seeded"] = (losses.numpy(), _leaf_arrays(state.params))
    return out


def pixel_chunks(mesh, p):
    """The pixel fused chunk with the given global draws and from seed 3:
    losses and the parameters."""
    from flowerdiff_torch.train import fused
    from flowerdiff_torch.train.pixel_ddpm import (
        PixelDiffusionConfig,
        create_pixel_diffusion_state,
    )

    cfg = PixelDiffusionConfig(**p["cfg"])
    images, idx = torch.from_numpy(p["images"]), torch.from_numpy(np.array(p["idx"])).long()
    out = {}
    for name, draws, seed in (("injected", p["draws"], 0), ("seeded", None, 3)):
        state, model, sched = create_pixel_diffusion_state(0, cfg, device="cpu",
                                                           params=copy.deepcopy(p["tree"]))
        fn = fused.make_fused_pixel_epochs(model, steps_per_epoch=p["steps"], mesh=mesh)
        losses = fn(state, sched, images, idx, seed=seed, draws=draws)
        out[name] = (losses.numpy(), _leaf_arrays(state.params))
    return out


def pixel_loop(mesh, p):
    """Two pixel epochs epoch by epoch (`DeviceDataset.batches` on the mesh,
    `PixelDiffusionTrainer.run_epoch`): the losses and the parameters."""
    from flowerdiff_torch.data import DeviceDataset
    from flowerdiff_torch.train.pixel_ddpm import PixelDiffusionConfig, PixelDiffusionTrainer

    trainer = PixelDiffusionTrainer(PixelDiffusionConfig(**p["cfg"]), seed=0, device="cpu",
                                    params=copy.deepcopy(p["tree"]))
    dataset = DeviceDataset(p["images"], np.zeros(len(p["images"])), max_rotation_deg=0.0,
                            jitter=0.0, device="cpu", mesh=mesh)
    losses = [trainer.run_epoch(dataset.batches(e, 4), seed=e, mesh=mesh) for e in range(2)]
    return np.asarray(losses), _leaf_arrays(trainer.state.params)


def guards(mesh, p):
    """The messages the latent cache and the train-step kernel raise on
    the mesh (None where nothing raised)."""
    from flowerdiff_torch.data import DeviceDataset
    from flowerdiff_torch.models import FlowerVAE
    from flowerdiff_torch.train import fused
    from flowerdiff_torch.train.latent_ddpm import (
        LatentDiffusionConfig,
        LatentDiffusionTrainer,
        create_latent_diffusion_state,
    )

    cfg = LatentDiffusionConfig(**p["cfg"])
    vae = FlowerVAE(**p["vae_arch"])
    dataset = DeviceDataset(p["images"], p["labels"], device="cpu", mesh=mesh)
    out = {}
    try:
        trainer = LatentDiffusionTrainer(
            LatentDiffusionConfig(**dict(p["cfg"], latent_cache=2, normalize_latents=False)),
            vae, device="cpu")
        trainer.run_epochs_fused(dataset, 1, generator=torch.Generator().manual_seed(0),
                                 batch_size=4, mesh=mesh)
        out["cache"] = None
    except ValueError as exc:
        out["cache"] = str(exc)
    kcfg = LatentDiffusionConfig(**dict(p["cfg"], train_kernel=True, epoch_encode=True,
                                        train_kernel_dtype="float32"))
    _state, model, sched = create_latent_diffusion_state(0, kcfg, device="cpu")
    try:
        fused.make_fused_latent_epochs(model, vae, sched, kcfg, mesh=mesh)
        out["kernel"] = None
    except ValueError as exc:
        out["kernel"] = str(exc)
    return out


CHUNKS = {"vae_gan": vae_gan_chunks, "latent": latent_steps, "pixel": pixel_chunks,
          "pixel_loop": pixel_loop, "guards": guards}


def train_chunks(rank, world, payload):
    """Each chunk the payload names, on the world's mesh."""
    from flowerdiff_torch.parallel import create_mesh

    mesh = create_mesh()
    return {k: CHUNKS[k](mesh, p) for k, p in payload.items()}


def train_worlds(payload, tmp_path_factory, parent_work):
    """Spawn world size 2 and a one-rank group, run `parent_work()` (the
    JAX side) and the no-group run here meanwhile, then join: {"jax",
    "alone", "one", "two"}."""
    two = start_ranks(train_chunks, 2, tmp_path_factory.mktemp("two"), payload)
    one = start_ranks(train_chunks, 1, tmp_path_factory.mktemp("one"), payload)
    jax_out = parent_work()
    alone = {k: CHUNKS[k](None, p) for k, p in payload.items()}
    return dict(jax=jax_out, alone=alone, one=one.join(), two=two.join())


def assert_equal(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y)


def assert_close(a, b, rtol=5e-4, atol=1e-5):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------- #
# tests/test_torch_port_parallel_cli.py
# ---------------------------------------------------------------------- #


def torchrun_env(rank: int, world: int, port: int) -> dict:
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def cli_twice(rank, world, p):
    """`cli.main(argv)` twice (the run, then its resume) in torchrun's
    environment for this rank on the CPU: each call's standard output."""
    import contextlib
    import io

    from flowerdiff_torch import cli

    os.environ.update(torchrun_env(rank, world, p["port"]), FLOWERDIFF_PLATFORM="cpu")
    outs = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(p["argv"])
        outs.append(buf.getvalue())
    return outs


# ---------------------------------------------------------------------- #
# tests/test_torch_port_cuda.py (on the card)
# ---------------------------------------------------------------------- #


def card_tensor_parallel(rank, world, _payload):
    """A small denoiser on the one card, sharded at model=2 over gloo,
    against its replicated forward."""
    from flowerdiff_torch.parallel import create_mesh, latent_denoiser_rules, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    kind = dict(latent_dim=32, hidden_dims=(64, 128, 64), time_emb_dim=32, num_classes=10)
    replicated = denoiser(kind, 1).cuda()
    sharded = shard_params(denoiser(kind, 1).cuda(),
                           create_mesh(data=1, model=2, device_type="cuda"),
                           latent_denoiser_rules())
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((16, 32), generator=gen, device="cuda")
    t = torch.randint(0, 1000, (16,), generator=gen, device="cuda")
    c = torch.randint(0, 10, (16,), generator=gen, device="cuda")
    with torch.no_grad():
        ref, got = replicated(x, t, c), sharded(x, t, c)
    return {"rel_err": float((got - ref).abs().max() / ref.abs().max()),
            "local_block_fc_0": tuple(sharded.block_fc_0.weight.shape)}
