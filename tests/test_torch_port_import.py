"""The port's importer and exporter of the original repository's checkpoints
(flowerdiff_torch/utils/torch_import.py and its two tools) against the JAX
package's (flowerdiff/utils/torch_import.py).

The original repository's modules are the reference-named torch modules of
tests/test_torch_import.py (its key names, its forward passes), imported
from there. Held here:
  - per model, the port's import of a seeded state dict is bit-equal, key
    for key, to the JAX import followed by the port's weight bridge
    (utils/weights.load_*), and its used / skipped / approximated keys and
    aux equal the JAX ImportResult's;
  - the port's module forward matches the reference module's (f32, rtol and
    atol 1e-5, with the reference's norms at the epsilon both packages use,
    1e-6; at the reference's own 1e-5 within the JAX test's 2e-4);
  - the port's export of its module has the JAX export's keys and arrays
    (of the bridged tree), synthesised zeros included, and loads strictly
    into the reference module;
  - both tools end to end, and `service_from_run` over the imported run.
"""
import numpy as np
import pytest
import torch

import test_torch_import as ref
from flowerdiff.utils import torch_import as jti
from flowerdiff_torch.models.discriminator import Discriminator64
from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
from flowerdiff_torch.models.pixel_unet import PixelUNet
from flowerdiff_torch.models.vae import FlowerVAE
from flowerdiff_torch.utils import torch_import as pti
from flowerdiff_torch.utils.weights import (
    load_denoiser,
    load_discriminator,
    load_pixel_unet,
    load_vae,
    state_dict_to_flax,
)
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
PORT_EPS = 1e-6  # flax's LayerNorm / GroupNorm epsilon, the JAX package's and the port's
HIDDEN = (8, 16, 32, 16, 8)
T_EMB = 16


def _perturbed(module, seed):
    """The module with every parameter and buffer moved off its init, so a
    swapped or dropped tensor shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.is_floating_point():
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
    return module


def _autoencoder(seed=0):
    torch.manual_seed(seed)
    tm = _perturbed(ref.SimpleAutoencoder().eval(), seed)
    with torch.no_grad():
        tm.center_counts.copy_(torch.arange(ref.NUM_CLASSES, dtype=torch.float32))
    return tm


def _port_vae():
    return FlowerVAE(latent_dim=ref.LATENT, num_classes=ref.NUM_CLASSES, channels=ref.CH,
                     head_width=ref.HEAD, base_size=ref.BASE).eval()


def _unet(dual, seed=0):
    torch.manual_seed(seed)
    return _perturbed(ref.ConditionalUNet(ref.LATENT, list(HIDDEN), T_EMB, ref.NUM_CLASSES,
                                          num_colors=5 if dual else None).eval(), seed)


def _port_denoiser(dual):
    return ConditionalLatentDenoiser(
        latent_dim=ref.LATENT, hidden_dims=HIDDEN, time_emb_dim=T_EMB,
        num_classes=ref.NUM_CLASSES, num_colors=5 if dual else None,
        shared_cond_proj=not dual, dropout_rate=0.0).eval()


def _assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = torch.as_tensor(got[k]), torch.as_tensor(np.asarray(want[k]))
        assert a.shape == b.shape, k
        assert torch.equal(a.to(b.dtype), b), k


def _assert_audit_equal(port, jax_res):
    for name in ("used", "skipped", "approximated"):
        assert set(getattr(port, name)) == set(getattr(jax_res, name)), name
        assert len(getattr(port, name)) == len(getattr(jax_res, name)), name


def _set_eps(module, eps):
    for m in module.modules():
        if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            m.eps = eps
    return module


# ---------------------------------------------------------------------------
# import: bit-equal to the JAX import through the bridge, the same audit
# ---------------------------------------------------------------------------
def test_autoencoder_import_equals_jax_through_the_bridge():
    sd = _autoencoder().state_dict()
    got, want = pti.import_autoencoder(sd), jti.import_autoencoder(sd)
    _assert_sd_equal(got.params, load_vae(_port_vae(), want.params).state_dict())
    _assert_audit_equal(got, want)
    assert set(got.aux) == set(want.aux)
    for k, v in want.aux.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got.aux[k].numpy(), v)
        else:
            assert got.aux[k] == v, k
    assert got.unused_keys(sd) == [] and len(got.used) == len(sd)
    _port_vae().load_state_dict(got.params, strict=True)


def test_discriminator_import_equals_jax_through_the_bridge():
    torch.manual_seed(1)
    sd = _perturbed(ref.TorchDiscriminator64(), 1).state_dict()
    got, want = pti.import_discriminator(sd), jti.import_discriminator(sd)
    bridged = load_discriminator(Discriminator64(device="cpu"), want.params).state_dict()
    _assert_sd_equal(got.params, bridged)
    _assert_audit_equal(got, want)
    assert got.aux == want.aux == {}
    assert sorted(got.approximated) == sorted(f"model.{i}.{p}" for i in (3, 6, 9)
                                              for p in ("weight", "bias"))
    assert got.unused_keys(sd) == []


@pytest.mark.parametrize("dual", [False, True], ids=["v1_shared", "v3_dual"])
def test_denoiser_import_equals_jax_through_the_bridge(dual):
    sd = _unet(dual, seed=2).state_dict()
    got, want = pti.import_latent_denoiser(sd), jti.import_latent_denoiser(sd)
    _assert_sd_equal(got.params, load_denoiser(_port_denoiser(dual), want.params).state_dict())
    _assert_audit_equal(got, want)
    assert got.aux == want.aux
    dead = [k for k in sd if k.startswith(("time_projections.4.", "cond_projections.4.",
                                           "attention_layers.4."))]
    assert sorted(got.skipped) == sorted(dead) and len(dead) == (8 if dual else 6)


@pytest.mark.parametrize("residual", [False, True], ids=["v4", "v5_res"])
def test_pixel_import_equals_jax_through_the_bridge(residual):
    torch.manual_seed(3)
    sd = _perturbed(ref.TorchSimpleUNet(learnable_residual=residual).eval(), 3).state_dict()
    got, want = pti.import_pixel_unet(sd), jti.import_pixel_unet(sd)
    port = PixelUNet(base_channels=8, time_emb_dim=16, learnable_residual=residual)
    _assert_sd_equal(got.params, load_pixel_unet(port, want.params).state_dict())
    _assert_audit_equal(got, want)
    assert got.aux == want.aux
    assert got.skipped == [] and got.approximated == []


# ---------------------------------------------------------------------------
# forward: the port's module against the reference-named torch module
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("eps, tol", [(PORT_EPS, TOL), (None, ref.TOL)],
                         ids=["port_eps", "reference_eps"])
def test_autoencoder_forward_matches_the_reference_module(eps, tol):
    tm = _autoencoder(seed=4)
    if eps is not None:
        _set_eps(tm, eps)
    model = _port_vae()
    model.load_state_dict(pti.import_autoencoder(tm.state_dict()).params, strict=True)
    x = np.random.RandomState(1).rand(2, ref.IMG, ref.IMG, 3).astype(np.float32)
    with torch.no_grad():
        tmu, tlogvar = tm.encoder(torch.tensor(x.transpose(0, 3, 1, 2)))
        mu, logvar = model.encode_with_params(torch.tensor(x))
        np.testing.assert_allclose(mu.numpy(), tmu.numpy(), **tol)
        np.testing.assert_allclose(logvar.numpy(), np.clip(tlogvar.numpy(), -2.0, 10.0), **tol)
        np.testing.assert_allclose(model.decode(tmu).numpy(),
                                   tm.decoder(tmu).numpy().transpose(0, 2, 3, 1), **tol)
        np.testing.assert_allclose(model.classify(tmu).numpy(), tm.classifier(tmu).numpy(), **tol)


@pytest.mark.parametrize("eps, tol", [(PORT_EPS, TOL), (None, ref.TOL)],
                         ids=["port_eps", "reference_eps"])
@pytest.mark.parametrize("dual", [False, True], ids=["v1_shared", "v3_dual"])
def test_denoiser_forward_matches_the_reference_module(dual, eps, tol):
    tm = _unet(dual, seed=5)
    if eps is not None:
        _set_eps(tm, eps)
    model = _port_denoiser(dual)
    model.load_state_dict(pti.import_latent_denoiser(tm.state_dict()).params, strict=True)
    rs = np.random.RandomState(2)
    x = torch.tensor(rs.randn(3, ref.LATENT).astype(np.float32))
    t = torch.tensor([0, 250, 999])
    c = torch.tensor([0, 3, ref.NUM_CLASSES - 1])
    color = torch.tensor([0, 2, 4]) if dual else None
    with torch.no_grad():
        want = tm(x, t.float(), c, *((color,) if dual else ()))
        got = model(x, t, c, color)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


@pytest.mark.parametrize("residual", [False, True], ids=["v4", "v5_res"])
def test_pixel_forward_matches_the_reference_module(residual):
    torch.manual_seed(6)
    tm = _perturbed(ref.TorchSimpleUNet(learnable_residual=residual).eval(), 6)
    model = PixelUNet(base_channels=8, time_emb_dim=16, learnable_residual=residual).eval()
    model.load_state_dict(pti.import_pixel_unet(tm.state_dict()).params, strict=True)
    x = np.random.RandomState(12).rand(2, 16, 16, 3).astype(np.float32)
    t = torch.tensor([0, 999])
    with torch.no_grad():
        want = tm(torch.tensor(x.transpose(0, 3, 1, 2)), t).numpy().transpose(0, 2, 3, 1)
        got = model(torch.tensor(x), t).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# export: the JAX export's keys and arrays, strict-loadable by the reference
# ---------------------------------------------------------------------------
def _export_case(kind):
    """(port module, port export, JAX export of the bridged tree, a fresh
    reference module)."""
    if kind == "autoencoder":
        model = _perturbed(_port_vae(), 7)
        rs = np.random.RandomState(0)
        centers = rs.randn(ref.NUM_CLASSES, ref.LATENT).astype(np.float32)
        counts = np.arange(ref.NUM_CLASSES, dtype=np.float32)
        return (model, pti.export_autoencoder(model, torch.tensor(centers), torch.tensor(counts)),
                jti.export_autoencoder(state_dict_to_flax(model), centers, counts),
                ref.SimpleAutoencoder())
    if kind == "discriminator":
        model = _perturbed(Discriminator64(device="cpu"), 8)
        return (model, pti.export_discriminator(model),
                jti.export_discriminator(state_dict_to_flax(model)), ref.TorchDiscriminator64())
    if kind in ("v1_shared", "v3_dual"):
        dual = kind == "v3_dual"
        model = _perturbed(_port_denoiser(dual), 9)
        return (model, pti.export_latent_denoiser(model),
                jti.export_latent_denoiser(state_dict_to_flax(model)),
                ref.ConditionalUNet(ref.LATENT, list(HIDDEN), T_EMB, ref.NUM_CLASSES,
                                    num_colors=5 if dual else None))
    residual = kind == "v5_res"
    model = _perturbed(PixelUNet(base_channels=8, time_emb_dim=16,
                                 learnable_residual=residual), 10)
    return (model, pti.export_pixel_unet(model), jti.export_pixel_unet(state_dict_to_flax(model)),
            ref.TorchSimpleUNet(learnable_residual=residual))


# The 0-d parameters, which the JAX writer stores with shape (1,)
# (np.ascontiguousarray of a 0-d array) and the port with the reference's
# own shape (): torch's load_state_dict takes either.
SCALARS = ("residual_weight", "res_ratio")


@pytest.mark.parametrize("kind", ["autoencoder", "discriminator", "v1_shared", "v3_dual", "v4",
                                  "v5_res"])
def test_export_equals_jax_export_of_the_bridged_tree(kind):
    model, got, want, tm = _export_case(kind)
    for k in SCALARS:
        if k in want.params:
            assert want.params[k].shape == (1,) and got.params[k].shape == ()
            want.params[k] = want.params[k].reshape(())
    _assert_sd_equal(got.params, want.params)
    for k, v in want.params.items():
        assert got.params[k].dtype == torch.as_tensor(np.asarray(v)).dtype, k
    _assert_audit_equal(got, want)
    tm.load_state_dict(got.params, strict=True)
    # import(export(m)) == m, bit for bit, the approximations included
    back = {"autoencoder": pti.import_autoencoder, "discriminator": pti.import_discriminator,
            "v4": pti.import_pixel_unet, "v5_res": pti.import_pixel_unet}.get(
        kind, pti.import_latent_denoiser)(tm.state_dict())
    _assert_sd_equal(back.params, model.state_dict())


def test_load_torch_file_reads_both_layouts(tmp_path):
    ae, disc = _autoencoder(), ref.TorchDiscriminator64()
    torch.save({"autoencoder": ae.state_dict(), "discriminator": disc.state_dict()},
               tmp_path / "flower_autoencoder.pt")
    torch.save(ae.state_dict(), tmp_path / "raw.pt")
    both = pti.load_torch_file(str(tmp_path / "flower_autoencoder.pt"))
    raw = pti.load_torch_file(str(tmp_path / "raw.pt"))
    assert set(both) == {"autoencoder", "discriminator"}
    _assert_sd_equal(both["autoencoder"], ae.state_dict())
    _assert_sd_equal(raw, ae.state_dict())
    assert all(torch.is_tensor(v) for v in raw.values())
    assert both["discriminator"]["model.3.num_batches_tracked"].dtype == torch.int64


def test_audit_counts_at_the_flagship_topology():
    """The used / skipped / approximated counts of a v1 export -> import
    (the three models' key sets depend on the topology, not the widths) are
    those chip_smoke.py's import phase gates on at full width."""
    import chip_smoke

    vae = FlowerVAE(latent_dim=8, num_classes=5, channels=(4, 8, 16, 32), head_width=16)
    den = ConditionalLatentDenoiser(latent_dim=8, hidden_dims=(8, 16, 32, 16, 8),
                                    time_emb_dim=8, num_classes=5)
    counts = {}
    for name, fn, sd in (
            ("autoencoder", pti.import_autoencoder, pti.export_autoencoder(vae).params),
            ("discriminator", pti.import_discriminator,
             pti.export_discriminator(Discriminator64(device="cpu")).params),
            ("denoiser", pti.import_latent_denoiser, pti.export_latent_denoiser(den).params)):
        res = fn(sd)
        counts[name] = (len(res.used), len(res.skipped), len(res.approximated))
    assert counts == chip_smoke.IMPORT_COUNTS == {
        "autoencoder": (132, 0, 0), "discriminator": (16, 9, 6), "denoiser": (76, 6, 0)}


# ---------------------------------------------------------------------------
# the tools, end to end
# ---------------------------------------------------------------------------
def _exported_tiny_v1(tmp_path):
    """A tiny v1 generator, discriminator and denoiser from seeds, written in
    the original layout: (paths, the port state dicts, the centers)."""
    from flowerdiff_torch.configs import get_preset, tiny_preset
    from flowerdiff_torch.train.latent_ddpm import create_latent_diffusion_state
    from flowerdiff_torch.train.vae_gan import create_vae_gan_state

    preset = tiny_preset(get_preset("v1"))
    _, vae, disc = create_vae_gan_state(11, preset.vae, device="cpu")
    _, den, _ = create_latent_diffusion_state(12, preset.latent, device="cpu")
    for m, seed in ((vae, 13), (disc, 14), (den, 15)):
        _perturbed(m, seed)
    centers = torch.randn((preset.vae.num_classes, preset.vae.latent_dim),
                          generator=torch.Generator().manual_seed(16))
    ae_pt, den_pt = tmp_path / "flower_autoencoder.pt", tmp_path / "conditional_diffusion_epoch_7.pt"
    torch.save({"autoencoder": pti.export_autoencoder(vae, centers).params,
                "discriminator": pti.export_discriminator(disc).params}, ae_pt)
    torch.save(pti.export_latent_denoiser(den).params, den_pt)
    return ae_pt, den_pt, vae.state_dict(), disc.state_dict(), den.state_dict(), centers


def _import_tiny(monkeypatch, argv):
    """The import tool's main at the preset's tiny widths: its
    `get_preset` answers `tiny_preset` of the preset for this one call."""
    from flowerdiff_torch import configs
    from flowerdiff_torch.tools import import_torch_checkpoint

    full = configs.get_preset
    with monkeypatch.context() as m:
        m.setattr(configs, "get_preset", lambda name: configs.tiny_preset(full(name)))
        return import_torch_checkpoint.main(argv)


def test_tools_round_trip_a_tiny_v1_run_and_the_service_serves_it(tmp_path, monkeypatch,
                                                                    capsys):
    from flowerdiff_torch.serving import service_from_run
    from flowerdiff_torch.tools import export_torch_checkpoint
    from flowerdiff_torch.train.checkpoints import CheckpointManager

    monkeypatch.setenv("FLOWERDIFF_PLATFORM", "cpu")
    ae_pt, den_pt, vae_sd, disc_sd, den_sd, centers = _exported_tiny_v1(tmp_path)
    out = tmp_path / "run"
    results = _import_tiny(monkeypatch, ["--preset", "v1", "--out", str(out), "--autoencoder",
                                         str(ae_pt), "--diffusion", str(den_pt)])
    assert f"--results_dir {out} --raw_latents" in capsys.readouterr().out
    assert {k: (len(r.used), len(r.skipped), len(r.approximated)) for k, r in results.items()} \
        == {"autoencoder": (132, 0, 0), "discriminator": (16, 9, 6), "denoiser": (48, 6, 0)}

    # the checkpoints: the source weights bit for bit, at the JAX tool's stamps
    vae_ckpt, diff_ckpt = (CheckpointManager(str(out / d)) for d in ("ckpt_vae", "ckpt_diffusion"))
    assert vae_ckpt.latest_step() == 1 and diff_ckpt.latest_step() == 7
    tree = vae_ckpt.restore_host()
    _assert_sd_equal(tree["gen"]["params"], vae_sd)
    _assert_sd_equal(tree["disc"]["params"], disc_sd)  # the GN affine round-trips via BN
    np.testing.assert_array_equal(tree["centers"], centers.numpy())
    _assert_sd_equal(diff_ckpt.restore_host()["params"], den_sd)

    # the export tool writes the original layout back
    exp = tmp_path / "exported"
    written = export_torch_checkpoint.main(["--preset", "v1", "--results_dir", str(out),
                                            "--out", str(exp)])
    assert sorted(written) == ["autoencoder", "denoiser"]
    got, want = pti.load_torch_file(written["autoencoder"]), pti.load_torch_file(str(ae_pt))
    assert set(got) == set(want) == {"autoencoder", "discriminator"}
    for name in want:
        _assert_sd_equal(got[name], want[name])
    _assert_sd_equal(pti.load_torch_file(written["denoiser"]), pti.load_torch_file(str(den_pt)))
    assert written["denoiser"].endswith("conditional_diffusion_epoch_7.pt")

    # the run directory serves: the imported VAE decodes the service's latents
    svc = service_from_run(str(out), version="v1", tiny=True, synthetic_size=16, buckets=(4,),
                           device="cpu")
    _assert_sd_equal({k: v for k, v in svc.vae.state_dict().items()}, vae_sd)
    _assert_sd_equal(svc.model.state_dict(), den_sd)
    imgs = svc.sample([1, 2, 3], seed=0)
    assert imgs.shape == (3, 64, 64, 3) and np.isfinite(imgs).all()


def test_import_tool_reference_width_denoiser_and_pixel_round_trip(tmp_path, monkeypatch):
    """At the presets' full widths, as tests/test_torch_import.py drives the
    JAX tools: a v1 ConditionalUNet and a v5 SimpleUNet through import and
    export, bit-equal but for the zero-filled dead tails; the pixel run
    served by pixel_service_from_run after a tiny import."""
    from flowerdiff_torch.tools import export_torch_checkpoint, import_torch_checkpoint

    monkeypatch.setenv("FLOWERDIFF_PLATFORM", "cpu")
    torch.manual_seed(9)
    unet = ref.ConditionalUNet(256, [256, 512, 1024, 512, 256], 256, 102).eval()
    pix = ref.TorchSimpleUNet(base_channels=64, time_emb_dim=128, learnable_residual=True)
    torch.save(unet.state_dict(), tmp_path / "conditional_diffusion_epoch_77.pt")
    torch.save(pix.state_dict(), tmp_path / "diffusion_unet_pixels.pth")
    out, exp = tmp_path / "run", tmp_path / "exported"
    import_torch_checkpoint.main(["--preset", "v1", "--out", str(out), "--diffusion",
                                  str(tmp_path / "conditional_diffusion_epoch_77.pt")])
    import_torch_checkpoint.main(["--preset", "v5", "--out", str(out / "px"), "--pixel",
                                  str(tmp_path / "diffusion_unet_pixels.pth")])
    export_torch_checkpoint.main(["--preset", "v1", "--results_dir", str(out), "--out", str(exp)])
    export_torch_checkpoint.main(["--preset", "v5", "--results_dir", str(out / "px"),
                                  "--out", str(exp)])
    back = torch.load(exp / "conditional_diffusion_epoch_77.pt", weights_only=True)
    assert set(back) == set(unet.state_dict())
    for k, v in unet.state_dict().items():
        if k.startswith(("time_projections.4.", "attention_layers.4.")):
            assert not back[k].any(), k
        else:
            assert torch.equal(back[k], v), k
    _assert_sd_equal(torch.load(exp / "diffusion_unet_pixels.pth", weights_only=True),
                     pix.state_dict())
    # the geometry checks exit as the JAX tool's do
    with pytest.raises(SystemExit, match="does not match preset"):
        import_torch_checkpoint.main(["--preset", "v3", "--out", str(out), "--diffusion",
                                      str(tmp_path / "conditional_diffusion_epoch_77.pt")])
    with pytest.raises(SystemExit, match="v5 has the learnable residual"):
        import_torch_checkpoint.main(["--preset", "v4", "--out", str(out), "--pixel",
                                      str(tmp_path / "diffusion_unet_pixels.pth")])
    with pytest.raises(SystemExit, match="no pixel pipeline"):
        import_torch_checkpoint.main(["--preset", "v1", "--out", str(out), "--pixel",
                                      str(tmp_path / "diffusion_unet_pixels.pth")])


def test_tiny_pixel_import_is_served(tmp_path, monkeypatch):
    from flowerdiff_torch.serving import pixel_service_from_run

    monkeypatch.setenv("FLOWERDIFF_PLATFORM", "cpu")
    torch.manual_seed(10)
    pix = _perturbed(ref.TorchSimpleUNet(learnable_residual=False), 10)
    torch.save(pix.state_dict(), tmp_path / "diffusion_unet_pixels_epoch_3.pth")
    _import_tiny(monkeypatch, ["--preset", "v4", "--out", str(tmp_path / "run"), "--pixel",
                               str(tmp_path / "diffusion_unet_pixels_epoch_3.pth")])
    svc = pixel_service_from_run(str(tmp_path / "run"), version="v4", tiny=True, buckets=(2,),
                                 device="cpu")
    _assert_sd_equal(svc.model.state_dict(), pti.import_pixel_unet(pix.state_dict()).params)
    imgs = svc.sample_images(1, seed=0)
    assert imgs.shape == (1, 64, 64, 3) and 0.0 <= imgs.min() and imgs.max() <= 1.0
