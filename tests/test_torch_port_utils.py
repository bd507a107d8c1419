"""flowerdiff_torch's presets, loss history, image helpers, quality metrics
and profiling hooks on the CPU, against the JAX package where it has a
counterpart: every preset field by field (tiny and bf16 variants
included), `LossHistory` files read by either package, `psnr`, `to_uint8`
and `normalize_latents`, each quality function on the same arrays (an
even-sized MMD pool, whose median is the mean of the two middle values,
and an equal `fd_stamp` for the same weights), and the trace, span and
NaN / Inf hooks."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff import configs as jconfigs
from flowerdiff.train.metrics import LossHistory as JaxLossHistory
from flowerdiff.utils import image as jimage
from flowerdiff.utils import quality as jq
from flowerdiff_torch import configs
from flowerdiff_torch.train.metrics import LossHistory
from flowerdiff_torch.utils import image, profiling
from flowerdiff_torch.utils import quality as q


# ------------------------------------------------------------------ presets


@pytest.mark.parametrize("name", sorted(jconfigs.PRESETS))
@pytest.mark.parametrize("variant", ["plain", "tiny", "bf16", "tiny_bf16"])
def test_presets_match_the_reference_field_by_field(name, variant):
    """Every field of every preset, and of its VAE-GAN, latent and pixel
    configurations, equal to the reference's (the port's configuration
    classes have the reference's fields and defaults)."""
    def shape(preset, mod):
        if "tiny" in variant:
            preset = mod.tiny_preset(preset)
        if "bf16" in variant:
            preset = mod.bf16_preset(preset)
        return dataclasses.asdict(preset)

    got = shape(configs.get_preset(name), configs)
    want = shape(jconfigs.get_preset(name), jconfigs)
    assert got == want
    assert [f.name for f in dataclasses.fields(configs.VersionPreset)] == \
        [f.name for f in dataclasses.fields(jconfigs.VersionPreset)]


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown version"):
        configs.get_preset("v9")
    assert sorted(configs.PRESETS) == sorted(jconfigs.PRESETS)


# ------------------------------------------------------------------ history


def test_loss_history_round_trips_between_the_packages(tmp_path):
    """A history with a key that starts late: the port's JSONL has the
    reference's bytes (values by position in each key's list, as the
    reference writes them: the late key fills the first lines), and each
    package reads the other's file back to the same history."""
    h = LossHistory()
    j = JaxLossHistory()
    for i in range(4):
        row = {"total": 1.0 / (i + 1), "recon": 0.5 * i}
        if i >= 2:
            row["kl"] = 0.1 * i
        h.append(row)
        j.append(row)
    h.save_jsonl(str(tmp_path / "port" / "h.jsonl"))
    j.save_jsonl(str(tmp_path / "jax" / "h.jsonl"))
    port_text = (tmp_path / "port" / "h.jsonl").read_text()
    assert port_text == (tmp_path / "jax" / "h.jsonl").read_text()
    assert json.loads(port_text.splitlines()[0]) == {"epoch": 0, "kl": pytest.approx(0.2),
                                                     "recon": 0.0, "total": 1.0}
    back = LossHistory.load_jsonl(str(tmp_path / "jax" / "h.jsonl"))
    assert dict(back.history) == dict(JaxLossHistory.load_jsonl(
        str(tmp_path / "port" / "h.jsonl")).history)
    assert back.last("kl") == pytest.approx(0.3)


# ------------------------------------------------------------------ image


def test_image_helpers_match_the_reference():
    """psnr within 1e-5 dB (f32 mean of squares in another order), to_uint8
    bit-equal (truncation after the clip), normalize_latents within 1e-6
    with ddof=1 (a population std would be off by sqrt(n/(n-1)))."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(4, 8, 8, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
    assert float(image.psnr(torch.from_numpy(x), torch.from_numpy(y))) == pytest.approx(
        float(jimage.psnr(jnp.asarray(x), jnp.asarray(y))), abs=1e-5)
    assert float(image.psnr(torch.from_numpy(x), torch.from_numpy(x))) == pytest.approx(
        float(jimage.psnr(jnp.asarray(x), jnp.asarray(x))))
    wide = (x * 1.4 - 0.2).astype(np.float32)
    np.testing.assert_array_equal(image.to_uint8(torch.from_numpy(wide)), jimage.to_uint8(wide))
    np.testing.assert_array_equal(image.to_uint8(wide), jimage.to_uint8(wide))
    z = rng.normal(1.0, 2.0, size=(5, 6)).astype(np.float32)
    for a, b in zip(image.normalize_latents(torch.from_numpy(z)),
                    jimage.normalize_latents(jnp.asarray(z))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(image.normalize_latents(torch.from_numpy(z))[2].numpy(),
                               z.std(axis=0, ddof=1, keepdims=True), rtol=1e-6)


# ------------------------------------------------------------------ quality


class _FixedJaxSampler:
    """The reference's sampler facade returning fixed latents."""

    def __init__(self, latents):
        self.latents = jnp.asarray(latents)

    def sample(self, rng, batch, classes):
        return self.latents[:batch]


class _FixedSampler:
    """The port's sampler facade returning the same latents."""

    device = torch.device("cpu")

    def __init__(self, latents):
        self.latents = torch.from_numpy(np.asarray(latents))

    def sample(self, batch, classes, generator=None):
        assert generator is not None
        return self.latents[:batch]


def _latents(n=20, dim=8, seed=0):
    """Latents whose first coordinate carries the class of row i (i // 4),
    with every fifth row wrong."""
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 0.05, size=(n, dim)).astype(np.float32)
    z[:, 0] += np.repeat(np.arange(n // 4), 4)
    z[::5, 0] += 2.0
    return z


def _classify_j(z):
    return jax.nn.one_hot(jnp.clip(jnp.round(z[:, 0]).astype(jnp.int32), 0, 4), 5) * 10.0


def _classify_t(z):
    idx = torch.clamp(torch.round(z[:, 0]).long(), 0, 4)
    return torch.nn.functional.one_hot(idx, 5).float() * 10.0


def test_classifier_accuracy_matches_the_reference():
    z = _latents()
    got = q.classifier_accuracy_on_samples(_FixedSampler(z), _classify_t, 3, 5, 4)
    want = jq.classifier_accuracy_on_samples(_FixedJaxSampler(z), _classify_j,
                                             jax.random.key(3), 5, 4)
    assert got == want == pytest.approx(0.8)


@pytest.mark.parametrize("n,m,bandwidth", [(6, 6, None), (5, 4, None), (7, 9, 2.5)],
                         ids=["even_pool", "odd_pool", "fixed_bandwidth"])
def test_latent_mmd_matches_the_reference(n, m, bandwidth):
    """f32 on both sides: within 1e-5 absolute (the kernel sums run in
    another order). The 6 x 6 pool has 108 distances, an even count, whose
    median is the mean of the two middle ones as in jnp.median; the lower
    middle value would give another bandwidth and fail."""
    rng = np.random.default_rng(n * 10 + m)
    a = rng.normal(size=(n, 4)).astype(np.float32)
    b = (rng.normal(size=(m, 4)) * 1.3 + 0.4).astype(np.float32)
    got = q.latent_mmd(torch.from_numpy(a), torch.from_numpy(b), bandwidth)
    want = jq.latent_mmd(jnp.asarray(a), jnp.asarray(b), bandwidth)
    assert got == pytest.approx(want, abs=1e-5)
    if bandwidth is None and (n * n + m * m + n * m) % 2 == 0:
        pooled = np.concatenate([((x[:, None] - y[None]) ** 2).sum(-1).ravel()
                                 for x, y in ((a, a), (b, b), (a, b))])
        s = np.sort(pooled)
        lower = q.latent_mmd(torch.from_numpy(a), torch.from_numpy(b), float(s[len(s) // 2 - 1]))
        assert abs(lower - want) > 1e-4
    bad = a.copy()
    bad[0, 0] = np.nan
    assert q.latent_mmd(bad, b) == jq.latent_mmd(bad, b) == float("inf")


def test_frechet_functions_match_the_reference():
    rng = np.random.default_rng(2)
    fa = rng.normal(size=(40, 6))
    fb = rng.normal(size=(30, 6)) * 1.5 + 0.3
    assert q.frechet_distance(fa, fb) == pytest.approx(jq.frechet_distance(fa, fb), rel=1e-12)
    s1, s2 = np.cov(fa, rowvar=False), np.cov(fb, rowvar=False)
    assert q.frechet_from_stats(fa.mean(0), s1, fb.mean(0), s2) == pytest.approx(
        jq.frechet_from_stats(fa.mean(0), s1, fb.mean(0), s2), rel=1e-12)
    fa[0, 0] = np.inf
    assert q.frechet_distance(fa, fb) == float("inf")


def test_fd_stamp_and_the_comparability_guard_match_the_reference():
    """The same flax-named weights give the same stamp in both packages
    (the VGG asset's tree, as numpy, as jax arrays and as tensors), in the
    reference's leaf order; the guard passes within a run, raises across
    runs or backbones, warns when unstamped."""
    from flowerdiff_torch.models.vgg import load_vgg_params

    params, _ = load_vgg_params()
    tree = {"params": params, "extra": {"b": np.ones(3, np.float32), "a": np.zeros(2, np.float32)}}
    want = jq.fd_stamp(jax.tree.map(jnp.asarray, tree), "/runs/a")
    assert q.fd_stamp(tree, "/runs/a") == want
    assert q.fd_stamp(jax.tree.map(torch.from_numpy, tree), "/runs/a") == want
    other = {"w": np.ones((4, 4))}
    a = {"perceptual_fd": 1.0, **q.fd_stamp(other, "r")}
    assert q.check_fd_comparable(a, {"perceptual_fd": 2.0, **q.fd_stamp(other, "r")})
    with pytest.raises(ValueError, match="training run"):
        q.check_fd_comparable(a, {**q.fd_stamp(other, "s")})
    with pytest.raises(ValueError, match="backbone"):
        q.check_fd_comparable(a, {**q.fd_stamp({"w": 2 * np.ones((4, 4))}, "r")})
    with pytest.warns(UserWarning, match="fd_backbone"):
        assert not q.check_fd_comparable(a, {"perceptual_fd": 9.0})


def test_perceptual_fd_and_the_report_match_the_reference():
    """sample_quality_report with fixed latents on both sides, extra splits,
    decode and features: every key present on both sides; the accuracy,
    counts and stamp equal; MMD within 1e-5 (f32); the Fréchet distances
    within 1e-6 relative (float64 algebra on f32 features whose means sum
    in another order, ~1e-7 relative)."""
    z = _latents()
    imgs = np.random.default_rng(4).uniform(size=(24, 4, 4, 3)).astype(np.float32)
    train = imgs[::-1].copy() * 0.5

    def encode_j(x):
        return jnp.tile(jnp.mean(x, axis=(1, 2, 3))[:, None] * 5, (1, 8))

    def encode_t(x):
        return torch.mean(x, dim=(1, 2, 3))[:, None].repeat(1, 8) * 5

    def decode_j(v):
        return jnp.broadcast_to(v[:, :3][:, None, None, :], (v.shape[0], 4, 4, 3))

    def decode_t(v):
        return v[:, :3][:, None, None, :].expand(v.shape[0], 4, 4, 3)

    def feats_j(x):
        return jnp.concatenate([jnp.mean(x, axis=(1, 2)), jnp.max(x, axis=(1, 2))], -1)

    def feats_t(x):
        return torch.cat([x.mean(dim=(1, 2)), x.amax(dim=(1, 2))], -1)

    fp = {"w": np.arange(6, dtype=np.float32)}
    kw = dict(num_classes=5, n_per_class=4, max_classes=5, max_real=20, run_id="r")
    want = jq.sample_quality_report(
        _FixedJaxSampler(z), _classify_j, encode_j, jnp.asarray(imgs), jax.random.key(1),
        extra_splits={"train": jnp.asarray(train)}, decode_fn=decode_j, feature_fn=feats_j,
        feature_params=jax.tree.map(jnp.asarray, fp), **kw)
    got = q.sample_quality_report(
        _FixedSampler(z), _classify_t, encode_t, torch.from_numpy(imgs), 1,
        extra_splits={"train": torch.from_numpy(train)}, decode_fn=decode_t,
        feature_fn=feats_t, feature_params=fp, **kw)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, str):
            assert got[key] == value
        elif key.startswith("latent_mmd"):
            assert got[key] == pytest.approx(value, abs=1e-5), key
        elif key.startswith("perceptual_fd"):
            assert got[key] == pytest.approx(value, rel=1e-6), key
        else:
            assert got[key] == value, key
    fd = q.perceptual_fd(feats_t, torch.from_numpy(imgs), torch.from_numpy(train))
    assert fd == pytest.approx(jq.perceptual_fd(feats_j, jnp.asarray(imgs),
                                                jnp.asarray(train)), rel=1e-6)


# ------------------------------------------------------------------ profiling


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with profiling.annotate("pixel_step_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "pixel_step_span" for e in events)


def test_debug_mode_raises_on_nan_and_inf():
    """The check raises on a NaN or an Inf in what it is given and passes
    finite tensors; anomaly detection raises on a backward that makes a
    NaN; `nans=False` lets a NaN through."""
    with profiling.debug_mode() as check:
        check(torch.ones(3), torch.arange(3))
        with pytest.raises(FloatingPointError, match="NaN"):
            check(torch.tensor([1.0, float("nan")]))
        with pytest.raises(FloatingPointError, match="Inf"):
            check(torch.tensor([float("inf")]))
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    with profiling.debug_mode(nans=False) as check:
        check(torch.tensor([float("nan")]))
        with pytest.raises(FloatingPointError, match="Inf"):
            check(torch.tensor([float("-inf")]))
