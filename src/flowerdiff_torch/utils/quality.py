"""Sample-quality metrics (port of flowerdiff/utils/quality.py).

  - `classifier_accuracy_on_samples`: class-conditional samples scored by
    the VAE's own classifier head; a sampler that ignores its class falls
    to ~1/num_classes;
  - `latent_mmd`: unbiased RBF-kernel MMD^2 between real encoded latents
    and generated ones, bandwidth by the median heuristic;
  - `perceptual_fd` / `frechet_distance` / `frechet_from_stats`: the
    Fréchet distance of Gaussians fit to perceptual features of real and
    generated images (an FID analogue in the framework's own feature
    space), the covariance algebra in float64 numpy on the host;
  - `fd_stamp` / `check_fd_comparable`: the stamp that keeps FD deltas
    within one feature backbone and one training run;
  - `sample_quality_report`: the bundle of all of them.

Where the reference takes a PRNG key, these take the port's sampler facade
(`sample(batch, classes, generator=...)`) and an integer seed; sampling
draws from generators derived from it on the sampler's device.
"""
from __future__ import annotations

import hashlib
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from flowerdiff_torch.utils.device import derived_generator


def _class_rows(num_classes: int, n_per_class: int, max_classes: Optional[int], device):
    k = min(num_classes, max_classes or num_classes)
    return torch.arange(k, device=device).repeat_interleave(n_per_class)


def classifier_accuracy_on_samples(sampler, classify_fn: Callable[[torch.Tensor], torch.Tensor],
                                   seed, num_classes: int, n_per_class: int = 4,
                                   max_classes: Optional[int] = None) -> float:
    """Accuracy of `classify_fn` (latents -> logits, e.g.
    FlowerVAE.classify) on n_per_class samples of each of the first
    min(num_classes, max_classes) classes, drawn from the generator of
    (seed,) (`seed`: an int or a tuple of ints)."""
    classes = _class_rows(num_classes, n_per_class, max_classes, sampler.device)
    words = seed if isinstance(seed, tuple) else (seed,)
    with torch.no_grad():
        latents = sampler.sample(int(classes.shape[0]), classes,
                                 generator=derived_generator(sampler.device, *words))
        pred = classify_fn(latents).argmax(dim=-1)
    return float((pred == classes).float().mean())


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aa = (a * a).sum(dim=1)[:, None]
    bb = (b * b).sum(dim=1)[None, :]
    return torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median as numpy's: the mean of the two middle values of an
    even-sized set (torch.median returns the lower one)."""
    s = x.flatten().sort().values
    k = s.shape[0] // 2
    return s[k] if s.shape[0] % 2 else (s[k - 1] + s[k]) / 2.0


def latent_mmd(real, generated, bandwidth: Optional[float] = None) -> float:
    """Unbiased RBF MMD^2 between two latent sets (N, d) / (M, d), f32;
    `bandwidth` defaults to the median of the pooled pairwise squared
    distances. Non-finite latents (a diverged sampler) report inf."""
    real = torch.as_tensor(real, dtype=torch.float32)
    generated = torch.as_tensor(generated, dtype=torch.float32).to(real.device)
    if not (bool(torch.isfinite(real).all()) and bool(torch.isfinite(generated).all())):
        return float("inf")
    d_rr = _pairwise_sq_dists(real, real)
    d_gg = _pairwise_sq_dists(generated, generated)
    d_rg = _pairwise_sq_dists(real, generated)
    if bandwidth is None:
        bw = torch.clamp(_median(torch.cat([d_rr.flatten(), d_gg.flatten(), d_rg.flatten()])),
                         min=1e-6)
    else:
        bw = torch.tensor(bandwidth, dtype=torch.float32, device=real.device)
    n, m = real.shape[0], generated.shape[0]
    k_rr = (torch.exp(-d_rr / bw).sum() - n) / (n * (n - 1))
    k_gg = (torch.exp(-d_gg / bw).sum() - m) / (m * (m - 1))
    k_rg = torch.exp(-d_rg / bw).mean()
    return float(k_rr + k_gg - 2.0 * k_rg)


def frechet_from_stats(mu1: np.ndarray, sigma1: np.ndarray,
                       mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """|mu1 - mu2|^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2}), the cross term as
    Tr((R S2 R)^{1/2}) with R = S1^{1/2}: every square root an eigh of a
    symmetric PSD matrix with its eigenvalues clipped at 0, in float64."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1, sigma2 = np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64)

    def psd_sqrt(s):
        w, v = np.linalg.eigh((s + s.T) / 2.0)
        return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T

    r = psd_sqrt(sigma1)
    m = r @ sigma2 @ r
    w = np.linalg.eigvalsh((m + m.T) / 2.0)
    tr_cross = float(np.sum(np.sqrt(np.clip(w, 0.0, None))))
    diff = mu1 - mu2
    fd = float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_cross)
    return max(fd, 0.0)


def frechet_distance(feats_a, feats_b) -> float:
    """Fréchet distance between Gaussians fit to two feature sets (N, d) /
    (M, d). Small sets give rank-deficient covariances and an upward bias:
    compare only at matched sample counts. Non-finite features report inf."""
    a = np.asarray(feats_a, np.float64)
    b = np.asarray(feats_b, np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    return frechet_from_stats(a.mean(0), np.cov(a, rowvar=False),
                              b.mean(0), np.cov(b, rowvar=False))


def _sorted_leaves(tree):
    """Leaves of a nested dict in sorted-key depth-first order, the order
    `jax.tree.leaves` gives a dict."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _sorted_leaves(tree[key])
    else:
        yield tree


def fd_stamp(feature_params=None, run_id: Optional[str] = None) -> dict:
    """Comparability stamp for perceptual-FD numbers: `fd_backbone`, a hash
    of the feature backbone's parameters (a flax-named tree of arrays or
    tensors: the same weights give the reference's stamp), and
    `fd_run_id`, the caller's name for the run the samples came from."""
    stamp: dict = {}
    if feature_params is not None:
        h = hashlib.sha256()
        for leaf in _sorted_leaves(feature_params):
            a = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
            h.update(str(a.shape).encode())
            h.update(a.tobytes()[:4096])
        stamp["fd_backbone"] = h.hexdigest()[:16]
    if run_id is not None:
        stamp["fd_run_id"] = str(run_id)
    return stamp


def check_fd_comparable(a: dict, b: dict, what: str = "FD comparison") -> bool:
    """True when two reports' stamps name the same backbone and the same
    run. Raises ValueError across backbones or runs; warns and returns
    False when a report is unstamped."""
    for key, label in (("fd_backbone", "feature backbone"), ("fd_run_id", "training run")):
        va, vb = a.get(key), b.get(key)
        if va is None or vb is None:
            warnings.warn(f"{what}: report(s) missing {key}; cross-run FD deltas are not "
                          f"meaningful: stamp reports via quality.fd_stamp()", stacklevel=2)
            return False
        if va != vb:
            raise ValueError(f"{what}: refusing FD delta across different {label}s "
                             f"({va!r} vs {vb!r}); a substitute-backbone FD is only valid "
                             f"within one run")
    return True


def _features(feature_fn, images) -> np.ndarray:
    with torch.no_grad():
        return feature_fn(images).float().cpu().numpy()


def perceptual_fd(feature_fn: Callable[[torch.Tensor], torch.Tensor], real_images,
                  generated_images) -> float:
    """Fréchet distance between the pooled perceptual features of real and
    generated image sets (relative numbers: the backbone is the
    framework's own)."""
    return frechet_distance(_features(feature_fn, real_images),
                            _features(feature_fn, generated_images))


def sample_quality_report(sampler, classify_fn, encode_mu_fn, images, seed: int,
                          num_classes: int, n_per_class: int = 4, max_classes: int = 26,
                          max_real: int = 256, extra_splits: Optional[dict] = None,
                          decode_fn: Optional[Callable] = None,
                          feature_fn: Optional[Callable] = None, feature_params=None,
                          run_id: Optional[str] = None) -> dict:
    """Classifier accuracy (from the generator of (seed, 0)) and the MMD of
    one generated set (from (seed, 1)) against the encoded real latents,
    and against each of `extra_splits` ({name: images}) as
    `latent_mmd_{name}`. With decode_fn and feature_fn, the generated
    latents are decoded once and `perceptual_fd` (and
    `perceptual_fd_{name}`) added, stamped by `fd_stamp`. Plain floats."""
    acc = classifier_accuracy_on_samples(sampler, classify_fn, (seed, 0), num_classes,
                                         n_per_class=n_per_class, max_classes=max_classes)
    classes = _class_rows(num_classes, n_per_class, max_classes, sampler.device)
    with torch.no_grad():
        generated = sampler.sample(int(classes.shape[0]), classes,
                                   generator=derived_generator(sampler.device, seed, 1))
        real = encode_mu_fn(images[:max_real])
    report = {
        "classifier_accuracy": acc,
        "chance_accuracy": 1.0 / num_classes,
        "latent_mmd": latent_mmd(real, generated),
        "n_generated": int(classes.shape[0]),
        "n_real": int(min(max_real, images.shape[0])),
    }
    for name, extra in (extra_splits or {}).items():
        with torch.no_grad():
            report[f"latent_mmd_{name}"] = latent_mmd(encode_mu_fn(extra[:max_real]), generated)
    if decode_fn is not None and feature_fn is not None:
        with torch.no_grad():
            gen_feats = _features(feature_fn, decode_fn(generated))
        report["perceptual_fd"] = frechet_distance(_features(feature_fn, images[:max_real]),
                                                   gen_feats)
        for name, extra in (extra_splits or {}).items():
            report[f"perceptual_fd_{name}"] = frechet_distance(
                _features(feature_fn, extra[:max_real]), gen_feats)
        report.update(fd_stamp(feature_params, run_id))
    return report
