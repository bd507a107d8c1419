"""The original repository's PyTorch checkpoints into the port's modules, and
the port's weights back out (port of flowerdiff/utils/torch_import.py).

The original repository trains for hours on a GPU and saves:
  - ``flower_autoencoder.pt``: ``{'autoencoder': sd, 'discriminator': sd}``
    (v1/model_train_test.py:1179-1190) or a raw autoencoder state dict
    (v1:1326);
  - ``conditional_diffusion_final.pt``: a raw ``ConditionalUNet`` state dict
    (v1:1282-1283, 1380);
  - ``diffusion_unet_pixels.pth``: a raw ``SimpleUNet`` state dict (v4:252,
    v5:275).

The port's modules already hold the original layouts (torch Conv2d and
ConvTranspose2d(k4, s2, p1) weights, the CHW-major flatten of the encoder
and of the decoder's fc2, Linear weights (out, in)), so an import is a map
of keys onto the port module's own state-dict keys, with two reshapes:

  CALayer's 1x1 convs (bias=False)   (C', C, 1, 1) -> the Linear gates (C', C)
  nn.MultiheadAttention in_proj      (3E, E) / (3E,) packed [q; k; v]
                                     -> three Linears q, k, v (row blocks)

`ImportResult.params` is a state dict (float32 CPU tensors) that the port's
module loads with ``strict=True``; the `export_*` functions are the inverse
maps, from a module or its state dict.

Every audit decision is the JAX package's, key for key:
  - the dead ModuleList tails (``time_projections.{last}``,
    ``cond_projections.{last}``, ``attention_layers.{last}``: constructed
    for every hidden width, but the stage loop covers len - 1, v1:510-516
    vs 541-556) are skipped on import and synthesised as zeros on export;
  - the discriminator's BatchNorm affines are copied onto the port's
    GroupNorm affines and reported as approximated (the normalisation
    differs, models/discriminator.py), BN's running statistics skipped on
    import and written at their fresh values (mean 0, var 1, 0 batches) on
    export;
  - the VAE's ``class_centers`` / ``center_counts`` buffers go to ``aux``
    (the port keeps the centers in the VAE-GAN state);
  - ``aux`` carries the geometry each import detects.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ImportResult",
    "import_autoencoder",
    "import_discriminator",
    "import_latent_denoiser",
    "import_pixel_unet",
    "export_autoencoder",
    "export_discriminator",
    "export_latent_denoiser",
    "export_pixel_unet",
    "load_torch_file",
]


def _t(x: Any) -> torch.Tensor:
    """A tensor or array-like -> a CPU tensor of its own, float32 where
    it is floating point."""
    t = x.detach().cpu() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return (t.to(torch.float32) if t.is_floating_point() else t).clone()


def _shape(sd: Mapping[str, Any], key: str) -> Tuple[int, ...]:
    return tuple(np.shape(sd[key]))


@dataclass
class ImportResult:
    """Converted weights and an audit trail of every source key's fate."""

    params: Dict[str, torch.Tensor]
    used: List[str] = field(default_factory=list)
    skipped: List[str] = field(default_factory=list)  # dead or unmappable keys
    approximated: List[str] = field(default_factory=list)  # e.g. BN -> GN
    aux: Dict[str, Any] = field(default_factory=dict)  # buffers, detected geometry

    def unused_keys(self, sd: Mapping[str, Any]) -> List[str]:
        touched = set(self.used) | set(self.skipped) | set(self.approximated)
        return [k for k in sd if k not in touched]


class _Reader:
    """Reads reference keys (recording each as used) into port keys."""

    def __init__(self, sd: Mapping[str, Any], result: ImportResult):
        self.sd = sd
        self.result = result

    def take(self, key: str) -> torch.Tensor:
        self.result.used.append(key)
        return _t(self.sd[key])

    def has(self, key: str) -> bool:
        return key in self.sd

    def put(self, key: str, value: torch.Tensor) -> None:
        self.result.params[key] = value.contiguous()

    def layer(self, ref: str, port: str, bias: bool = True) -> None:
        """A Linear, conv, LayerNorm, GroupNorm or LayerNorm2d: weight (and
        bias) under the same names."""
        self.put(f"{port}.weight", self.take(f"{ref}.weight"))
        if bias:
            self.put(f"{port}.bias", self.take(f"{ref}.bias"))

    def res_block(self, ref: str, port: str) -> None:
        """ResidualBlock (v1:159-178) -> core.layers.ResidualBlock."""
        for name in ("conv1", "ln1", "conv2", "ln2"):
            self.layer(f"{ref}.{name}", f"{port}.{name}")
        self.put(f"{port}.ca.squeeze.weight", self.take(f"{ref}.ca.conv_du.0.weight")[:, :, 0, 0])
        self.put(f"{port}.ca.excite.weight", self.take(f"{ref}.ca.conv_du.2.weight")[:, :, 0, 0])
        self.layer(f"{ref}.sa.conv", f"{port}.sa.conv", bias=False)


# (reference prefix, port prefix) of the autoencoder's plain layers
_ENCODER_HEADS = (("fc_mu", "mu"), ("fc_logvar", "logvar"))
_HEAD_SLOTS = ((0, "fc1"), (1, "ln"), (3, "fc2"))
_DECODER_FC = ((0, "fc1"), (1, "fc1_ln"), (3, "fc2"), (4, "fc2_ln"))
_DECODER_FINAL = ((0, "final_conv1"), (1, "final_gn"), (3, "final_conv2"))
_CLASSIFIER = ((0, "fc1"), (1, "ln1"), (4, "fc2"), (5, "ln2"), (8, "out"))


def import_autoencoder(sd: Mapping[str, Any]) -> ImportResult:
    """SimpleAutoencoder.state_dict() (v1:305-393) -> a FlowerVAE state dict
    (encoder, decoder, classifier). ``aux``: ``class_centers`` and
    ``center_counts`` (the reference's EMA buffers, v1:322-323; None where
    absent), ``latent_dim`` and ``num_classes``."""
    res = ImportResult(params={})
    r = _Reader(sd, res)
    r.layer("encoder.initial_conv.0", "encoder.stem_conv")
    r.layer("encoder.initial_conv.1", "encoder.stem_ln")
    for i in (1, 2, 3):
        r.layer(f"encoder.down{i}.0", f"encoder.down{i}_conv")
        r.layer(f"encoder.down{i}.1", f"encoder.down{i}_ln")
        r.res_block(f"encoder.res{i}", f"encoder.res{i}")
    for tname, oname in _ENCODER_HEADS:
        for slot, name in _HEAD_SLOTS:
            r.layer(f"encoder.{tname}.{slot}", f"encoder.{oname}_{name}")

    for slot, name in _DECODER_FC:
        r.layer(f"decoder.fc.{slot}", f"decoder.{name}")
    r.res_block("decoder.res3", "decoder.res3")
    for i in (3, 2, 1):
        r.layer(f"decoder.up{i}.0", f"decoder.up{i}_conv")
        r.layer(f"decoder.up{i}.1", f"decoder.up{i}_gn")
        if i > 1:
            r.res_block(f"decoder.res{i - 1}", f"decoder.res{i - 1}")
    for slot, name in _DECODER_FINAL:
        r.layer(f"decoder.final_conv.{slot}", f"decoder.{name}")

    for slot, name in _CLASSIFIER:
        r.layer(f"classifier.{slot}", f"classifier.{name}")

    for buf in ("class_centers", "center_counts"):
        res.aux[buf] = r.take(buf) if r.has(buf) else None
    res.aux["latent_dim"] = _shape(sd, "encoder.fc_mu.3.weight")[0]
    res.aux["num_classes"] = _shape(sd, "classifier.8.weight")[0]
    res.skipped.extend(res.unused_keys(sd))
    return res


# Discriminator64's Sequential slots (v1:986-1004): convs 0, 2, 5, 8; BN 3,
# 6, 9; the head 11
_DISC_CONVS = {0: 0, 1: 2, 2: 5, 3: 8}
_DISC_NORMS = {1: 3, 2: 6, 3: 9}
_BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def import_discriminator(sd: Mapping[str, Any]) -> ImportResult:
    """Discriminator64.state_dict() (v1:983-1007) -> the port's
    Discriminator64. Conv weights map exactly; BN affines go onto the
    GroupNorm affines (approximated), BN running statistics are skipped."""
    res = ImportResult(params={})
    r = _Reader(sd, res)
    for i, si in _DISC_CONVS.items():
        r.layer(f"model.{si}", f"conv{i}")
    for i, si in _DISC_NORMS.items():
        r.layer(f"model.{si}", f"norm{i}")
        res.approximated.extend([f"model.{si}.weight", f"model.{si}.bias"])
        res.skipped.extend(k for k in (f"model.{si}.{s}" for s in _BN_STATS) if k in sd)
    r.layer("model.11", "head")
    res.skipped.extend(res.unused_keys(sd))
    return res


def import_latent_denoiser(sd: Mapping[str, Any]) -> ImportResult:
    """ConditionalUNet.state_dict() (v1:501-561 / v3:769-853) -> a
    ConditionalLatentDenoiser state dict. ``multi_cond_emb.*`` keys mean v3
    (class and color, separate ``cond_projections``); ``class_emb.*`` keys
    mean v1/v2 (the shared time/condition projections, v1:544). ``aux``:
    ``hidden_dims``, ``latent_dim``, ``time_emb_dim``, ``num_classes``,
    ``num_colors`` and ``shared_cond_proj``, to build the matching module."""
    res = ImportResult(params={})
    r = _Reader(sd, res)
    n_stages = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    hidden = [_shape(sd, "latent_proj.weight")[0]]
    hidden += [_shape(sd, f"layers.{i}.2.weight")[0] for i in range(n_stages)]
    is_v3 = any(k.startswith("multi_cond_emb.") for k in sd)

    r.layer("time_emb.lin1", "time_emb.lin1")
    r.layer("time_emb.lin2", "time_emb.lin2")
    r.layer("latent_proj", "latent_proj")
    if is_v3:
        r.layer("multi_cond_emb.flower_emb", "cond_emb.flower_embedding", bias=False)
        r.layer("multi_cond_emb.color_emb", "cond_emb.color_embedding", bias=False)
        r.layer("multi_cond_emb.fc", "cond_emb.proj")
        num_classes = _shape(sd, "multi_cond_emb.flower_emb.weight")[0]
        num_colors = _shape(sd, "multi_cond_emb.color_emb.weight")[0]
    else:
        r.layer("class_emb.embedding", "cond_emb.embedding", bias=False)
        r.layer("class_emb.lin1", "cond_emb.lin1")
        r.layer("class_emb.lin2", "cond_emb.lin2")
        num_classes = _shape(sd, "class_emb.embedding.weight")[0]
        num_colors = None

    for i in range(n_stages):
        r.layer(f"time_projections.{i}", f"time_proj_{i}")
        if is_v3:
            r.layer(f"cond_projections.{i}", f"cond_proj_{i}")
        r.layer(f"layers.{i}.0.0", f"block_fc_{i}")
        r.layer(f"layers.{i}.0.1", f"block_ln_{i}")
        r.layer(f"layers.{i}.1", f"stage_ln_{i}")
        r.layer(f"layers.{i}.2", f"downsample_{i}")
        # torch MHA packs [q; k; v] along dim 0 of in_proj (3E, E)
        w = r.take(f"attention_layers.{i}.in_proj_weight")
        b = r.take(f"attention_layers.{i}.in_proj_bias")
        for j, part in enumerate("qkv"):
            rows = slice(j * hidden[i], (j + 1) * hidden[i])
            r.put(f"attn_{i}.{part}.weight", w[rows])
            r.put(f"attn_{i}.{part}.bias", b[rows])
        r.layer(f"attention_layers.{i}.out_proj", f"attn_{i}.out")

    r.layer("final_time_proj", "final_time_proj")
    r.layer("final_class_proj", "final_cond_proj")
    r.layer("final_norm", "final_norm")
    r.layer("final", "final")
    r.put("residual_weight", r.take("residual_weight").reshape(()))

    for dead in (f"time_projections.{n_stages}.", f"cond_projections.{n_stages}.",
                 f"attention_layers.{n_stages}."):
        res.skipped.extend(k for k in sd if k.startswith(dead))
    res.aux.update(hidden_dims=tuple(hidden), latent_dim=_shape(sd, "latent_proj.weight")[1],
                   time_emb_dim=_shape(sd, "time_emb.lin1.weight")[1],
                   num_classes=num_classes, num_colors=num_colors, shared_cond_proj=not is_v3)
    res.skipped.extend(res.unused_keys(sd))
    return res


# SimpleUNet's (v4/v5 model_train_test.py:37-103) double convs and its time
# MLP are Sequentials with their layers at slots 0 and 2
_PIXEL_DOUBLE_CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5", "bottleneck")
_PIXEL_TIME = (("time_embed.0", "time_fc_a"), ("time_embed.2", "time_fc_b"),
               ("time_fc1", "time_to_s1"), ("time_fc2", "time_to_s2"),
               ("time_fc3", "time_to_s3"))
_PIXEL_SAME = ("down1", "down2", "out_conv", "up1", "up2")


def import_pixel_unet(sd: Mapping[str, Any]) -> ImportResult:
    """SimpleUNet.state_dict() (v4:37-134, v5:38-145) -> a PixelUNet state
    dict. Bijective: every reference parameter is live. A ``res_ratio`` key
    means v5 (``learnable_residual``). ``aux``: ``in_channels``,
    ``base_channels``, ``time_emb_dim``, ``learnable_residual``."""
    res = ImportResult(params={})
    r = _Reader(sd, res)
    for ref, port in _PIXEL_TIME:
        r.layer(ref, port)
    for name in _PIXEL_DOUBLE_CONVS:
        r.layer(f"{name}.0", f"{name}_a")
        r.layer(f"{name}.2", f"{name}_b")
    for name in _PIXEL_SAME:
        r.layer(name, name)
    learnable_residual = r.has("res_ratio")
    if learnable_residual:
        r.put("res_ratio", r.take("res_ratio").reshape(()))
    w = _shape(sd, "conv1.0.weight")
    res.aux.update(in_channels=w[1], base_channels=w[0],
                   time_emb_dim=_shape(sd, "time_embed.0.weight")[0],
                   learnable_residual=learnable_residual)
    res.skipped.extend(res.unused_keys(sd))
    return res


def load_torch_file(path: str) -> Dict[str, Any]:
    """A reference .pt file as {key: tensor} (float32 where floating
    point), loaded with ``weights_only=True``. The combined
    ``{'autoencoder': sd, 'discriminator': sd}`` layout comes back as a dict
    of such dicts, a raw state dict as one."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "autoencoder" in obj:
        return {name: {k: _t(v) for k, v in sub.items()} for name, sub in obj.items()}
    return {k: _t(v) for k, v in obj.items()}


# ---------------------------------------------------------------------------
# Export: the port's weights -> reference state dicts (the inverse maps)
# ---------------------------------------------------------------------------
def _port_sd(source) -> Dict[str, torch.Tensor]:
    sd = source.state_dict() if isinstance(source, torch.nn.Module) else source
    return {k: _t(v) for k, v in sd.items()}


class _Writer:
    """Inverse of `_Reader`: port keys -> reference keys."""

    def __init__(self, src: Mapping[str, torch.Tensor], result: ImportResult):
        self.src = src
        self.result = result

    def put(self, key: str, value: torch.Tensor) -> None:
        self.result.params[key] = value.contiguous()
        self.result.used.append(key)

    def layer(self, ref: str, port: str) -> None:
        self.put(f"{ref}.weight", self.src[f"{port}.weight"])
        if f"{port}.bias" in self.src:
            self.put(f"{ref}.bias", self.src[f"{port}.bias"])

    def res_block(self, ref: str, port: str) -> None:
        for name in ("conv1", "ln1", "conv2", "ln2"):
            self.layer(f"{ref}.{name}", f"{port}.{name}")
        self.put(f"{ref}.ca.conv_du.0.weight", self.src[f"{port}.ca.squeeze.weight"][:, :, None, None])
        self.put(f"{ref}.ca.conv_du.2.weight", self.src[f"{port}.ca.excite.weight"][:, :, None, None])
        self.layer(f"{ref}.sa.conv", f"{port}.sa.conv")

    def synth(self, key: str, value: torch.Tensor) -> None:
        """A tensor the port does not hold: a dead ModuleList tail (zeros) or
        a BN running statistic at its fresh value."""
        self.result.params[key] = value
        self.result.approximated.append(key)


def export_autoencoder(source, class_centers: Optional[Any] = None,
                       center_counts: Optional[Any] = None) -> ImportResult:
    """A FlowerVAE with its classifier head (or its state dict) ->
    SimpleAutoencoder.state_dict() (v1:305-393), the exact inverse of
    `import_autoencoder`, loadable with ``strict=True`` into the reference
    module. ``class_centers`` / ``center_counts`` fill the reference's
    buffers (zeros where not given)."""
    src = _port_sd(source)
    res = ImportResult(params={})
    w = _Writer(src, res)
    w.layer("encoder.initial_conv.0", "encoder.stem_conv")
    w.layer("encoder.initial_conv.1", "encoder.stem_ln")
    for i in (1, 2, 3):
        w.layer(f"encoder.down{i}.0", f"encoder.down{i}_conv")
        w.layer(f"encoder.down{i}.1", f"encoder.down{i}_ln")
        w.res_block(f"encoder.res{i}", f"encoder.res{i}")
    for tname, oname in _ENCODER_HEADS:
        for slot, name in _HEAD_SLOTS:
            w.layer(f"encoder.{tname}.{slot}", f"encoder.{oname}_{name}")

    for slot, name in _DECODER_FC:
        w.layer(f"decoder.fc.{slot}", f"decoder.{name}")
    w.res_block("decoder.res3", "decoder.res3")
    for i in (3, 2, 1):
        w.layer(f"decoder.up{i}.0", f"decoder.up{i}_conv")
        w.layer(f"decoder.up{i}.1", f"decoder.up{i}_gn")
        if i > 1:
            w.res_block(f"decoder.res{i - 1}", f"decoder.res{i - 1}")
    for slot, name in _DECODER_FINAL:
        w.layer(f"decoder.final_conv.{slot}", f"decoder.{name}")

    for slot, name in _CLASSIFIER:
        w.layer(f"classifier.{slot}", f"classifier.{name}")

    latent = src["encoder.mu_fc2.weight"].shape[0]
    n_cls = src["classifier.out.weight"].shape[0]
    w.put("class_centers", _t(class_centers) if class_centers is not None
          else torch.zeros((n_cls, latent)))
    w.put("center_counts", _t(center_counts) if center_counts is not None
          else torch.zeros((n_cls,)))
    return res


def export_discriminator(source) -> ImportResult:
    """The port's Discriminator64 (or its state dict) -> the reference's
    state dict (v1:983-1007): GroupNorm affines onto the BatchNorm affines
    (approximated, the inverse of `import_discriminator`), BN running
    statistics at their fresh values (mean 0, var 1, 0 batches)."""
    src = _port_sd(source)
    res = ImportResult(params={})
    w = _Writer(src, res)
    for i, si in _DISC_CONVS.items():
        w.layer(f"model.{si}", f"conv{i}")
    for i, si in _DISC_NORMS.items():
        w.layer(f"model.{si}", f"norm{i}")
        res.approximated.extend([f"model.{si}.weight", f"model.{si}.bias"])
        ch = src[f"norm{i}.weight"].shape[0]
        w.synth(f"model.{si}.running_mean", torch.zeros((ch,)))
        w.synth(f"model.{si}.running_var", torch.ones((ch,)))
        w.synth(f"model.{si}.num_batches_tracked", torch.zeros((), dtype=torch.int64))
    w.layer("model.11", "head")
    return res


def export_latent_denoiser(source) -> ImportResult:
    """A ConditionalLatentDenoiser (or its state dict) ->
    ConditionalUNet.state_dict() (v1:501-561 / v3:769-853), the inverse of
    `import_latent_denoiser`. The reference's dead ModuleList tails (at
    index len(hidden_dims) - 1, never used in forward) are synthesised as
    zeros so that strict loading works, and listed in ``approximated``."""
    src = _port_sd(source)
    res = ImportResult(params={})
    w = _Writer(src, res)
    is_v3 = "cond_emb.flower_embedding.weight" in src
    w.layer("time_emb.lin1", "time_emb.lin1")
    w.layer("time_emb.lin2", "time_emb.lin2")
    w.layer("latent_proj", "latent_proj")
    if is_v3:
        w.layer("multi_cond_emb.flower_emb", "cond_emb.flower_embedding")
        w.layer("multi_cond_emb.color_emb", "cond_emb.color_embedding")
        w.layer("multi_cond_emb.fc", "cond_emb.proj")
    else:
        w.layer("class_emb.embedding", "cond_emb.embedding")
        w.layer("class_emb.lin1", "cond_emb.lin1")
        w.layer("class_emb.lin2", "cond_emb.lin2")

    n_stages = sum(1 for k in src if k.startswith("downsample_") and k.endswith(".weight"))
    for i in range(n_stages):
        w.layer(f"time_projections.{i}", f"time_proj_{i}")
        if is_v3:
            w.layer(f"cond_projections.{i}", f"cond_proj_{i}")
        w.layer(f"layers.{i}.0.0", f"block_fc_{i}")
        w.layer(f"layers.{i}.0.1", f"block_ln_{i}")
        w.layer(f"layers.{i}.1", f"stage_ln_{i}")
        w.layer(f"layers.{i}.2", f"downsample_{i}")
        for leaf in ("weight", "bias"):
            w.put(f"attention_layers.{i}.in_proj_{leaf}",
                  torch.cat([src[f"attn_{i}.{part}.{leaf}"] for part in "qkv"]))
        w.layer(f"attention_layers.{i}.out_proj", f"attn_{i}.out")

    # the dead tails at index n_stages, of the last stage's output width
    last = src[f"downsample_{n_stages - 1}.weight"].shape[0]
    t_emb = src["time_emb.lin2.weight"].shape[0]
    tails = [("time_projections", {"weight": (last, t_emb), "bias": (last,)})]
    if is_v3:
        tails.append(("cond_projections", {"weight": (last, t_emb), "bias": (last,)}))
    tails.append(("attention_layers", {"in_proj_weight": (3 * last, last),
                                       "in_proj_bias": (3 * last,),
                                       "out_proj.weight": (last, last),
                                       "out_proj.bias": (last,)}))
    for name, leaves in tails:
        for leaf, shape in leaves.items():
            w.synth(f"{name}.{n_stages}.{leaf}", torch.zeros(shape))

    w.layer("final_time_proj", "final_time_proj")
    w.layer("final_class_proj", "final_cond_proj")
    w.layer("final_norm", "final_norm")
    w.layer("final", "final")
    w.put("residual_weight", src["residual_weight"].reshape(()))
    return res


def export_pixel_unet(source) -> ImportResult:
    """A PixelUNet (or its state dict) -> SimpleUNet.state_dict() (v4:37-134
    / v5:38-145), the exact inverse of `import_pixel_unet`: nothing
    synthesised, every key live."""
    src = _port_sd(source)
    res = ImportResult(params={})
    w = _Writer(src, res)
    for ref, port in _PIXEL_TIME:
        w.layer(ref, port)
    for name in _PIXEL_DOUBLE_CONVS:
        w.layer(f"{name}.0", f"{name}_a")
        w.layer(f"{name}.2", f"{name}_b")
    for name in _PIXEL_SAME:
        w.layer(name, name)
    if "res_ratio" in src:
        w.put("res_ratio", src["res_ratio"].reshape(()))
    return res
