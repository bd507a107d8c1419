"""flowerdiff_torch.cli against the JAX package's cli: the same flags,
defaults and choices; the same preset for every flag set (the reference's
resolution, src/flowerdiff/cli.py:134-233, reproduced here through its public
presets); the same runner construction and run arguments from `main`; the
mesh flags; the platform switch; and a tiny v4 run end to end through the
command line on the CPU (the tiny v1 run with its final sweep:
tests/test_torch_port_cli_run.py)."""
import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

import flowerdiff.parallel
import flowerdiff.runner
from flowerdiff import cli as jcli
from flowerdiff import configs as jconfigs
from flowerdiff_torch import cli
from flowerdiff_torch import runner as port_runner
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]

FLAG_SETS = [
    [],
    ["--version", "flagship"],
    ["--version", "flagship", "--tiny", "--train_kernel"],
    ["--version", "v2", "--bf16"],
    ["--version", "v3", "--tiny", "--vae_bf16", "--visualize_every", "7",
     "--vae_visualize_every", "3"],
    ["--version", "v4", "--visualize_every", "5", "--sampler", "ddim"],
    ["--version", "v5", "--tiny", "--cond_dropout", "0.2", "--raw_latents"],
    ["--version", "v1", "--sampler", "ddim", "--ddim_steps", "20"],
    ["--version", "v1", "--ddim_steps", "30"],
    ["--version", "v1", "--cond_dropout", "0.1", "--guidance_scale", "3.0",
     "--ema_decay", "0.99"],
    ["--version", "v1", "--latent_cache", "4", "--cache_refresh_epochs", "10"],
    ["--version", "flagship", "--latent_cache", "0", "--raw_latents", "--bf16"],
    ["--version", "v2", "--tiny", "--bf16", "--vae_bf16", "--train_kernel",
     "--guidance_scale", "2.0"],
]


def _actions(parser: argparse.ArgumentParser):
    return [(a.option_strings, a.dest, a.default, a.choices, a.type, a.nargs, a.const,
             a.required, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)]


def test_parser_has_the_reference_s_flags_defaults_and_choices():
    assert _actions(cli.build_parser()) == _actions(jcli.build_parser())


def _reference_preset(args):
    """src/flowerdiff/cli.py:134-233 (the preset resolution of `main`),
    through the reference's public presets, with its warnings."""
    warnings = []
    preset = jconfigs.get_preset(args.version)
    if args.tiny:
        preset = jconfigs.tiny_preset(preset)
    if args.bf16:
        preset = jconfigs.bf16_preset(preset)
    if args.vae_bf16 and preset.vae is not None:
        preset = dataclasses.replace(preset, vae=dataclasses.replace(
            preset.vae, compute_dtype="bfloat16"))
    if args.visualize_every is not None:
        preset = dataclasses.replace(
            preset, diffusion_visualize_every=args.visualize_every,
            pixel_visualize_every=(args.visualize_every if preset.pixel is not None
                                   else preset.pixel_visualize_every))
    if args.vae_visualize_every is not None:
        preset = dataclasses.replace(preset, vae_visualize_every=args.vae_visualize_every)
    sampler_given = args.sampler is not None or args.ddim_steps is not None
    if sampler_given and preset.latent is None:
        warnings.append("--sampler")
    if sampler_given and preset.latent is not None:
        preset = dataclasses.replace(preset, latent=dataclasses.replace(
            preset.latent,
            sampler=args.sampler if args.sampler is not None else preset.latent.sampler,
            ddim_steps=(args.ddim_steps if args.ddim_steps is not None
                        else preset.latent.ddim_steps)))
    cfg_given = (args.cond_dropout is not None or args.guidance_scale is not None
                 or args.ema_decay is not None or args.latent_cache is not None
                 or args.cache_refresh_epochs is not None or args.train_kernel)
    if cfg_given and preset.latent is None:
        warnings.append("--cond_dropout")
    if cfg_given and preset.latent is not None:
        lat = preset.latent
        preset = dataclasses.replace(preset, latent=dataclasses.replace(
            lat,
            cond_dropout=args.cond_dropout if args.cond_dropout is not None else lat.cond_dropout,
            guidance_scale=(args.guidance_scale if args.guidance_scale is not None
                            else lat.guidance_scale),
            ema_decay=args.ema_decay if args.ema_decay is not None else lat.ema_decay,
            latent_cache=args.latent_cache if args.latent_cache is not None else lat.latent_cache,
            cache_refresh_epochs=(args.cache_refresh_epochs
                                  if args.cache_refresh_epochs is not None
                                  else lat.cache_refresh_epochs),
            train_kernel=args.train_kernel or lat.train_kernel,
            encode_dtype="bfloat16" if args.latent_cache else lat.encode_dtype))
    if args.raw_latents:
        if preset.latent is None:
            warnings.append("--raw_latents")
        else:
            preset = dataclasses.replace(preset, latent=dataclasses.replace(
                preset.latent, normalize_latents=False, clip_denoised=None))
    return preset, warnings


@pytest.mark.parametrize("flags", FLAG_SETS, ids=[" ".join(f) or "defaults" for f in FLAG_SETS])
def test_preset_resolution_equals_the_reference(flags, capsys):
    got = cli.resolve_preset(cli.build_parser().parse_args(flags))
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("warning:")]
    want, warnings = _reference_preset(jcli.build_parser().parse_args(flags))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert len(printed) == len(warnings)
    for line, flag in zip(printed, warnings):
        assert line.startswith(f"warning: {flag}") and "ignored" in line, line


class _Recorder:
    """Stands in for a PipelineRunner: records what `main` builds and
    runs."""

    calls = []

    def __init__(self, preset, **kw):
        self.preset = preset
        kw.pop("mesh", None)
        kw.pop("device", None)
        self.calls.append(("init", dataclasses.asdict(preset), kw))

    def run_latent(self, **kw):
        self.calls.append(("run_latent", kw))

    def run_pixel(self, **kw):
        self.calls.append(("run_pixel", kw))


RUN_ARGV = [
    ["--version", "v1", "--total_epochs", "3", "--vae_epochs", "2", "--batch_size", "8",
     "--checkpoint_path", "x/epoch_2", "--checkpoint_every", "4", "--no-final-sweep",
     "--seed", "7", "--synthetic_size", "40", "--dataset", "synthetic", "--results_dir", "r"],
    ["--version", "flagship", "--no-cadence-viz", "--no-fused-epochs", "--data_root", "d",
     "--mesh_data", "1", "--mesh_model", "1"],
    ["--version", "v5", "--total_epochs", "2", "--batch_size", "16", "--no-cadence-viz"],
]


@pytest.mark.parametrize("argv", RUN_ARGV, ids=["v1", "flagship", "v5"])
def test_main_builds_and_runs_the_runner_as_the_reference(argv, monkeypatch):
    monkeypatch.setenv("FLOWERDIFF_PLATFORM", "cpu")
    monkeypatch.setattr(flowerdiff.runner, "PipelineRunner", _Recorder)
    monkeypatch.setattr(flowerdiff.parallel, "create_mesh", lambda **kw: None)
    monkeypatch.setattr(port_runner, "PipelineRunner", _Recorder)
    _Recorder.calls = []
    jcli.main(argv)
    want = _Recorder.calls
    _Recorder.calls = []
    cli.main(argv)
    assert _Recorder.calls == want and len(want) == 2


@pytest.mark.parametrize("mesh", [["--mesh_data", "2"], ["--mesh_model", "2"],
                                  ["--mesh_data", "8", "--mesh_model", "1"]])
def test_mesh_flags_other_than_one_raise(mesh, monkeypatch):
    """A mesh of more than one process needs torchrun's processes: in one
    process it raises, naming the torchrun command line."""
    monkeypatch.setattr(port_runner, "PipelineRunner", _Recorder)
    monkeypatch.setenv("FLOWERDIFF_PLATFORM", "cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        cli.main(["--version", "v1"] + mesh)


def test_platform_switch(monkeypatch):
    monkeypatch.delenv("FLOWERDIFF_PLATFORM", raising=False)
    assert cli.run_device() == "cuda"
    for value, want in (("cpu", "cpu"), ("CPU", "cpu"), ("cuda", "cuda"), ("gpu", "cuda")):
        monkeypatch.setenv("FLOWERDIFF_PLATFORM", value)
        assert cli.run_device() == want
    monkeypatch.setenv("FLOWERDIFF_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="FLOWERDIFF_PLATFORM"):
        cli.run_device()
    monkeypatch.delenv("FLOWERDIFF_PLATFORM")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--version", "v4", "--tiny", "--dataset", "synthetic"])


def test_tiny_v4_run_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FLOWERDIFF_PLATFORM", "cpu")
    run = tmp_path / "v4"
    runner = cli.main(["--version", "v4", "--tiny", "--dataset", "synthetic", "--synthetic_size",
                       "24", "--total_epochs", "2", "--batch_size", "8", "--results_dir",
                       str(run)])
    out = capsys.readouterr().out
    assert runner.device.type == "cpu"
    assert "Diffusion Epoch 2/2" in out
    assert sorted(os.listdir(run)) == ["ckpt_pixel", "diffusion_animation.gif",
                                       "generated_pixel_diffusion.png", "samples_grid.png"]
    cli.main(["--version", "v4", "--tiny", "--dataset", "synthetic", "--synthetic_size", "24",
              "--results_dir", str(run)])
    assert "Loaded pixel diffusion at epoch 2" in capsys.readouterr().out


def test_module_entry_point_parses_the_flags():
    out = subprocess.run([sys.executable, "-m", "flowerdiff_torch", "--help"],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "--train_kernel" in out.stdout and "--no-final-sweep" in out.stdout
