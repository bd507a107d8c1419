"""A tiny v1 run through flowerdiff_torch's command line on the CPU
(FLOWERDIFF_PLATFORM=cpu), final sweep included: the reference's artifact
names (checkpoints, history, loss curves, latent statistics, the sample
grid, 10 denoising paths, 10 GIFs) and its two-row sample_quality.jsonl.
The denoising-path figure (300 dpi, ~3 s a figure on a CPU; held against
the reference in tests/test_torch_port_viz_figures.py) is recorded here
instead of drawn; everything else runs as it is."""
import json
import os

from flowerdiff_torch import cli, viz
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)


def test_tiny_v1_run_with_its_final_sweep(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FLOWERDIFF_PLATFORM", "cpu")
    paths = []

    def denoising_path(encode_mu_fn, decode_fn, sampler, images, labels, class_idx,
                       class_names, save_path=None, **kw):
        assert images.shape[0] == labels.shape[0] == 128 and not kw
        assert sampler.latent_dim == 32
        paths.append((class_idx, os.path.basename(save_path)))
        open(save_path, "wb").close()
        return save_path

    monkeypatch.setattr(viz, "visualize_denoising_steps", denoising_path)
    run = tmp_path / "v1"
    runner = cli.main(["--version", "v1", "--tiny", "--dataset", "synthetic",
                       "--synthetic_size", "24", "--vae_epochs", "2", "--total_epochs", "2",
                       "--batch_size", "8", "--results_dir", str(run), "--no-cadence-viz"])
    out = capsys.readouterr().out
    assert runner.device.type == "cpu"
    for stage in ("vae_gan", "inter_stage_setup", "latent_ddpm", "final_sweep"):
        assert f"[stage {stage}]" in out, stage
    want = {"ckpt_vae", "ckpt_diffusion", "vae_history.jsonl", "autoencoder_losses.png",
            "latent_stats.npz", "diffusion_loss.png", "sample_quality.jsonl",
            "vae_samples_grid_subset.png"}
    want |= {f"denoising_path_{c}_final.png" for c in range(10)}
    want |= {f"diffusion_animation_{c}_final.gif" for c in range(10)}
    assert set(os.listdir(run)) == want
    with open(run / "sample_quality.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["split"] for r in rows] == ["heldout", "train"]
    shared = {"classifier_accuracy", "chance_accuracy", "n_generated", "fd_backbone",
              "fd_run_id", "latent_mmd", "perceptual_fd"}
    assert set(rows[0]) == shared | {"split", "n_real"} and set(rows[1]) == shared | {"split"}
    assert rows[0]["n_generated"] == 104 and rows[0]["fd_run_id"] == str(run)
    with open(run / "diffusion_animation_3_final.gif", "rb") as f:
        assert f.read(6) == b"GIF89a"
    assert paths == [(c, f"denoising_path_{c}_final.png") for c in range(10)]
