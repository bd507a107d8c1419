"""What the runner tests share (tests/test_torch_port_runner*.py,
tests/test_torch_port_run_dir.py): the tiny preset on 24 synthetic images,
batch 8, a port runner on the CPU and a reference runner from one seed, the
checkpoint steps a run leaves, the VAE-GAN's best-epoch rule, and
`compare_runs`, which runs both pipelines with the same arguments."""
import dataclasses
import os

import numpy as np

from flowerdiff.configs import get_preset as jget_preset
from flowerdiff.configs import tiny_preset as jtiny_preset
from flowerdiff.runner import PipelineRunner as JaxRunner
from flowerdiff.train.checkpoints import CheckpointManager as JaxManager
from flowerdiff_torch.configs import get_preset, tiny_preset
from flowerdiff_torch.runner import PipelineRunner
from flowerdiff_torch.train.checkpoints import CheckpointManager
from flowerdiff_torch.train.metrics import LossHistory

N, BATCH = 24, 8
STEPS = N // BATCH
QUIET = dict(final_sweep=False, cadence_viz=False, batch_size=BATCH)


def _preset(mod_get, mod_tiny, version="v1", **over):
    return dataclasses.replace(mod_tiny(mod_get(version)), **over)


def _port(tmp_path, version="v1", name="port", fused=True, **over):
    return PipelineRunner(_preset(get_preset, tiny_preset, version, **over),
                          results_dir=str(tmp_path / name), dataset="synthetic",
                          synthetic_size=N, seed=0, fused_epochs=fused, device="cpu")


def _jax(tmp_path, version="v1", **over):
    return JaxRunner(_preset(jget_preset, jtiny_preset, version, **over),
                     results_dir=str(tmp_path / "jax"), dataset="synthetic",
                     synthetic_size=N, seed=0)


def _steps(run_dir, name, manager=CheckpointManager):
    return manager(os.path.join(run_dir, name)).all_steps()


def _best_rule(run_dir, vae_epochs, save_every):
    """The steps the VAE-GAN stage must leave: the best epoch so far (lowest
    mean total, first of equals, 0-based) at every save point, and the
    final state at vae_epochs; at most 5 kept, the oldest pruned first."""
    totals = LossHistory.load_jsonl(os.path.join(run_dir, "vae_history.jsonl")).history["total"]
    assert len(totals) == vae_epochs
    saves = [int(np.argmin(totals[:e])) for e in range(save_every, vae_epochs + 1, save_every)]
    if vae_epochs % save_every:
        saves.append(int(np.argmin(totals)))
    steps = []
    for s in saves + [vae_epochs]:
        if s in steps:
            steps.remove(s)
        steps.append(s)
    return sorted(steps[-5:])


def compare_runs(tmp_path, checkpoint_every=None):
    """The tiny v1 pipeline, 4 VAE-GAN epochs at a viz cadence of 2 and 6
    diffusion epochs at a viz cadence of 2, run by the port and by the
    reference with the same arguments: each leaves the VAE-GAN steps of the
    best-epoch rule over its own losses (the best state's step count
    saved with it), both leave the same diffusion steps and the same files.
    Returns the diffusion steps."""
    over = dict(vae_visualize_every=2, diffusion_visualize_every=2)
    kw = dict(total_epochs=6, vae_epochs=4, checkpoint_every=checkpoint_every, **QUIET)
    port = _port(tmp_path, **over)
    port.run_latent(**kw)
    ref = _jax(tmp_path, **over)
    ref.run_latent(**kw)
    save_every = checkpoint_every or 2
    steps = _steps(port.results_dir, "ckpt_vae")
    assert steps == _best_rule(port.results_dir, 4, save_every)
    assert _steps(ref.results_dir, "ckpt_vae", JaxManager) == _best_rule(ref.results_dir, 4,
                                                                         save_every)
    mgr = CheckpointManager(os.path.join(port.results_dir, "ckpt_vae"))
    for s in steps:
        assert int(mgr.restore(s)["gen"]["step"]) == min(s + 1, 4) * STEPS
    diffusion = _steps(port.results_dir, "ckpt_diffusion")
    assert diffusion == _steps(ref.results_dir, "ckpt_diffusion", JaxManager)
    assert sorted(os.listdir(port.results_dir)) == sorted(os.listdir(ref.results_dir))
    return diffusion
