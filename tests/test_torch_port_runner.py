"""flowerdiff_torch.runner.PipelineRunner against the JAX package's, at the
tiny preset on 24 synthetic images, batch 8, on the CPU.

The two runners draw from other streams (torch generators where the
reference folds epochs into JAX keys), so their losses differ; what must be
equal is the control flow: the fused chunk sizes, the checkpoint steps each
stage leaves (the VAE-GAN's by the same best-epoch rule over each run's own
losses), the artifact names, and, with the reference's VAE weights bridged
in, the VAE functions and the latent statistics (the reparameterisation
noise injected). The `checkpoint_every` cadence and the epoch-by-epoch form:
tests/test_torch_port_runner_cadence.py; resumes and the services built from
a run directory: tests/test_torch_port_run_dir.py."""
import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch

from flowerdiff.configs import get_preset as jget_preset
from flowerdiff.configs import tiny_preset as jtiny_preset
from flowerdiff.runner import PipelineRunner as JaxRunner
from flowerdiff.train.vae_gan import create_vae_gan_state as jax_vae_gan_state
from flowerdiff_torch.runner import PipelineRunner
from flowerdiff_torch.train.vae_gan import VAEGANConfig, create_vae_gan_state
from torch_port_runner_common import N, _jax, _port, compare_runs
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)


@pytest.mark.parametrize("cap", [None, 7, 1000])
def test_chunk_size_equals_the_reference(cap):
    me = types.SimpleNamespace(max_epochs_per_dispatch=50)
    for total in (1, 3, 60, 131, 2000):
        for epoch in range(0, total, max(1, total // 23)):
            for cadences in [(), (None,), (1,), (2,), (50, 300), (3, None, 10), (49, 50)]:
                got = PipelineRunner._chunk_size(me, epoch, total, *cadences, cap=cap)
                want = JaxRunner._chunk_size(me, epoch, total, *cadences, cap=cap)
                assert got == want, (epoch, total, cadences, cap)


def test_runs_leave_the_reference_checkpoints_and_artifacts(tmp_path):
    """The default cadence: diffusion saves at every viz boundary (as
    tests/test_checkpoint_cadence.py holds the reference)."""
    assert compare_runs(tmp_path) == [2, 4, 6]


def test_vae_functions_and_latent_stats_equal_the_reference(tmp_path):
    """The reference's initial VAE weights bridged into the port's module:
    decode, the encoder's mu and the latent statistics (the reference's
    reparameterisation draw injected) within 1e-5."""
    jcfg = jtiny_preset(jget_preset("v1")).vae
    jstate, jvae, _ = jax_vae_gan_state(jax.random.key(0), jcfg)
    gen_params = jax.tree.map(np.asarray, jstate.gen.params)
    cfg = VAEGANConfig(**dataclasses.asdict(jcfg))
    _, vae, _ = create_vae_gan_state(0, cfg, device="cpu", g_params={"params": gen_params})
    ref, port = _jax(tmp_path), _port(tmp_path)

    jdecode, jencode, _ = ref._vae_fns(jvae, jstate.gen.params)
    decode, encode, _ = port._vae_fns(vae)
    z = np.random.default_rng(1).standard_normal((5, cfg.latent_dim)).astype(np.float32)
    np.testing.assert_allclose(decode(torch.from_numpy(z)).numpy(), np.asarray(jdecode(z)),
                               rtol=1e-5, atol=1e-5)
    x = np.asarray(ref.test_images[:6])
    np.testing.assert_array_equal(port.test_images[:6].numpy(), x)
    np.testing.assert_allclose(encode(torch.from_numpy(x)).numpy(), np.asarray(jencode(x)),
                               rtol=1e-5, atol=1e-5)

    jmean, jstd = ref._compute_latent_stats(jvae, jstate.gen.params)
    noise = np.asarray(jax.random.normal(jax.random.key(0 + 3), (N, cfg.latent_dim)))
    mean, std = port._compute_latent_stats(vae, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(mean, np.asarray(jmean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std, np.asarray(jstd), rtol=1e-5, atol=1e-5)
    saved = np.load(os.path.join(port.results_dir, "latent_stats.npz"))
    np.testing.assert_array_equal(saved["mean"], mean)
    np.testing.assert_array_equal(saved["std"], std)
