"""The port's CLI under torchrun's environment on the CPU: a tiny v1 run
with --mesh_data 2 on two spawned ranks (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR / MASTER_PORT set per rank, so the CLI joins the gloo group
itself), then the same command again (the resume), against the same run
in one process.

Rank 0 alone prints and writes; both runs leave the same files; the resume
loads both checkpoints and trains nothing; the VAE-GAN's per-epoch metrics
(vae_history.jsonl) and the final diffusion state match world size 1 to
tests/test_fused.py's mesh tolerances (metrics rtol 5e-5 / atol 1e-6, the
denoiser's parameters rtol 5e-4 / atol 1e-5), and the printed diffusion
losses to their 6 printed decimals."""
import json
import os
import re
import socket

import numpy as np
import pytest
import torch

from flowerdiff_torch import cli
from torch_port_dist_common import cli_twice, start_ranks
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)

ARGV = ["--version", "v1", "--dataset", "synthetic", "--tiny", "--total_epochs", "2",
        "--vae_epochs", "2", "--batch_size", "8", "--synthetic_size", "24",
        "--no-cadence-viz", "--no-final-sweep"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    two_dir, one_dir = tmp_path_factory.mktemp("two_run"), tmp_path_factory.mktemp("one_run")
    job = start_ranks(cli_twice, 2, tmp_path_factory.mktemp("ranks"), group=False,
                      payload=dict(port=_free_port(),
                                   argv=ARGV + ["--mesh_data", "2", "--results_dir",
                                                str(two_dir)]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOWERDIFF_PLATFORM", "cpu")
        mp.delenv("WORLD_SIZE", raising=False)
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(ARGV + ["--results_dir", str(one_dir)])
    return dict(two=job.join(), two_dir=str(two_dir), one=buf.getvalue(),
                one_dir=str(one_dir))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _losses(text):
    return [float(x) for x in re.findall(r"Average Loss: ([0-9.]+)", text)]


def _state(root):
    step = max(int(n.split("_")[1]) for n in os.listdir(os.path.join(root, "ckpt_diffusion")))
    return torch.load(os.path.join(root, "ckpt_diffusion", f"step_{step}", "state.pt"),
                      weights_only=True)


def test_rank_zero_alone_prints_and_both_ranks_run(runs):
    (first0, again0), (first1, again1) = runs["two"]
    assert first1 == again1 == ""
    assert "No existing autoencoder found" in first0 and len(_losses(first0)) == 2
    assert first0.count("[stage vae_gan]") == 1


def test_the_run_writes_what_one_process_writes(runs):
    assert _files(runs["two_dir"]) == _files(runs["one_dir"])
    assert "ckpt_diffusion/step_2/state.pt" in _files(runs["two_dir"])


def test_the_resume_loads_and_trains_nothing(runs):
    again = runs["two"][0][1]
    assert "Loading existing autoencoder" in again
    assert "Loaded diffusion model at epoch 2" in again
    assert _losses(again) == []


def test_losses_and_state_match_world_size_one(runs):
    def history(root):
        with open(os.path.join(root, "vae_history.jsonl")) as fh:
            return [json.loads(line) for line in fh]

    two, one = history(runs["two_dir"]), history(runs["one_dir"])
    assert len(two) == len(one) == 2
    for a, b in zip(two, one):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=5e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(_losses(runs["two"][0][0]), _losses(runs["one"]), atol=2e-6)
    got, want = _state(runs["two_dir"]), _state(runs["one_dir"])
    assert got["step"] == want["step"]
    for name, leaf in want["params"].items():
        np.testing.assert_allclose(got["params"][name].numpy(), leaf.numpy(), rtol=5e-4,
                                   atol=1e-5, err_msg=name)
