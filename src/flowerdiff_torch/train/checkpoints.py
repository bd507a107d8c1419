"""Checkpoints with exact resume (port of flowerdiff/train/checkpoints.py).

A checkpoint is a nested dict of tensors, one `torch.save` file per
`<directory>/step_<N>/`, loaded with `map_location` onto the CPU and then
moved to the caller's device. The trees capture the WHOLE training state:
the parameters, both Adam moments, the step count (which positions the
learning-rate schedule) and, where the state has them, the EMA weights and
the VAE-GAN's class centers, so a run restored into a fresh process
continues bit-equal to one that never stopped. `parse_epoch_from_filename`
reads the reference's `...epoch_N.pt` names.

Crash safety: a save writes `step_N.new/` (marked `_incomplete` until its
file is complete and synced), moves an existing `step_N/` aside to
`step_N.old/`, promotes the new directory and only then removes the old
one. At start-up the manager restores a `.old` whose step directory is
missing (a crash between the two renames: the backup is the only copy) and
sweeps every other `.new` / `.old`. A step directory that holds an
`_incomplete` marker is never listed.

In a multi-process run (parallel/mesh.py) only rank 0 sweeps and writes;
the other ranks wait at a barrier until it is done, and every rank restores
onto its own device (the `like` leaves'), where the reference re-applies
each leaf's sharding.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from flowerdiff_torch.parallel.mesh import barrier, is_writer

_STEP_RE = re.compile(r"^step_(\d+)$")
_FILE = "state.pt"
_INCOMPLETE = "_incomplete"


def parse_epoch_from_filename(path: str) -> Optional[int]:
    """`.../conditional_diffusion_epoch_450.pt` -> 450."""
    m = re.search(r"epoch_(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else None


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, tree, like):
    if isinstance(tree, dict):
        if not isinstance(like, dict) or set(tree) != set(like):
            raise ValueError("the checkpoint's tree does not have the keys of `like`")
        return {k: _map2(fn, tree[k], like[k]) for k in tree}
    return fn(tree, like)


def state_to_tree(state) -> dict:
    """An `AdamState` (or `LatentTrainState`) as a tree, keyed by parameter
    name: params, Adam's mu and nu, the step count and, for a state with
    an EMA, `ema_params`. The leaves are the state's own tensors: save the
    tree, or clone it, before the next step."""
    tree = {"params": dict(zip(state.names, state.params)),
            "mu": dict(zip(state.names, state.mu)),
            "nu": dict(zip(state.names, state.nu)),
            "step": torch.tensor(int(state.step), dtype=torch.int64)}
    ema = getattr(state, "ema", None)
    if ema is not None:
        tree["ema_params"] = dict(zip(state.names, ema))
    return tree


def tree_into_state(state, tree: dict):
    """Copy a `state_to_tree` tree into `state`, in place (exact resume),
    and return the state."""
    ema = getattr(state, "ema", None)
    parts = [("params", state.params), ("mu", state.mu), ("nu", state.nu)]
    if ema is not None:
        parts.append(("ema_params", ema))
    if (ema is None) != ("ema_params" not in tree):
        raise ValueError("the tree and the state disagree on having EMA weights")
    for key, dst in parts:
        if set(tree[key]) != set(state.names):
            raise ValueError(f"the tree's {key} are not the state's parameters")
        torch._foreach_copy_(dst, [torch.as_tensor(tree[key][n]).to(d.device)
                                   for n, d in zip(state.names, dst)])
    state.step = int(tree["step"])
    return state


def vae_gan_state_to_tree(state) -> dict:
    """The VAE-GAN's generator and discriminator states and its class
    centers."""
    return {"gen": state_to_tree(state.gen), "disc": state_to_tree(state.disc),
            "centers": state.centers}


def vae_gan_snapshot_to_tree(state, snap) -> dict:
    """The `vae_gan_state_to_tree` tree of a `VAEGANSnapshot` of `state`
    (its tensors in `state.tensors()` order: the generator's params, mu and
    nu, the discriminator's, then the centers)."""
    leaves = iter(snap.tensors)
    step = torch.tensor(int(snap.step), dtype=torch.int64)

    def adam_tree(adam):
        return {**{key: {n: next(leaves) for n in adam.names} for key in ("params", "mu", "nu")},
                "step": step}

    gen = adam_tree(state.gen)
    disc = adam_tree(state.disc)
    return {"gen": gen, "disc": disc, "centers": next(leaves)}


def tree_into_vae_gan_state(state, tree: dict):
    tree_into_state(state.gen, tree["gen"])
    tree_into_state(state.disc, tree["disc"])
    state.centers.copy_(torch.as_tensor(tree["centers"]).to(state.centers.device))
    return state


class CheckpointManager:
    """Atomic step-directory checkpoints: save(step, tree) / restore().
    Steps beyond `max_to_keep` are pruned, oldest first, never the step
    just written."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if is_writer():
            self._recover()
        barrier()

    def _recover(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        for name in sorted(os.listdir(self.directory)):
            path = os.path.join(self.directory, name)
            if name.endswith(".old"):
                step_dir = path[:-4]
                if not os.path.exists(step_dir):
                    os.rename(path, step_dir)
                else:
                    shutil.rmtree(path)
        for name in sorted(os.listdir(self.directory)):
            if name.endswith(".new"):
                shutil.rmtree(os.path.join(self.directory, name))

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and not os.path.exists(os.path.join(self.directory, name, _INCOMPLETE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, tree: Any) -> None:
        """Write `tree` (nested dicts of tensors, numpy arrays or numbers)
        as step `step`, replacing an existing one only once the new one is
        on disk. In a multi-process run rank 0 writes and every rank returns
        once it is written."""
        if is_writer():
            self._write(step, tree)
        barrier()

    def _write(self, step: int, tree: Any) -> None:
        target = self._step_dir(step)
        staging, backup = target + ".new", target + ".old"
        for stale in (staging, backup):
            if os.path.exists(stale):
                shutil.rmtree(stale)
        host = _map(lambda v: v.detach().cpu() if torch.is_tensor(v) else
                    torch.from_numpy(np.array(v)) if isinstance(v, (np.ndarray, np.generic))
                    else v, tree)
        os.makedirs(staging)
        marker = os.path.join(staging, _INCOMPLETE)
        open(marker, "w").close()
        with open(os.path.join(staging, _FILE), "wb") as fh:
            torch.save(host, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.remove(marker)
        if os.path.exists(target):
            os.rename(target, backup)
        os.rename(staging, target)
        if os.path.exists(backup):
            shutil.rmtree(backup)
        self._prune(keep_step=step)

    def _prune(self, keep_step: int) -> None:
        steps = self.all_steps()
        excess = len(steps) - self.max_to_keep
        for s in steps:
            if excess <= 0:
                break
            if s == keep_step:
                continue
            shutil.rmtree(self._step_dir(s))
            excess -= 1

    def _load(self, step: Optional[int]):
        step = self.latest_step() if step is None else step
        path = None if step is None else os.path.join(self._step_dir(step), _FILE)
        if path is None or step not in self.all_steps() or not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore_host(self, step: Optional[int] = None, like: Any = None) -> Any:
        """The tree of step `step` (default: the latest) with numpy leaves,
        on the host; `like`: a tree whose keys it must have."""
        tree = self._load(step)
        if like is not None:
            _map2(lambda t, _: t, tree, like)
        return _map(lambda v: v.numpy() if torch.is_tensor(v) else v, tree)

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """The tree of step `step` (default: the latest), on the CPU or,
        with `like` (a tree of the same keys), each tensor on its `like`
        leaf's device, with that leaf's shape."""
        tree = self._load(step)
        if like is None:
            return tree

        def place(t, ref):
            if not torch.is_tensor(ref):
                return t
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} where `like` "
                                 f"has {tuple(ref.shape)}")
            return t.to(ref.device)

        return _map2(place, tree, like)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def exists(self) -> bool:
        return self.latest_step() is not None
