"""Oxford 102 Flowers loader in torchvision's layout (port of
flowerdiff/data/flowers102.py).

    <root>/flowers-102/jpg/image_{05d}.jpg
    <root>/flowers-102/imagelabels.mat   (1-based labels, length 8189)
    <root>/flowers-102/setid.mat         ('trnid'/'valid'/'tstid', 1-based ids)

The 'train' split is setid['trnid'] (1020 images), 'val' is 'valid', 'test'
is 'tstid' (6149); labels are mapped to 0-based. The .mat files are read with
scipy.io; each JPEG is decoded once, RGB and resized bicubic to (img_size,
img_size), by the native multithreaded libjpeg decoder where it builds
(`flowerdiff_torch.native`), PIL otherwise (`convert("RGB")`, then
`resize(BICUBIC)`), as the reference's one-time ingest; the split is cached
as a compressed .npz beside the files, so later runs skip the decode.

Nothing is downloaded: absent files raise FileNotFoundError, which the
runner's `dataset="auto"` turns into the synthetic fallback.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

FLOWERS102_SPLITS = {"train": "trnid", "val": "valid", "test": "tstid"}


def class_names() -> list[str]:
    """torchvision's Flowers102 has no class names: stringified indices, as
    the reference falls back to."""
    return [str(i) for i in range(102)]


def _dataset_dir(root: str) -> str:
    return os.path.join(root, "flowers-102")


def decode_jpegs(paths: List[str], size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N, size, size, 3), ok bool (N,)): each file RGB,
    bicubic-resized, through the native decoder when it builds (`native`),
    PIL otherwise, as the reference's one-time ingest; a file that fails to
    decode is left zero and marked not ok."""
    from flowerdiff_torch.native import decode_jpeg_batch

    return decode_jpeg_batch(paths, size)


def load_flowers102(root: str = "./data", split: str = "train", img_size: int = 64,
                    cache: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N, S, S, 3), labels int32 (N,)) of a split, in the
    split's id order."""
    base = _dataset_dir(root)
    cache_path = os.path.join(base, f"cache_{split}_{img_size}.npz")
    if cache and os.path.exists(cache_path):
        data = np.load(cache_path)
        return data["images"], data["labels"]

    jpg_dir = os.path.join(base, "jpg")
    labels_mat = os.path.join(base, "imagelabels.mat")
    setid_mat = os.path.join(base, "setid.mat")
    if not (os.path.isdir(jpg_dir) and os.path.exists(labels_mat)
            and os.path.exists(setid_mat)):
        raise FileNotFoundError(
            f"Flowers102 not found under {base}. Expected torchvision layout "
            f"(jpg/, imagelabels.mat, setid.mat). Nothing is downloaded; use "
            f"flowerdiff_torch.data.synthetic_flowers for offline runs, or place "
            f"the dataset there manually.")

    import scipy.io

    labels_all = scipy.io.loadmat(labels_mat)["labels"].ravel().astype(np.int64) - 1
    ids = scipy.io.loadmat(setid_mat)[FLOWERS102_SPLITS[split]].ravel().astype(np.int64)
    paths = [os.path.join(jpg_dir, f"image_{image_id:05d}.jpg") for image_id in ids]
    labels = labels_all[ids - 1].astype(np.int32)

    images, ok = decode_jpegs(paths, img_size)
    if not ok.all():
        bad = [paths[i] for i in np.nonzero(~ok)[0][:3]]
        raise IOError(f"failed to decode {int((~ok).sum())} images, e.g. {bad}")

    if cache:
        os.makedirs(base, exist_ok=True)
        np.savez_compressed(cache_path, images=images, labels=labels)
    return images, labels
