"""The v3 color labels (port of flowerdiff/data/color_labels.py; numpy and
scikit-learn, no torch).

  - COLOR_CATEGORIES / COLOR_MAPPING: the 10-color taxonomy; green and black
    are never returned.
  - extract_color_category: Gaussian blur -> pixel filter (0.15 < brightness
    < 0.95, saturation > 0.1, the saturation filter dropped under 50 pixels)
    -> KMeans(k=5, seed 42, n_init 10) -> clusters ranked by
    size * (1 + 1.5 * saturation) -> the HSV rule cascade in rank order ->
    the nearest prototype of the first-ranked cluster.
  - extract_color_labels_cached: the labels of a whole split, cached as .npz.

sklearn is imported inside extract_color_category, in the same `try` as the
rest, so a machine without it labels every image "unknown" (mapped to
'white' by the cache), as the reference does on any extraction error.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

COLOR_CATEGORIES = {
    "red": (255, 0, 0),
    "green": (0, 128, 0),
    "blue": (0, 0, 255),
    "yellow": (255, 255, 0),
    "orange": (255, 165, 0),
    "purple": (128, 0, 128),
    "pink": (255, 192, 203),
    "brown": (165, 42, 42),
    "white": (255, 255, 255),
    "black": (0, 0, 0),
}
COLOR_MAPPING = {name: i for i, name in enumerate(COLOR_CATEGORIES)}
COLOR_NAMES = list(COLOR_CATEGORIES)
_EXCLUDED = ("green", "black")


def rgb_to_hsv(r: float, g: float, b: float) -> Tuple[float, float, float]:
    """Scalar RGB in [0, 1] -> (h in [0, 360), s, v in [0, 1])."""
    mx, mn = max(r, g, b), min(r, g, b)
    diff = mx - mn
    if diff < 1e-6:
        h = 0.0
    elif mx == r:
        h = (60 * ((g - b) / diff) + 360) % 360
    elif mx == g:
        h = (60 * ((b - r) / diff) + 120) % 360
    else:
        h = (60 * ((r - g) / diff) + 240) % 360
    s = 0.0 if mx < 1e-6 else diff / mx
    return h, s, mx


def hsv_to_color_name(h: float, s: float, v: float) -> Optional[str]:
    """The hand-tuned HSV rule cascade; never green or black; None sends the
    cluster to the nearest-prototype fallback."""
    if v > 0.85 and s < 0.2:
        return "white"
    if 10 <= h <= 40 and s <= 0.6 and v <= 0.6:
        return "brown"
    if (300 <= h < 360) or (0 <= h < 20):
        return "pink" if (v > 0.6 and s < 0.8) else "red"
    if (h < 20 or h > 340) and s > 0.2 and v > 0.2:
        return "red"
    if 20 <= h < 45 and s > 0.3 and v > 0.3:
        return "orange"
    if 45 <= h < 65 and s > 0.3 and v > 0.3:
        return "yellow"
    if 170 <= h < 250 and s > 0.2 and v > 0.2:
        return "blue"
    if 250 <= h < 310 and s > 0.2 and v > 0.2:
        return "purple"
    return None


def fallback_nearest_color(r255: float, g255: float, b255: float) -> str:
    """The nearest prototype by RGB distance, green and black left out."""
    best, best_dist = None, np.inf
    probe = np.array([r255, g255, b255], np.float32)
    for name, rgb in COLOR_CATEGORIES.items():
        if name in _EXCLUDED:
            continue
        dist = float(np.linalg.norm(probe - np.asarray(rgb, np.float32)))
        if dist < best_dist:
            best, best_dist = name, dist
    return best


def _gaussian_blur(img: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Separable Gaussian blur (sigma = radius, 7 taps at radius 1, zero
    padding), along H then W, in f32."""
    size = int(3 * radius) * 2 + 1
    xs = np.arange(size) - size // 2
    kernel = np.exp(-(xs**2) / (2 * radius**2))
    kernel /= kernel.sum()
    out = img.astype(np.float32)
    out = np.apply_along_axis(lambda m: np.convolve(m, kernel, "same"), 0, out)
    out = np.apply_along_axis(lambda m: np.convolve(m, kernel, "same"), 1, out)
    return out


def extract_color_category(image: np.ndarray, k: int = 5) -> Tuple[str, int]:
    """(name, index) of the dominant flower color of one (H, W, 3) image,
    uint8 or float in [0, 1]; ("unknown", -1) when too few pixels pass the
    filter or the extraction fails."""
    try:
        img = np.asarray(image)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=2)
        if img.shape[2] == 4:
            img = img[..., :3]
        img = _gaussian_blur(img)
        pixels = img.reshape(-1, 3).astype(np.float32)
        if pixels.max() > 1.0:
            pixels = pixels / 255.0

        brightness = pixels.mean(axis=1)
        max_c = pixels.max(axis=1)
        min_c = pixels.min(axis=1)
        saturation = (max_c - min_c) / np.maximum(max_c, 1e-6)
        mask = (brightness > 0.15) & (brightness < 0.95) & (saturation > 0.1)
        if mask.sum() < 50:
            mask = (brightness > 0.15) & (brightness < 0.95)
        filtered = pixels[mask]
        if len(filtered) < 10:
            return "unknown", -1

        from sklearn.cluster import KMeans

        km = KMeans(n_clusters=k, random_state=42, n_init=10).fit(filtered)
        centers = km.cluster_centers_
        counts = np.bincount(km.labels_, minlength=k)

        c_max = centers.max(axis=1)
        c_min = centers.min(axis=1)
        c_sat = (c_max - c_min) / (c_max + 1e-6)
        weights = counts * (1.0 + 1.5 * c_sat)

        fallback_idx = None
        for idx in np.argsort(weights)[::-1]:
            name = hsv_to_color_name(*rgb_to_hsv(*centers[idx]))
            if name is not None:
                return name, COLOR_MAPPING[name]
            if fallback_idx is None:
                fallback_idx = idx
        if fallback_idx is not None:
            name = fallback_nearest_color(*(centers[fallback_idx] * 255))
            return name, COLOR_MAPPING[name]
        return "unknown", -1
    except Exception as exc:  # noqa: BLE001 - the reference labels any failure "unknown"
        print(f"Error in color extraction: {exc}")
        return "unknown", -1


def extract_color_labels_cached(images: np.ndarray, cache_path: Optional[str] = None,
                                unknown_to: int = 8) -> Tuple[np.ndarray, list]:
    """(labels int32 (N,), names) of a whole split; "unknown" becomes
    `unknown_to` ('white'). A cache at `cache_path` holding as many labels
    as there are images is read instead of recomputing."""
    if cache_path and os.path.exists(cache_path):
        data = np.load(cache_path)
        if len(data["labels"]) == len(images):
            return data["labels"].astype(np.int32), list(data["names"])
    labels = np.empty((len(images),), np.int32)
    names = []
    for i, img in enumerate(images):
        name, idx = extract_color_category(img)
        labels[i] = idx if idx >= 0 else unknown_to
        names.append(name)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez_compressed(cache_path, labels=labels, names=np.array(names))
    return labels, names
