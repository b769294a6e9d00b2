"""Learn the steered-BRIEF sampling pattern of ``calib/orb.py``.

ORB's descriptor compares the smoothed image at 256 pairs of points of
the 31 px patch, rotated to the keypoint's orientation. Random pairs,
once steered, are correlated and near-constant, so ORB learns its pairs
(Rublee et al., "ORB: an efficient alternative to SIFT or SURF", 2011,
section 4.3): over steered training patches, order candidate tests by how
far their mean lies from 0.5, then keep a test only if its correlation
with every test kept so far stays below a threshold, raising the
threshold until 256 are kept. OpenCV ships the table it learned; the
port learns its own here, on synthetic images with the spectrum of
natural images (1/f noise), and ``orb.py`` carries the result as a
constant.

    python -m surround360_tpu_torch.calib.orb_pattern   # prints the table

This runs on the CPU in about a minute and needs a few hundred MB.
"""

from __future__ import annotations

import numpy as np
import torch

from . import orb

TRAIN_IMAGES = 40
TRAIN_SIZE = 512
TRAIN_LEVELS = 3  # pyramid levels that give training keypoints
PER_LEVEL = 50  # keypoints a level (best Harris)
CANDIDATES = 16000  # candidate tests, drawn from all pairs of positions
REACH = 13  # positions in [-13, 12]^2, as ORB's patterns
THRESHOLDS = (0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5, 0.6, 0.7)


def _training_image(rng: np.random.Generator) -> torch.Tensor:
    """(H, W) grey levels: 1/f noise (random phases under an amplitude
    spectrum falling as 1/f, the spectrum of natural images), at a random
    contrast."""
    n = TRAIN_SIZE
    f = np.hypot(*np.meshgrid(np.fft.fftfreq(n), np.fft.rfftfreq(n), indexing="ij"))
    amp = 1.0 / np.maximum(f, 1.0 / n)
    phase = rng.uniform(0, 2 * np.pi, amp.shape)
    img = np.fft.irfft2(amp * np.exp(1j * phase), s=(n, n))
    img = (img - img.mean()) / img.std()
    img = 0.5 + rng.uniform(0.1, 0.25) * img
    return orb.to_gray8(img.astype(np.float32), "cpu")


def _steered_samples(positions: torch.Tensor, seed: int) -> np.ndarray:
    """(K, P) smoothed values at each position of every training keypoint's
    steered patch, keypoints found as ``orb.detect_and_compute`` finds them."""
    rng = np.random.default_rng(seed)
    mask = torch.as_tensor(orb._patch_mask())
    px = positions[:, 0].to(torch.float64)
    py = positions[:, 1].to(torch.float64)
    out = []
    for _ in range(TRAIN_IMAGES):
        for img in orb._pyramid(_training_image(rng))[:TRAIN_LEVELS]:
            ys, xs, angle = orb._keypoints(img, PER_LEVEL, mask)
            a, b = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
            dy = torch.round(px * b + py * a).long()
            dx = torch.round(px * a - py * b).long()
            out.append(orb._gaussian_7x7(img)[ys[:, None] + dy, xs[:, None] + dx].numpy())
    return np.concatenate(out)


def learn_pattern(seed: int = 0) -> np.ndarray:
    """(256, 4) int: the tests (x1, y1, x2, y2), greedily decorrelated."""
    rng = np.random.default_rng(seed)
    r = np.arange(-REACH, REACH)
    positions = np.stack(np.meshgrid(r, r), -1).reshape(-1, 2)
    n = len(positions)
    pick = rng.choice(n * n, CANDIDATES, replace=False)
    pairs = np.stack([pick // n, pick % n], 1)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    vals = _steered_samples(torch.as_tensor(positions), seed)
    centred = (vals[:, pairs[:, 0]] < vals[:, pairs[:, 1]]).astype(np.float32)
    mean = centred.mean(0)
    order = np.argsort(np.abs(mean - 0.5), kind="stable")
    centred -= mean
    centred /= np.maximum(np.linalg.norm(centred, axis=0), 1e-9)
    for threshold in THRESHOLDS:
        kept = []
        chosen = np.zeros((centred.shape[0], orb.DESCRIPTOR_BITS), np.float32)
        for c in order:
            x = centred[:, c]
            if kept and np.abs(chosen[:, : len(kept)].T @ x).max() > threshold:
                continue
            chosen[:, len(kept)] = x
            kept.append(c)
            if len(kept) == orb.DESCRIPTOR_BITS:
                best = pairs[np.asarray(kept)]
                return np.concatenate([positions[best[:, 0]], positions[best[:, 1]]], 1)
    raise RuntimeError("no threshold kept 256 tests")


def main():
    table = learn_pattern()
    rows = [", ".join(f"{int(v):3d}" for v in row) for row in table]
    print("_PATTERN = np.array([")
    for i in range(0, len(rows), 2):
        print("    " + ", ".join(f"({r})" for r in rows[i : i + 2]) + ",")
    print("], dtype=np.int64)")


if __name__ == "__main__":
    main()
