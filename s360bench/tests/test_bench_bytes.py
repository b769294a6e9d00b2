"""The frozen byte count against hand-counted calls and against
chip_smoke.py's call_bounds."""

import pytest
import torch

from s360bench.bounds import call_bytes, touched_px


def _call(xs, ys, H=16, W=16, L=1, C=2, interpolation="bilinear", offsets=None, **extra):
    T, P = 1, len(xs)
    padded = torch.zeros((L, C, H, W))
    sy = torch.zeros((T, L) if offsets is None else (T,), dtype=torch.int32)
    sx = torch.zeros_like(sy)
    xt = torch.tensor(xs, dtype=torch.float32).reshape(1, 1, P).expand(T, L, P).contiguous()
    yt = torch.tensor(ys, dtype=torch.float32).reshape(1, 1, P).expand(T, L, P).contiguous()
    kw = dict(bh=H, bw=W, pad_y=0, pad_x=0, n_y=H, n_x=W, interpolation=interpolation,
              border="constant", base_bw=None)
    if offsets is not None:
        kw.update(offsets=offsets, off_my=1, off_mx=1)
    kw.update(extra)
    return [padded, sy, sx, xt, yt], kw


def test_integer_samples_read_one_pixel_each():
    args, kw = _call([3.0, 5.0, 7.0], [4.0, 4.0, 9.0])
    assert touched_px(args, kw) == 3
    # coordinates 8 B, one window 8 B, outputs 4 B x 2 channels, 3 pixels x 2 channels
    assert call_bytes(args, kw) == 8 * 3 + 8 + 4 * 3 * 2 + 4 * 2 * 3


def test_half_pixel_samples_read_their_taps_once():
    args, kw = _call([3.5, 3.5], [4.5, 4.5])  # the same 2x2 bilinear taps twice
    assert touched_px(args, kw) == 4
    args, kw = _call([3.5], [4.5], interpolation="bicubic")
    assert touched_px(args, kw) == 16


def test_window_and_border_clip_the_taps():
    args, kw = _call([0.5], [0.5], interpolation="bicubic")  # taps -1..2: 3 x 3 in the array
    assert touched_px(args, kw) == 9
    args, kw = _call([3.5], [4.5], bw=4)  # window columns 0..3: taps 3, 4 -> only 3 counts
    assert touched_px(args, kw) == 2


def test_offsets_count_each_field():
    args, kw = _call([5.0], [5.0], offsets=((0, 0), (0, 1), (1, 0)))
    assert touched_px(args, kw) == 3
    assert call_bytes(args, kw) == 8 + 8 + 4 * 3 * 2 + 4 * 2 * 3


@pytest.mark.parametrize("interpolation,offsets", [("bicubic", None), ("bilinear", None),
                                                   ("bilinear", ((0, 0), (1, -1)))])
def test_matches_chip_smoke(interpolation, offsets):
    import chip_smoke

    g = torch.Generator().manual_seed(3)
    T, L, P, H, W = 4, 2, 64, 40, 50
    padded = torch.rand((L, 3, H, W), generator=g)
    shape = (T, L) if offsets is None else (T,)
    sy = torch.randint(0, 20, shape, generator=g, dtype=torch.int32)
    sx = torch.randint(0, 20, shape, generator=g, dtype=torch.int32)
    xt = sx.reshape(T, -1, 1).expand(T, L, P) + 20 * torch.rand((T, L, P), generator=g)
    yt = sy.reshape(T, -1, 1).expand(T, L, P) + 20 * torch.rand((T, L, P), generator=g)
    kw = dict(bh=24, bw=24, pad_y=0, pad_x=0, n_y=H, n_x=W, interpolation=interpolation,
              border="constant" if offsets is None else "clamp", base_bw=None)
    if offsets:
        kw.update(offsets=offsets, off_my=1, off_mx=1)
    args = [padded, sy, sx, xt.contiguous(), yt.contiguous()]
    assert call_bytes(args, kw) == chip_smoke.call_bounds(args, kw)["bytes"]
