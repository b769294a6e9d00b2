"""The smoke run's kernel yardstick and bound arithmetic, on the CPU.

``chip_smoke.library_call`` times one ``torch.nn.functional.grid_sample``
call beside each kernel; where every tap of a sample lies inside its
window the window mask drops nothing, so that call must compute the
kernel's own function: here it is held against the kernels' plain twins
within 1e-5 (the normalised grid costs ~1e-7 px of coordinate at these
widths). ``chip_smoke.call_bounds`` must give the bytes and FLOPs of a
hand count, the source bytes those of the pixels the taps read.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from surround360_tpu_torch.ops import fused_window as fw

TOL = 1e-5


def _inside(rng, origin, low, high, size):
    """origin[..., None] + uniform [low, high) coordinates, float32."""
    return (origin[..., None] + rng.uniform(low, high, size)).astype(np.float32)


def _k1_case(interp, seed):
    rng = np.random.default_rng(seed)
    L, C, Hp, Wp, T, P = 2, 3, 40, 56, 5, 33
    pad_y, pad_x = 4, 6
    padded = np.zeros((L, C, Hp, Wp), np.float32)  # a zero border of 4 / 6 px
    padded[:, :, pad_y:-pad_y, pad_x:-pad_x] = rng.random(
        (L, C, Hp - 2 * pad_y, Wp - 2 * pad_x), dtype=np.float32)
    bh, wx = 24, 32
    sy = rng.integers(0, Hp - bh + 1, (T, L)).astype(np.int32)
    sx = rng.integers(0, Wp - wx + 1, (T, L)).astype(np.int32)
    lo, hi = (-1, 2) if interp == "bicubic" else (0, 1)
    # taps floor(v) + lo .. floor(v) + hi inside [s, s + b)
    xt = _inside(rng, sx, -lo, wx - hi - 1e-3, (T, L, P))
    yt = _inside(rng, sy, -lo, bh - hi - 1e-3, (T, L, P))
    kw = dict(bh=bh, bw=wx, pad_y=pad_y, pad_x=pad_x, n_y=Hp - 2 * pad_y,
              n_x=Wp - 2 * pad_x, interpolation=interp, border="constant",
              base_bw=None)
    return [torch.from_numpy(a) for a in (padded, sy, sx, xt, yt)], kw


@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
def test_grid_sample_yardstick_equals_k1_twin(interp):
    """K1 on a padded source, every tap inside its window."""
    args, kw = _k1_case(interp, seed=3)
    call, to_twin = cs.library_call(args, kw)
    got = to_twin(call())
    want = fw.fused_window_sample_reference(*args, **kw)
    assert got.shape == want.shape == (5, 2, 3, 33)
    assert float(want.abs().max()) > 0.5
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("border", ["constant", "clamp"])
def test_grid_sample_yardstick_equals_k2_twin(border):
    """K2 (per-tile origins shared by the leads), every tap inside."""
    args, kw = _k1_case("bicubic", seed=4)
    args[1], args[2] = args[1][:, 0].contiguous(), args[2][:, 0].contiguous()
    rng = np.random.default_rng(5)
    T, L, P = args[3].shape
    sy, sx = args[1].numpy(), args[2].numpy()
    args[3] = torch.from_numpy(_inside(rng, sx[:, None], 1, kw["bw"] - 3, (T, L, P)))
    args[4] = torch.from_numpy(_inside(rng, sy[:, None], 1, kw["bh"] - 3, (T, L, P)))
    kw = dict(kw, border=border)
    # clamp: keep every tap inside the source too, where it clamps nothing
    args[3] = args[3].clamp(kw["pad_x"] + 1, kw["pad_x"] + kw["n_x"] - 3)
    args[4] = args[4].clamp(kw["pad_y"] + 1, kw["pad_y"] + kw["n_y"] - 3)
    call, to_twin = cs.library_call(args, kw)
    want = fw.fused_window_sample_folded_reference(*args, **kw)
    torch.testing.assert_close(to_twin(call()), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("d", [1, 8])
def test_grid_sample_yardstick_equals_k3_twin(d):
    """K3: the flow's nine offsets at d folded into the grid as O x T x P
    points of coordinate + offset; bilinear taps of the base coordinate
    inside the window's interior, on an edge-replicated padded source."""
    rng = np.random.default_rng(d)
    L, C, H, W, T, P = 3, 2, 30, 50, 4, 40
    pad = 2 + d
    src = torch.from_numpy(rng.random((L, C, H, W), dtype=np.float32))
    padded = torch.nn.functional.pad(src, (pad, pad, pad, pad), mode="replicate")
    Hp, Wp = padded.shape[-2:]
    dirs = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))
    offs = ((0, 0),) + tuple((py * d, px * d) for py, px in dirs)
    bh, bw = 16 + 2 * d, 24 + 2 * d
    sy = rng.integers(0, Hp - bh + 1, T).astype(np.int32)
    sx = rng.integers(0, Wp - bw + 1, T).astype(np.int32)
    # base taps floor(v), floor(v) + 1 inside the interior [s + d, s + b - d)
    xt = _inside(rng, sx[:, None], d, bw - d - 1 - 1e-3, (T, L, P))
    yt = _inside(rng, sy[:, None], d, bh - d - 1 - 1e-3, (T, L, P))
    kw = dict(bh=bh, bw=bw, pad_y=pad, pad_x=pad, n_y=H, n_x=W,
              interpolation="bilinear", border="clamp", offsets=offs,
              off_my=d, off_mx=d)
    # clamp moves only base coordinates outside the source: keep them in
    xt = np.clip(xt, pad, pad + W - 1)
    yt = np.clip(yt, pad, pad + H - 1)
    args = [padded, torch.from_numpy(sy), torch.from_numpy(sx),
            torch.from_numpy(xt), torch.from_numpy(yt)]
    call, to_twin = cs.library_call(args, kw)
    want = fw.fused_window_sample_folded_reference(*args, **kw)
    assert want.shape == (T, L, 9, C, P)
    torch.testing.assert_close(to_twin(call()), want, atol=TOL, rtol=0)


def test_call_bounds_match_a_hand_count():
    """K1, bicubic, C = 4: two (tile, lead) windows of 5 x 6 px that share
    2 x 3 px, each sample's 4 x 4 taps inside its window; K3, bilinear,
    nine offsets, C = 2, windows covering the array."""
    padded = torch.zeros((1, 4, 20, 30))
    sy = torch.tensor([[2], [5]], dtype=torch.int32)
    sx = torch.tensor([[4], [7]], dtype=torch.int32)
    # tile 0: taps rows 3-6 x columns 5-8, and (4, 6) alone (an integer
    # coordinate: the other 15 weights are 0); tile 1: rows 6-9 x columns
    # 8-11, and a NaN sample; the two 4 x 4 sets share pixel (6, 8)
    xt = torch.full((2, 1, 8), 6.5)
    yt = torch.full((2, 1, 8), 4.5)
    xt[0, 0, 1], yt[0, 0, 1] = 6.0, 4.0
    xt[1], yt[1] = 9.5, 7.5
    xt[1, 0, 2] = float("nan")
    kw = dict(bh=5, bw=6, base_bw=None, pad_y=0, pad_x=0, n_y=20, n_x=30,
              interpolation="bicubic", border="constant")
    b = cs.call_bounds([padded, sy, sx, xt, yt], kw)
    samples = 2 * 1 * 8
    touched = 16 + 16 - 1
    assert b["src_bytes"] == 4 * 4 * touched
    assert b["window_src_bytes"] == 4 * 4 * (5 * 6 + 5 * 6 - 2 * 3)
    assert b["bytes"] == 8 * samples + 8 * 2 + 4 * samples * 4 + 4 * 4 * touched
    assert b["bytes"] == 896
    # weights 2 x 27; per channel 16 taps + 4 rows, 2 FLOPs each
    assert b["flops"] == samples * (54 + 4 * 40) == 3424
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(896 / 3.35e12 * 1e3)

    # tight-x windows use base_bw; a window past the array is clipped
    b = cs.call_bounds([padded, sy, sx - 5, xt - 5, yt], dict(kw, bw=128, base_bw=6))
    assert b["src_bytes"] == 4 * 4 * touched
    assert b["window_src_bytes"] == 4 * 4 * (5 * 5 + 5 * 6 - 2 * 3)

    # K3: tile 0 at (3.5, 10.5), base taps rows 3-4 x columns 10-11, and
    # at (4, 4) + (1, 1): 7 px a lead; tile 1 at (11.25, 20.0), an integer
    # x: taps rows 11-12 x column 20, and at + (1, 1): 4 px a lead
    padded2 = torch.zeros((3, 2, 16, 40))
    sy2 = torch.tensor([0, 8], dtype=torch.int32)
    sx2 = torch.tensor([0, 0], dtype=torch.int32)
    xt2 = torch.full((2, 3, 10), 10.5)
    yt2 = torch.full((2, 3, 10), 3.5)
    xt2[1], yt2[1] = 20.0, 11.25
    offs = ((0, 0),) + ((1, 1),) * 8
    b = cs.call_bounds([padded2, sy2, sx2, xt2, yt2],
                       dict(bh=8, bw=40, pad_y=0, pad_x=0, n_y=16, n_x=40,
                            offsets=offs, off_my=1, off_mx=1,
                            interpolation="bilinear", border="constant"))
    samples = 2 * 3 * 10
    assert b["window_src_bytes"] == 4 * 2 * 3 * 16 * 40  # the whole array
    assert b["src_bytes"] == 4 * 2 * 3 * (7 + 4)
    assert b["bytes"] == 8 * samples + 8 * 2 + 4 * samples * 9 * 2 + 4 * 2 * 3 * 11
    assert b["flops"] == samples * (6 + 9 * 2 * 12)


def test_touched_px_follows_the_clamp_border():
    """"clamp" + bicubic clamps each tap to the source: the 4 x 4 taps of a
    sample half a pixel inside its corner fold onto 3 x 3 pixels; "clamp"
    + bilinear clamps the coordinate, so one far outside reads the corner
    pixel alone."""
    padded = torch.zeros((1, 1, 10, 12))
    sy = torch.zeros((1, 1), dtype=torch.int32)
    kw = dict(bh=10, bw=12, base_bw=None, pad_y=2, pad_x=3, n_y=6, n_x=6,
              interpolation="bicubic", border="clamp")
    xt, yt = torch.full((1, 1, 1), 3.5), torch.full((1, 1, 1), 2.5)
    assert cs.touched_px([padded, sy, sy, xt, yt], kw) == 9
    kw = dict(kw, interpolation="bilinear")
    assert cs.touched_px([padded, sy, sy, xt - 50, yt - 50], kw) == 1


def test_window_union_counts_per_lead():
    sy = torch.tensor([[0, 0], [2, 10]], dtype=torch.int32)
    sx = torch.tensor([[0, 0], [1, 10]], dtype=torch.int32)
    got = cs.window_union_px(sy, sx, 3, 4, 12, 12)
    # lead 0: two 3 x 4 windows sharing 1 x 3; lead 1: one whole and one
    # clipped to 2 x 2
    assert got.tolist() == [12 + 12 - 3, 12 + 4]
    assert cs.window_union_px(sy[:, 0], sx[:, 0], 3, 4, 12, 12).tolist() == [21]


def test_flops_per_sample_hand_count():
    assert cs.flops_per_sample("bicubic", 4) == 214
    assert cs.flops_per_sample("bilinear", 2, 9) == 222
    assert cs.flops_per_sample("bilinear", 1) == 18


def test_call_bounds_of_a_three_channel_call():
    """K1 at C = 3 (the cubemap's panorama): the kernel pads its staged
    pixels to 4 floats, the bound counts the 3 channels that exist. One
    window over the whole array, two samples with 4 x 4 taps sharing a
    4 x 2 block, and the grid_sample yardstick on the same call."""
    g = torch.Generator().manual_seed(0)
    padded = torch.rand((1, 3, 12, 16), generator=g)
    sy = torch.zeros((1, 1), dtype=torch.int32)
    sx = torch.zeros((1, 1), dtype=torch.int32)
    xt = torch.tensor([[[4.5, 6.5]]])
    yt = torch.tensor([[[5.25, 5.75]]])
    kw = dict(bh=12, bw=16, base_bw=None, pad_y=0, pad_x=0, n_y=12, n_x=16,
              interpolation="bicubic", border="constant")
    b = cs.call_bounds([padded, sy, sx, xt, yt], kw)
    touched = 16 + 16 - 8
    assert b["src_bytes"] == 4 * 3 * touched
    assert b["window_src_bytes"] == 4 * 3 * 12 * 16
    assert b["bytes"] == 8 * 2 + 8 * 1 + 4 * 2 * 3 + 4 * 3 * touched == 336
    assert b["flops"] == 2 * cs.flops_per_sample("bicubic", 3) == 2 * (54 + 3 * 40)
    call, to_twin = cs.library_call([padded, sy, sx, xt, yt], kw)
    want = fw.fused_window_sample_reference(padded, sy, sx, xt, yt, **kw)
    assert want.shape == (1, 1, 3, 2)
    torch.testing.assert_close(to_twin(call()), want, atol=TOL, rtol=0)
