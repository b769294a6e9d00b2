"""The port's ISP against the JAX package's on the same seeded numpy
inputs: config parsing, the host tables, the three demosaics, the whole
pipeline (batched, binned, every skip flag, stuck pixels, companding), the
scalar oracle of tests/oracle_isp.py, and the raw / footage / DNG bytes.
Tolerances are stated per test."""

import dataclasses
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle_isp import oracle_isp

from surround360_tpu import isp as JI
from surround360_tpu.isp import demosaic as JD
from surround360_tpu.isp import dng as JDng
from surround360_tpu.isp import pipeline as JP
from surround360_tpu.utils import math_util as JM
from surround360_tpu_torch import isp as TI
from surround360_tpu_torch import native
from surround360_tpu_torch.isp import demosaic as TD
from surround360_tpu_torch.isp import dng as TDng
from surround360_tpu_torch.isp import pipeline as TP
from surround360_tpu_torch.isp import raw as TRaw
from surround360_tpu_torch.utils import math_util as TM

FULL = dict(
    bayer_pattern="GBRG",
    bits_per_pixel=12,
    black_level=(40.0, 48.0, 56.0),
    white_balance_gain=(1.3, 1.0, 1.8),
    clamp_min=(0.01, 0.02, 0.0),
    clamp_max=(0.98, 1.0, 0.95),
    vignette_rolloff_h=((0.9, 0.95, 0.9), (1.2, 1.15, 1.25), (0.95, 1.0, 0.9)),
    vignette_rolloff_v=((1.0, 1.0, 1.0), (1.1, 1.05, 1.1)),
    ccm=((0.9, 0.1, 0.0), (0.05, 0.9, 0.05), (0.0, 0.2, 0.8)),
    saturation=1.2,
    gamma=(0.45, 0.5, 0.45),
    low_key_boost=(0.05, 0.0, -0.02),
    high_key_boost=(-0.03, 0.02, 0.0),
    contrast=1.1,
    sharpening=(0.4, 0.5, 0.3),
    sharpening_support=0.02,
    noise_core=50.0,
)
PATTERNS = ("RGGB", "GRBG", "GBRG", "BGGR")
LUT_STEP = 2e-3  # one entry of FULL's tone curve where these inputs lie


def both(**kw):
    return JP.IspConfig(**kw), TP.IspConfig(**kw)


def smooth_raw(shape, seed=0):
    """A smooth mosaic-like plane in [0, 1] (low-pass noise + fine grain)."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    coarse = rng.random(shape[:-2] + (h // 4 + 2, w // 4 + 2))
    img = np.kron(coarse, np.ones((4, 4)))[..., :h, :w]
    return (0.9 * img + 0.1 * rng.random(shape)).astype(np.float32)


def test_config_json_round_trip_equals_jax(tmp_path):
    jc, tc = both(**FULL, stuck_pixel_radius=4, stuck_pixel_threshold=2,
                  stuck_pixel_darkness_threshold=0.3,
                  companding_lut=((0.0, 0.0, 0.0), (0.5, 0.7, 0.7), (1.0, 1.0, 1.0)))
    assert tc.to_json() == jc.to_json()
    assert tc.max_pixel_value == jc.max_pixel_value == 4095
    path = tmp_path / "isp.json"
    path.write_text(json.dumps(tc.to_json()))
    for source in (tc.to_json(), json.dumps(jc.to_json()), str(path)):
        got, want = TP.load_isp_config(source), JP.load_isp_config(source)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.stuck_pixel_radius == 8  # doubled on parse (CameraIsp.h:517)
    assert dataclasses.asdict(TP.load_isp_config({"CameraIsp": {}})) == \
        dataclasses.asdict(JP.load_isp_config({"CameraIsp": {}}))
    assert dataclasses.asdict(TP.IspConfig()) == dataclasses.asdict(JP.IspConfig())


def test_bezier_equals_jax():
    t = np.linspace(0.0, 1.0, 17)
    pts = [0.1, 0.7, 0.2, 0.9]
    np.testing.assert_array_equal(TM.bezier_curve(pts, t), JM.bezier_curve(pts, t, xp=np))
    ctrl = np.random.default_rng(0).random((5, 4))
    np.testing.assert_array_equal(
        TM.bezier_curve_batch(ctrl, t[:5]), JM.bezier_curve_batch(ctrl, t[:5], xp=np))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_host_tables_equal_jax(pattern):
    """Tone LUT, composite CCM, vignette gains and Bayer masks are host
    float64 arithmetic: within 1e-6 (in fact equal)."""
    jc, tc = both(**dict(FULL, bayer_pattern=pattern))
    for name, args in (("build_tone_curve_lut", ()), ("build_composite_ccm", ()),
                       ("build_vignette_gains", (37, 52)), ("bayer_masks", (37, 52))):
        got, want = getattr(TP, name)(tc, *args), getattr(JP, name)(jc, *args)
        got, want = (v if isinstance(v, tuple) else (v,) for v in (got, want))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            if g.dtype == bool:
                np.testing.assert_array_equal(g, w)
            else:
                assert float(np.abs(g - w).max()) <= 1e-6
    lin = TP.build_tone_curve_lut(dataclasses.replace(tc, disable_tone_curve=True))
    np.testing.assert_array_equal(
        lin, JP.build_tone_curve_lut(dataclasses.replace(jc, disable_tone_curve=True)))


def _masks(pattern, h, w):
    return JP.bayer_masks(JP.IspConfig(bayer_pattern=pattern), h, w)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("name", ["demosaic_bilinear", "demosaic_edge_aware"])
def test_demosaic_matches_jax(name, pattern):
    """Within 2e-5 (sums of a few float32 taps in another order), single
    planes and batches."""
    h, w = 26, 34
    masks = _masks(pattern, h, w)
    raw = smooth_raw((2, 3, h, w), seed=PATTERNS.index(pattern))
    want = np.asarray(getattr(JD, name)(jnp.asarray(raw[0, 0]), *map(jnp.asarray, masks)))
    tm = [torch.from_numpy(m) for m in masks]
    got = getattr(TD, name)(torch.from_numpy(raw), *tm).numpy()
    assert got.shape == (2, 3, 3, h, w)
    assert float(np.abs(got[0, 0] - want).max()) <= 2e-5
    single = getattr(TD, name)(torch.from_numpy(raw[1, 2]), *tm).numpy()
    np.testing.assert_array_equal(single, got[1, 2])


def test_shift_reflect_is_the_reference_mirror():
    x = np.arange(2 * 5 * 6, dtype=np.float32).reshape(2, 5, 6)
    padded = TD._Reflected(torch.from_numpy(x), 4)
    for dy, dx in ((-2, 0), (0, 3), (1, -1), (4, -4)):
        np.testing.assert_array_equal(
            padded.shift(dy, dx).numpy(),
            np.asarray(JD._shift_reflect(jnp.asarray(x), dy, dx)))
    with pytest.raises(ValueError, match="too small"):
        TD._Reflected(torch.from_numpy(x), 5)


@pytest.mark.parametrize("shape", [(24, 32), (33, 20)])
def test_demosaic_frequency_matches_jax_and_scipy(shape):
    """The DCT products as matrix products with the orthonormal DCT-II
    matrix: the matrix against scipy's dct within 1e-6, the demosaic
    against the JAX package's (jax.scipy.fft.dctn) within 2e-5."""
    from scipy.fft import dctn

    h, w = shape
    rng = np.random.default_rng(1)
    x = rng.random(shape)
    d_h, d_w = TD._dct_matrix(h).astype(np.float64), TD._dct_matrix(w).astype(np.float64)
    assert float(np.abs(d_h @ x @ d_w.T - dctn(x, norm="ortho")).max()) <= 1e-6
    assert float(np.abs(d_h @ d_h.T - np.eye(h)).max()) <= 1e-6
    masks = _masks("GBRG", h, w)
    raw = smooth_raw((2, h, w), seed=2)
    want = np.stack([
        np.asarray(JD.demosaic_frequency(jnp.asarray(r), *map(jnp.asarray, masks)))
        for r in raw])
    got = TD.demosaic_frequency(
        torch.from_numpy(raw), *[torch.from_numpy(m) for m in masks]).numpy()
    assert got.shape == want.shape == (2, 3, h, w)
    assert float(np.abs(got - want).max()) <= 2e-5


def _held_to_jax(got, want, step=LUT_STEP, flips=0.002):
    """Within 1e-4, or within one tone-LUT step where an index flips (the
    CCM product truncates to the LUT index: a last-bit difference before
    it moves a pixel by one entry); the share of such pixels <= ``flips``."""
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    assert float(d.max()) <= step, float(d.max())
    share = float((d > 1e-4).mean())
    assert share <= flips, share
    return share


CASES = {
    "full": dict(cfg=FULL),
    "bilinear": dict(cfg=dict(FULL, demosaic_filter="bilinear", bayer_pattern="RGGB")),
    "frequency": dict(cfg=dict(FULL, demosaic_filter="frequency")),
    "skip_sharpen": dict(cfg=FULL, skip_sharpen=True),
    "skip_tone_curve": dict(cfg=FULL, skip_tone_curve=True),
    "disable_tone_curve": dict(cfg=dict(FULL, disable_tone_curve=True)),
    "resize2": dict(cfg=FULL, resize=2),
    "resize4": dict(cfg=dict(FULL, bayer_pattern="BGGR"), resize=4),
    "defaults": dict(cfg={}),
    "stuck_even_radius": dict(cfg=dict(
        FULL, stuck_pixel_radius=2, stuck_pixel_threshold=2,
        stuck_pixel_darkness_threshold=0.6)),
    "stuck_odd_radius": dict(cfg=dict(
        FULL, stuck_pixel_radius=3, stuck_pixel_threshold=3,
        stuck_pixel_darkness_threshold=0.6)),
}


@pytest.mark.parametrize("case", CASES)
def test_isp_process_matches_jax(case):
    kw = dict(CASES[case])
    jc, tc = both(**kw.pop("cfg"))
    raw = smooth_raw((48, 64), seed=3)
    if case.startswith("stuck"):
        raw *= 0.5
        raw[10:40:6, 7:60:8] = 0.95  # hot pixels in a dark field
    want = np.asarray(JP.isp_process(jnp.asarray(raw), jc, **kw))
    got = TP.isp_process(torch.from_numpy(raw), tc, **kw).numpy()
    f = kw.get("resize", 1)
    assert got.shape == (3, 48 // f, 64 // f)
    linear = case in ("skip_tone_curve", "disable_tone_curve", "defaults")
    step = 1.0 / 4095 + 1e-6 if linear else LUT_STEP  # one entry of a linear curve
    _held_to_jax(got, want, step=step)
    if case.startswith("stuck"):
        # the stage replaced pixels, in both packages alike
        off = dataclasses.replace(tc, stuck_pixel_radius=0)
        assert float(np.abs(got - TP.isp_process(torch.from_numpy(raw), off).numpy()).max()) > 0.05


def test_stuck_pixel_median_of_even_count_averages():
    """An odd radius gives an even count of neighbours: the median is the
    mean of the two middle values, as jnp.median (torch.median would take
    the lower one). Against the JAX stage within 1e-6."""
    jc, tc = both(stuck_pixel_radius=1, stuck_pixel_threshold=4,
                  stuck_pixel_darkness_threshold=2.0)
    raw = np.random.default_rng(5).random((12, 14)).astype(np.float32)
    red, green, _, _ = JP.bayer_masks(jc, 12, 14)
    want = np.asarray(JP._stuck_pixel_removal(jnp.asarray(raw), jc, red, green))
    got = TP._stuck_pixel_removal(torch.from_numpy(raw), tc).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6
    assert (got != raw).mean() > 0.5  # every pixel is "dark": most are replaced
    nbrs = np.sort([raw[0, 0], raw[0, 2], raw[2, 0], raw[2, 2]])  # offsets (+-1, +-1)
    assert got[1, 1] in (raw[1, 1], np.float32((nbrs[1] + nbrs[2]) / 2.0))


def test_isp_process_batched_equals_per_frame():
    """Any leading batch dims (the reference vmaps), equal to the frames
    one by one, and held to the JAX package's batched call."""
    jc, tc = both(**FULL)
    raw = smooth_raw((2, 3, 32, 40), seed=4)
    got = TP.isp_process(torch.from_numpy(raw), tc).numpy()
    assert got.shape == (2, 3, 3, 32, 40)
    one = TP.isp_process(torch.from_numpy(raw[1, 2]), tc).numpy()
    assert float(np.abs(got[1, 2] - one).max()) <= 1e-6
    _held_to_jax(got, np.asarray(JP.isp_process(jnp.asarray(raw), jc)))
    with pytest.raises(TypeError, match="torch.Tensor"):
        TP.isp_process(raw, tc)
    with pytest.raises(ValueError, match="resize"):
        TP.isp_process(torch.from_numpy(raw), tc, resize=3)


def _clear_tables():
    TP._TABLES.clear()
    TP._device_masks.cache_clear()


@pytest.mark.parametrize("case", ["full", "bilinear", "frequency", "skip_tone_curve",
                                  "resize2", "stuck_odd_radius"])
def test_warm_call_equals_cold_and_cleared(case):
    """The tables kept on the device change nothing: a second call with
    the same configuration and shape, and a call after the cache is
    cleared, equal the first (cold) call bit for bit."""
    kw = dict(CASES[case])
    cfg = TP.IspConfig(**kw.pop("cfg"))
    raw = torch.from_numpy(smooth_raw((2, 48, 64), seed=8))
    _clear_tables()
    cold = TP.isp_process(raw, cfg, **kw)
    assert len(TP._TABLES) == 1
    warm = TP.isp_process(raw, cfg, **kw)
    _clear_tables()
    cleared = TP.isp_process(raw, cfg, **kw)
    assert torch.equal(warm, cold) and torch.equal(cleared, cold)


def test_configs_share_masks_and_keep_their_own_tables():
    """Two cameras differing in white balance and vignette share one set
    of Bayer masks (the same tensors) and keep their own gains; a second
    size is an entry of its own."""
    a = TP.IspConfig(**FULL)
    b = dataclasses.replace(a, white_balance_gain=(1.1, 1.0, 1.6),
                            vignette_rolloff_h=((1.0, 1.0, 1.0), (1.1, 1.1, 1.1)))
    raw = torch.from_numpy(smooth_raw((32, 40), seed=9))
    _clear_tables()
    out_a, out_b = TP.isp_process(raw, a), TP.isp_process(raw, b)
    assert not torch.equal(out_a, out_b)
    cpu = torch.device("cpu")
    ta, tb = TP._tables(a, 32, 40, cpu), TP._tables(b, 32, 40, cpu)
    assert len(TP._TABLES) == 2
    assert all(x is y for x, y in zip(ta.masks, tb.masks))
    for got, want in zip(ta.masks, TP.bayer_masks(a, 32, 40)):
        assert np.array_equal(got.numpy(), want)
    assert [float(g) for g in ta.gain] == [np.float32(v) for v in a.white_balance_gain]
    assert [float(g) for g in tb.gain] == [np.float32(v) for v in b.white_balance_gain]
    assert not torch.equal(ta.vh, tb.vh) and torch.equal(ta.vv, tb.vv)
    vh, vv = TP.build_vignette_gains(b, 32, 40)
    assert np.array_equal(tb.vh.numpy(), vh) and np.array_equal(tb.vv.numpy(), vv)
    tc = TP._tables(a, 16, 20, cpu)
    assert len(TP._TABLES) == 3 and tc.masks[0].shape == (16, 20)


def test_batched_call_on_warm_tables_equals_per_frame():
    """Every frame of a batch shares the tables of its plane size: a
    batched call after per-frame calls equals them."""
    cfg = TP.IspConfig(**FULL)
    raw = torch.from_numpy(smooth_raw((3, 32, 40), seed=10))
    _clear_tables()
    frames = [TP.isp_process(raw[i], cfg) for i in range(3)]
    batched = TP.isp_process(raw, cfg)
    assert len(TP._TABLES) == 1
    for i in range(3):
        assert float((batched[i] - frames[i]).abs().max()) <= 1e-6


def test_tables_span_counts_miss_then_hit():
    from surround360_tpu_torch.utils import tracing

    cfg = TP.IspConfig(**FULL)
    raw = torch.from_numpy(smooth_raw((32, 40), seed=11))
    _clear_tables()
    with tracing.recording():
        for shape in ((32, 40), (32, 40), (16, 20), (32, 40)):
            TP.isp_process(raw[: shape[0], : shape[1]], cfg)
    counts = [s.counts for s in tracing.session() if s.name == "isp.tables"]
    assert counts == [{"isp.tables.miss": 1}, {"isp.tables.hit": 1},
                      {"isp.tables.miss": 1}, {"isp.tables.hit": 1}]
    assert tracing.totals()["isp"]["counts"] == {"isp.tables.miss": 2, "isp.tables.hit": 2}


def test_tables_cache_keeps_the_last_used():
    """Bounded at TABLES_KEEP entries, least recently used out first."""
    cpu = torch.device("cpu")
    cfgs = [TP.IspConfig(white_balance_gain=(1.0 + i / 100, 1.0, 1.0))
            for i in range(TP.TABLES_KEEP + 1)]
    _clear_tables()
    for c in cfgs[:-1]:
        TP._tables(c, 8, 8, cpu)
    first = TP._tables(cfgs[0], 8, 8, cpu)  # a hit: now the last used
    TP._tables(cfgs[-1], 8, 8, cpu)
    assert len(TP._TABLES) == TP.TABLES_KEEP
    keys = [k[0] for k in TP._TABLES]
    assert cfgs[1] not in keys and keys[-2:] == [cfgs[0], cfgs[-1]]
    assert TP._tables(cfgs[0], 8, 8, cpu) is first


def test_companding_matches_jax_interp():
    """jnp.interp by torch.searchsorted: inside the table, on its knots,
    beyond both ends; within 1e-6."""
    lut = ((0.1, 0.0, 9.0), (0.3, 0.5, 9.0), (0.3, 0.6, 9.0), (0.8, 0.9, 9.0), (0.9, 1.0, 9.0))
    jc, tc = both(companding_lut=lut)
    x = np.concatenate([np.linspace(-0.2, 1.2, 57), [0.1, 0.3, 0.8, 0.9]]).astype(np.float32)
    x = x.reshape(1, -1)
    want = np.asarray(JP.apply_companding(jnp.asarray(x), jc))
    got = TP.apply_companding(torch.from_numpy(x), tc).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6
    assert got[0, 0] == 0.0 and got[0, 56] == 1.0  # end values beyond the ends


ORACLE_CONFIGS = [
    dict(bayer_pattern="GBRG", demosaic_filter="bilinear", bits_per_pixel=8,
         **{k: v for k, v in FULL.items() if k not in (
             "bayer_pattern", "bits_per_pixel", "sharpening", "sharpening_support",
             "noise_core", "black_level")}, black_level=(10.0, 12.0, 14.0)),
    dict(bayer_pattern="RGGB", demosaic_filter="bilinear", black_level=(4.0, 4.0, 4.0),
         bits_per_pixel=12, white_balance_gain=(2.0, 1.0, 1.4), saturation=0.8,
         ccm=((1.2, -0.1, -0.1), (-0.05, 1.1, -0.05), (-0.1, -0.2, 1.3))),
]


@pytest.mark.parametrize("cfg", ORACLE_CONFIGS, ids=["gbrg-full", "rggb-linearish"])
def test_isp_matches_scalar_oracle(cfg):
    """The per-pixel oracle transliterated from the reference's C++ (it
    imports no JAX), as tests/test_oracle_isp.py holds the JAX package:
    >= 40 dB, and off by more than 2e-3 (a LUT index at a bin edge) on
    < 1% of values."""
    cfg = TP.IspConfig(**cfg)
    raw = np.random.default_rng(7).uniform(0.0, 1.0, (24, 32)).astype(np.float32)
    ours = TP.isp_process(torch.from_numpy(raw), cfg, skip_sharpen=True).numpy()
    ref = oracle_isp(raw, cfg)
    assert ours.shape == ref.shape == (3, 24, 32)
    mse = float(np.mean((ours - ref) ** 2))
    assert -10.0 * np.log10(max(mse, 1e-20)) >= 40.0
    assert np.mean(np.abs(ours - ref) > 2e-3) < 0.01


def test_raw_conversion_and_packing_equal_jax():
    rng = np.random.default_rng(0)
    h, w = 10, 16
    buf8 = rng.integers(0, 256, h * w, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(TI.convert_8bit_frame(buf8, w, h), JI.convert_8bit_frame(buf8, w, h))
    vals = rng.integers(0, 4096, (h, w)).astype(np.uint16)
    packed = TI.pack_12bit_frame(vals)
    assert packed == JI.pack_12bit_frame(vals) and len(packed) == h * w * 3 // 2
    got = TI.convert_12bit_frame(packed, w, h)
    np.testing.assert_array_equal(got, JI.convert_12bit_frame(packed, w, h))
    np.testing.assert_array_equal(got >> 4, vals)  # 4-bit replication below
    buf16 = rng.integers(0, 65536, h * w).astype("<u2").tobytes()
    np.testing.assert_array_equal(
        TI.convert_16bit_frame(buf16, w, h), JI.convert_16bit_frame(buf16, w, h))
    with pytest.raises(ValueError, match="even width"):
        TI.pack_12bit_frame(vals[:, :5])


@pytest.mark.parametrize("bpp", [8, 12, 16])
def test_footage_bytes_equal_jax_and_read_back(tmp_path, bpp):
    rng = np.random.default_rng(bpp)
    h, w, serials = 8, 12, [4242, 17, 900001]
    size = w * h * bpp // 8
    frames = [[rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in serials]
              for _ in range(3)]
    jp, tp = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    JI.write_footage_file(jp, frames, w, h, bpp, serials, timestamp=7, file_index=1, file_count=2)
    TI.write_footage_file(tp, frames, w, h, bpp, serials, timestamp=7, file_index=1, file_count=2)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    jr, tr = JI.BinaryFootageReader(jp), TI.BinaryFootageReader(jp)
    assert dataclasses.asdict(tr.metadata) == dataclasses.asdict(jr.metadata)
    assert (tr.num_cameras, tr.num_frames) == (jr.num_cameras, jr.num_frames) == (3, 3)
    for cam, serial in enumerate(serials):
        assert tr.get_serial(2, cam) == jr.get_serial(2, cam) == serial
        np.testing.assert_array_equal(tr.get_raw_uint16(1, cam), jr.get_raw_uint16(1, cam))
    with pytest.raises(ValueError, match="frame size"):
        TI.write_footage_file(tp, [[b"short"] * 3], w, h, bpp, serials)
    (tmp_path / "bad.bin").write_bytes(b"\0" * 5000)
    with pytest.raises(ValueError, match="magic"):
        TI.BinaryFootageReader(str(tmp_path / "bad.bin"))


def test_dng_bytes_equal_jax(tmp_path):
    from surround360_tpu.cli.dng_helper import save_isp_dng as jax_save
    from surround360_tpu_torch.cli.dng_helper import save_isp_dng

    raw = np.random.default_rng(0).integers(0, 65536, (12, 16)).astype(np.uint16)
    jp, tp = str(tmp_path / "j.dng"), str(tmp_path / "t.dng")
    kw = dict(bayer_pattern="RGGB", ccm=np.asarray(FULL["ccm"]), white_balance=(1.3, 1.0, 1.8),
              black_level=48, white_level=4095)
    JDng.write_dng(jp, raw, **kw)
    TDng.write_dng(tp, raw, **kw)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    jc, tc = both(**FULL)
    rawf = raw.astype(np.float32) / 65535.0  # a float mosaic is rescaled to 16 bits
    jax_save(jp, rawf, jc)
    save_isp_dng(tp, rawf, tc)
    assert open(tp, "rb").read() == open(jp, "rb").read()


def test_native_converters_equal_numpy(tmp_path):
    """The C++ library (built with g++ at first use) against the numpy
    paths, and the streaming writer against write_footage_file."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    assert native.available()
    rng = np.random.default_rng(1)
    h, w = 14, 20
    vals = rng.integers(0, 4096, (h, w)).astype(np.uint16)
    packed = native.pack12_native(vals)
    buf8 = rng.integers(0, 256, h * w, dtype=np.uint8).tobytes()
    got12, got8 = native.convert12_native(packed, w, h), native.convert8_native(buf8, w, h)
    assert packed == TRaw.pack_12bit_frame(vals)
    np.testing.assert_array_equal(got12, TRaw.convert_12bit_numpy(packed, w, h))
    np.testing.assert_array_equal(got8, TRaw.convert_8bit_numpy(buf8, w, h))
    np.testing.assert_array_equal(got12, TRaw.convert_12bit_frame(packed, w, h))
    serials = [5, 6]
    frames = [[rng.integers(0, 256, len(packed), dtype=np.uint8).tobytes() for _ in serials]
              for _ in range(2)]
    TI.write_footage_file(str(tmp_path / "py.bin"), frames, w, h, 12, serials, timestamp=3)
    with native.NativeFootageWriter(str(tmp_path / "cc.bin"), w, h, 12, serials, timestamp=3) as wr:
        for frame in frames:
            for cam, payload in enumerate(frame):
                wr.write_frame(cam, payload)
        with pytest.raises(ValueError, match="frame size"):
            wr.write_frame(0, b"short")
    assert (tmp_path / "cc.bin").read_bytes() == (tmp_path / "py.bin").read_bytes()
    with pytest.raises(ValueError, match="need"):
        native.convert8_native(buf8[:10], w, h)


def test_native_build_failure_is_not_swallowed(tmp_path, monkeypatch):
    """Without a compiler available() says False, raw.py takes its numpy
    path, and a call that needs the library raises with the reason."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.available()
    vals = np.arange(32, dtype=np.uint16).reshape(4, 8)
    packed = TRaw.pack_12bit_frame(vals)
    np.testing.assert_array_equal(TRaw.convert_12bit_frame(packed, 8, 4) >> 4, vals)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.pack12_native(vals)
    with pytest.raises(RuntimeError, match="native footage library unavailable"):
        native.NativeFootageWriter(str(tmp_path / "x.bin"), 8, 4, 12, [1])
    # a compiler that fails: its message is in the error
    monkeypatch.setattr(native, "_error", None)
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'footage_io.cpp:1: error: no such toolchain' >&2\nexit 1\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="no such toolchain"):
        native.convert12_native(packed, 8, 4)
