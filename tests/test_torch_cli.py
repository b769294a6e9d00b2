"""The port's CLI layer against the JAX package's: PNG and flow files, and
the render_video frame loop (chaining, resume, unported options).

The loop runs at the JAX package's own CLI test scale: 64 px cameras
(``make_ring_rig().rescaled(0.03125)``), a 140x70 equirect per eye, both
poles, and ``pixflow_tpu_offsets`` on the ring and the poles.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from surround360_tpu.capture import render_camera_views
from surround360_tpu.cli import common as JC
from surround360_tpu.cli import render_video as JRV
from surround360_tpu.geometry.rig import make_ring_rig, save_rig
from surround360_tpu.render.panorama import RenderConfig as JaxConfig
from surround360_tpu_torch.cli import common as TC
from surround360_tpu_torch.cli import render_video as TRV
from surround360_tpu_torch.render.panorama import RenderConfig

PSNR_MIN = 40.0


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
@pytest.mark.parametrize("bit_depth", [8, 16])
def test_png_round_trips_with_jax_cv2(tmp_path, channels, bit_depth):
    """Files written by either package read to identical arrays in both."""
    img = np.random.default_rng(bit_depth + channels).random((channels, 23, 37))
    img = img.astype(np.float32)
    img[:, 4:12, 3:20] = 0.4  # flat patches: the writer picks other filters
    jpath, tpath = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    JC.write_image(jpath, img, bit_depth=bit_depth)
    TC.write_image(tpath, img, bit_depth=bit_depth)
    for path in (jpath, tpath):
        want = JC.read_image_rgba(path)
        got = TC.read_image_rgba(path)
        assert got.dtype == np.float32 and got.shape == (4, 23, 37)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TC.read_image_rgba(tpath), JC.read_image_rgba(jpath))


def _png_with_filters(path, samples, bpp):
    """A PNG of (H, W*C) 8-bit samples whose row y uses filter y % 5."""
    H, stride = samples.shape
    x = samples.astype(np.int32)
    rows = []
    for y in range(H):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        kind = y % 5
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - up_left
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    W = stride // bpp
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        f.write(chunk(b"IEND", b""))


def test_png_reads_every_filter(tmp_path):
    rng = np.random.default_rng(7)
    samples = rng.integers(0, 256, (10, 3 * 19), dtype=np.uint8)
    path = str(tmp_path / "filters.png")
    _png_with_filters(path, samples, 3)
    want = JC.read_image_rgba(path)  # cv2 as the reference decoder
    got = TC.read_image_rgba(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[:3], np.moveaxis(samples.reshape(10, 19, 3), -1, 0) / np.float32(255.0)
    )


def test_png_grey_and_unsupported(tmp_path):
    grey = np.random.default_rng(3).random((1, 9, 11)).astype(np.float32)
    path = str(tmp_path / "g.png")
    TC.write_image(path, grey, bit_depth=16)
    np.testing.assert_array_equal(TC.read_image_rgba(path), JC.read_image_rgba(path))
    with pytest.raises(ValueError, match="only PNG"):
        TC.write_image(str(tmp_path / "x.jpg"), grey)
    bad = str(tmp_path / "interlaced.png")
    blob = bytearray(open(path, "rb").read())
    blob[28] = 1  # IHDR interlace byte (its CRC is not checked)
    open(bad, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="interlace 1"):
        TC.read_image_rgba(bad)
    with pytest.raises(FileNotFoundError):
        TC.read_image_rgba(str(tmp_path / "missing.png"))


def test_save_flow_bytes_equal_jax(tmp_path):
    flow = np.random.default_rng(0).normal(size=(2, 12, 20)).astype(np.float32)
    JC.save_flow(str(tmp_path / "j.bin"), flow)
    TC.save_flow(str(tmp_path / "t.bin"), flow)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    np.testing.assert_array_equal(TC.load_flow(str(tmp_path / "j.bin")), flow)


# feathers cut to the 64 px cameras: the default 100 / 31 px leave no
# alpha above the flow's 0.9 update gate, and every flow would stay 0
KW = dict(eqr_width=140, eqr_height=70, enable_top=True, enable_bottom=True,
          side_flow_alg="pixflow_tpu_offsets", polar_flow_alg="pixflow_tpu_offsets",
          side_alpha_feather_size=8, std_alpha_feather_size=9)


@pytest.fixture(scope="module")
def footage(tmp_path_factory):
    """Three frames of camera PNGs (the scene drifts a pixel per frame),
    and the JAX package's render of them with its state pickles."""
    root = tmp_path_factory.mktemp("footage")
    rig = make_ring_rig().rescaled(0.03125)  # 64 px cameras
    rig_path = str(root / "rig.json")
    save_rig(rig_path, rig)
    views = render_camera_views(rig)
    for frame in range(3):
        for i, cam_id in enumerate(rig.ids):
            d = root / "imgs" / cam_id
            d.mkdir(parents=True, exist_ok=True)
            img = np.asarray(views[i]).copy()
            img[:3] = np.roll(img[:3], frame, axis=-1)
            JC.write_image(str(d / f"{frame:06d}.png"), img)
    jax_out = str(root / "jax")
    JRV.render_video(rig_path, str(root / "imgs"), jax_out, 0, 2, JaxConfig(**KW),
                     save_state_dir=str(root / "jax_state"))
    return root, rig_path


def _eqr(out_dir, frame):
    return TC.read_image_rgba(os.path.join(out_dir, "eqr_frames", f"eqr_{frame:06d}.png"))


def test_render_video_matches_jax_and_resumes(footage):
    """The port's frame loop against the JAX package's on the same camera
    PNGs, a chain 0..2 against 0..1 + resume at 2, and a resume from the
    JAX package's state pickle."""
    root, rig_path = footage
    imgs = str(root / "imgs")
    chained = str(root / "chained")
    st_chained = TRV.render_video(rig_path, imgs, chained, 0, 2, RenderConfig(**KW),
                                  save_state_dir=str(root / "state"), device="cpu")
    states = sorted(os.listdir(root / "state"))
    assert states == ["state_000001.pkl", "state_000002.pkl"]  # frame 0 GC'd
    for frame in range(3):
        got, want = _eqr(chained, frame), _eqr(str(root / "jax"), frame)
        assert got.shape == want.shape == (4, 140, 140)
        assert psnr(got[:3], want[:3]) >= PSNR_MIN, frame

    split = str(root / "split")
    TRV.render_video(rig_path, imgs, split, 0, 1, RenderConfig(**KW),
                     save_state_dir=str(root / "split_state"), device="cpu")
    st_split = TRV.render_video(
        rig_path, imgs, split, 2, 2, RenderConfig(**KW),
        resume_state=str(root / "split_state" / "state_000001.pkl"), device="cpu")
    np.testing.assert_array_equal(_eqr(split, 2), _eqr(chained, 2))
    # frame 2 without its temporal prior computes other flows
    st_fresh = TRV.render_video(rig_path, imgs, str(root / "fresh"), 2, 2,
                                RenderConfig(**KW), device="cpu")
    # (the pole states' prev_side holds NaN rows at this scale, as in the
    # JAX package's pickles; nothing reads them)
    same = lambda a, b: np.array_equal(a.numpy(), b.numpy(), equal_nan=True)
    for k, v in st_chained.items():
        assert same(st_split[k], v), k
    for k in ("pair_flow_ltr", "pair_flow_rtl"):  # the pole flows are 8 rows
        assert float(st_chained[k].abs().mean()) > 0.05, k  # real flows
        assert not same(st_fresh[k], st_chained[k]), k

    from_jax = str(root / "from_jax")
    TRV.render_video(rig_path, imgs, from_jax, 2, 2, RenderConfig(**KW),
                     resume_state=str(root / "jax_state" / "state_000001.pkl"),
                     device="cpu")
    assert psnr(_eqr(from_jax, 2)[:3], _eqr(str(root / "jax"), 2)[:3]) >= PSNR_MIN


def test_render_video_stage_times(tmp_path, footage):
    """The loop's StageTimer gets one entry per frame for each stage, the
    loop time once, and totals that sum the entries."""
    root, rig_path = footage
    timer = TC.StageTimer()
    TRV.render_video(rig_path, str(root / "imgs"), str(tmp_path / "out"), 0, 1,
                     RenderConfig(**KW), save_state_dir=str(tmp_path / "state"),
                     timer=timer, device="cpu")
    totals = timer.totals()
    per_frame = ("decode", "wait_inputs", "render", "fetch", "encode", "save_state")
    assert {name: totals[name][0] for name in per_frame} == dict.fromkeys(per_frame, 2)
    assert totals["loop"][0] == totals["drain"][0] == 1
    assert set(totals) == set(per_frame) | {"loop", "drain"}
    for name, (_, secs) in totals.items():
        assert secs == pytest.approx(sum(dt for n, dt in timer.stages if n == name))
    main_thread = ("wait_inputs", "render", "fetch", "drain")
    assert sum(totals[n][1] for n in main_thread) <= totals["loop"][1]
    assert "render:" in timer.report()


@pytest.mark.parametrize("flag", [
    ["--enable_pole_removal"], ["--cubemap_width", "64", "--cubemap_height", "32"],
    ["--save_debug_images"], ["--profile_stages"],
])
def test_unported_flags_raise_before_output(tmp_path, footage, flag):
    root, rig_path = footage
    out = tmp_path / "out"
    argv = ["--rig_json_file", rig_path, "--imgs_dir", str(root / "imgs"),
            "--output_dir", str(out), "--quality", "preview", "--device", "cpu"] + flag
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        TRV.main(argv)
    assert not out.exists()


def test_default_device_raises_without_cuda(tmp_path, footage, monkeypatch):
    """The CLI renders on CUDA by default: without it, it raises before
    any output instead of carrying on on the CPU."""
    monkeypatch.setattr(TRV.torch.cuda, "is_available", lambda: False)
    root, rig_path = footage
    out = tmp_path / "out"
    argv = ["--rig_json_file", rig_path, "--imgs_dir", str(root / "imgs"),
            "--output_dir", str(out), "--quality", "preview"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRV.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRV.render_video(rig_path, str(root / "imgs"), str(out), 0, 0,
                         RenderConfig(**KW))
    assert not out.exists()
