"""The port's CLI layer against the JAX package's: PNG and flow files, the
render_video frame loop (chaining, resume, pole removal, cubemap, debug
images, the stage table), unpack, raw2rgb and run_all.

The loop runs at the JAX package's own CLI test scale: 64 px cameras
(``make_ring_rig().rescaled(0.03125)``), a 140x70 equirect per eye, both
poles, and ``pixflow_tpu_offsets`` on the ring and the poles.
"""

import json
import logging
import os
import pickle
import struct
import zlib

import numpy as np
import pytest

from surround360_tpu import isp as JI
from surround360_tpu.capture import render_camera_views
from surround360_tpu.cli import common as JC
from surround360_tpu.cli import render_video as JRV
from surround360_tpu.cli import unpack as JU
from surround360_tpu.geometry.rig import make_ring_rig, save_rig
from surround360_tpu.isp.pipeline import bayer_masks
from surround360_tpu.render.panorama import RenderConfig as JaxConfig
from surround360_tpu_torch.cli import common as TC
from surround360_tpu_torch.cli import raw2rgb as TR2
from surround360_tpu_torch.cli import render_video as TRV
from surround360_tpu_torch.cli import run_all as TRA
from surround360_tpu_torch.cli import unpack as TU
from surround360_tpu_torch.isp import pipeline as TISP
from surround360_tpu_torch.render import profiling as TPROF
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
    with pytest.raises(ValueError, match="unsupported image format '.bmp'"):
        TC.write_image(str(tmp_path / "x.bmp"), grey)
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TU.unpack([], str(out), str(out))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TU.main(["--binary_prefix", str(out), "--dest_path", str(out), "--isp_dir", str(out)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR2.main(["--input_image_path", "x.png", "--output_image_path", str(out / "y.png"),
                  "--isp_config_path", "isp.json"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRA.main(["--dest_dir", str(out), "--steps", "unpack,render"])
    assert not out.exists()
    with pytest.raises(ValueError, match="unsupported device"):
        TC.resolve_device("meta")


# --- pole removal, cubemap, debug images, the stage table -----------------

# a 5 px feather: with 9 px the two bottom cameras' alpha never passes the
# flow's 0.9 gate at 64 px, and the pole-removal flow (and its prior) is 0
POLE_KW = dict(KW, enable_pole_removal=True, poleremoval_flow_alg="pixflow_tpu_offsets",
               cubemap_width=32, cubemap_height=32, sharpening=0.25,
               std_alpha_feather_size=5)


@pytest.fixture(scope="module")
def pole_footage(tmp_path_factory):
    """Three frames with a painted pole in both bottom cameras and red
    masks over it, as tests/test_cli.py::test_pole_state_survives_resume
    makes them (only the second bottom camera drifts, so the alignment
    flow that the pole prior regularizes changes every frame), and the JAX
    package's chained render with pole removal and a cubemap."""
    root = tmp_path_factory.mktemp("pole_footage")
    rig = make_ring_rig().rescaled(0.03125)  # 64 px cameras
    rig_path = str(root / "rig.json")
    save_rig(rig_path, rig)
    views = render_camera_views(rig)
    H, W = views[0].shape[-2:]
    cy, cx = H // 2, W // 2
    bottom2_id = rig.ids[rig.bottom_camera2_index]
    boxes = {rig.ids[rig.bottom_camera_index]: (cy - 8, cy + 8, cx - 6, cx + 6),
             bottom2_id: (cy - 22, cy - 10, cx + 8, cx + 20)}
    (root / "masks").mkdir()
    for cam_id, (y0, y1, x0, x1) in boxes.items():
        m = np.zeros((4, H, W), np.float32)
        m[0, y0:y1, x0:x1] = 1.0
        m[3] = 1.0
        JC.write_image(str(root / "masks" / f"{cam_id}.png"), m)
    for frame in range(3):
        for i, cam_id in enumerate(rig.ids):
            img = np.asarray(views[i]).copy()
            if cam_id == bottom2_id:
                img[:3] = np.roll(img[:3], 2 * frame, axis=-1)
            if cam_id in boxes:
                y0, y1, x0, x1 = boxes[cam_id]
                img[:3, y0:y1, x0:x1] = 0.05
            d = root / "imgs" / cam_id
            d.mkdir(parents=True, exist_ok=True)
            JC.write_image(str(d / f"{frame:06d}.png"), img)
    JRV.render_video(rig_path, str(root / "imgs"), str(root / "jax"), 0, 2,
                     JaxConfig(**POLE_KW), pole_masks_dir=str(root / "masks"),
                     save_state_dir=str(root / "jax_state"))
    return root, rig_path, rig


def _frame(out_dir, kind, frame):
    return TC.read_image_rgba(
        os.path.join(out_dir, "eqr_frames", f"{kind}_{frame:06d}.png"))[:3]


def test_pole_mask_reader_equals_jax(pole_footage):
    root, _, rig = pole_footage
    for cam_id in (rig.ids[rig.bottom_camera_index], "no_such_camera"):
        got = TRV._load_pole_mask(str(root / "masks"), cam_id, (64, 64))
        np.testing.assert_array_equal(
            got, JRV._load_pole_mask(str(root / "masks"), cam_id, (64, 64)))
        assert got.dtype == bool and got.shape == (64, 64)
    assert got.sum() == 0 and TRV._load_pole_mask(None, "cam15", (3, 4)).shape == (3, 4)
    assert TRV._load_pole_mask(str(root / "masks"), "cam15", (64, 64)).sum() == 16 * 12


def test_render_video_pole_removal_and_cubemap_match_jax(pole_footage):
    """The port's loop with pole removal and a cubemap against the JAX
    CLI's on the same PNGs and masks: equirect and cubemap frames at >= 40
    dB; the chain 0..2 equals 0..1 + resume at 2 bit for bit, which a
    pole prior lost on resume would break (frame 2 without it differs)."""
    root, rig_path, _ = pole_footage
    imgs, masks = str(root / "imgs"), str(root / "masks")
    run = lambda out, a, b, **kw: TRV.render_video(
        rig_path, imgs, str(root / out), a, b, RenderConfig(**POLE_KW),
        pole_masks_dir=masks, device="cpu", **kw)
    run("chained", 0, 2, save_state_dir=str(root / "state"))
    for frame in range(3):
        for kind, shape in (("eqr", (3, 140, 140)), ("cube", (3, 2 * 2 * 32, 3 * 32))):
            got = _frame(str(root / "chained"), kind, frame)
            want = _frame(str(root / "jax"), kind, frame)
            assert got.shape == want.shape == shape
            assert psnr(got, want) >= PSNR_MIN, (kind, frame)
    with open(root / "state" / "state_000002.pkl", "rb") as f:
        blob = pickle.load(f)
    with open(root / "jax_state" / "state_000002.pkl", "rb") as f:
        jax_blob = pickle.load(f)
    assert set(blob) == set(jax_blob)
    for k in ("pole:pole_flow", "pole:prev_bottom", "pole:prev_bottom2"):
        assert blob[k].dtype == np.float32 and blob[k].shape == jax_blob[k].shape, k
    assert float(np.abs(blob["pole:pole_flow"]).max()) > 0.1  # a real alignment flow

    run("split", 0, 1, save_state_dir=str(root / "split_state"))
    run("split", 2, 2, resume_state=str(root / "split_state" / "state_000001.pkl"))
    for kind in ("eqr", "cube"):
        np.testing.assert_array_equal(_frame(str(root / "split"), kind, 2),
                                      _frame(str(root / "chained"), kind, 2))
    # the pole prior alone: the same resume without the "pole:" keys
    with open(root / "split_state" / "state_000001.pkl", "rb") as f:
        ring_only = {k: v for k, v in pickle.load(f).items() if not k.startswith("pole:")}
    with open(root / "ring_only.pkl", "wb") as f:
        pickle.dump(ring_only, f)
    run("no_pole_prior", 2, 2, resume_state=str(root / "ring_only.pkl"))
    assert not np.array_equal(_frame(str(root / "no_pole_prior"), "eqr", 2),
                              _frame(str(root / "chained"), "eqr", 2))


def test_pole_state_pickles_interchange_with_jax(pole_footage):
    """Frame 2 resumed from the other package's frame-1 pickle, both ways,
    against the JAX package's chained frame 2 at >= 40 dB."""
    root, rig_path, _ = pole_footage
    imgs, masks = str(root / "imgs"), str(root / "masks")
    if not (root / "split_state" / "state_000001.pkl").exists():
        TRV.render_video(rig_path, imgs, str(root / "split"), 0, 1, RenderConfig(**POLE_KW),
                         pole_masks_dir=masks, device="cpu",
                         save_state_dir=str(root / "split_state"))
    TRV.render_video(rig_path, imgs, str(root / "port_from_jax"), 2, 2,
                     RenderConfig(**POLE_KW), pole_masks_dir=masks, device="cpu",
                     resume_state=str(root / "jax_state" / "state_000001.pkl"))
    JRV.render_video(rig_path, imgs, str(root / "jax_from_port"), 2, 2,
                     JaxConfig(**POLE_KW), pole_masks_dir=masks,
                     resume_state=str(root / "split_state" / "state_000001.pkl"))
    for out in ("port_from_jax", "jax_from_port"):
        for kind in ("eqr", "cube"):
            assert psnr(_frame(str(root / out), kind, 2),
                        _frame(str(root / "jax"), kind, 2)) >= PSNR_MIN, (out, kind)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_debug_image_tree_equals_jax(tmp_path, pole_footage):
    """--save_debug_images: the same files as the JAX CLI writes (the side
    projections, the ring panoramas, each pole's strip and per-eye warped
    layer), the layers themselves at >= 40 dB, and the frame is the one
    the un-merged pole route renders."""
    root, rig_path, rig = pole_footage
    imgs, masks = str(root / "imgs"), str(root / "masks")
    JRV.render_video(rig_path, imgs, str(tmp_path / "jax"), 0, 0, JaxConfig(**POLE_KW),
                     pole_masks_dir=masks, save_debug_images=True)
    TRV.render_video(rig_path, imgs, str(tmp_path / "port"), 0, 0, RenderConfig(**POLE_KW),
                     pole_masks_dir=masks, save_debug_images=True, device="cpu")
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want
    names = [os.path.basename(p) for p in got if p.startswith("debug")]
    assert len(names) == 14 + 2 + 2 + 4 and "crop_cam1.png" in names
    assert {"spherical_l.png", "top_strip.png", "bottom_warped_right.png"} <= set(names)
    for rel in got:
        a = TC.read_image_rgba(str(tmp_path / "port" / rel))
        b = TC.read_image_rgba(str(tmp_path / "jax" / rel))
        assert a.shape == b.shape and psnr(a, b) >= PSNR_MIN, rel


def test_profile_stages_prints_every_stage(tmp_path, pole_footage, caplog):
    """--profile_stages renders with tracing on and logs each rendered
    frame's stage table, read from that frame's spans: the frame, every
    stage of render.profiling, then the flow by site and pyramid level,
    each with its host and stream milliseconds and share of the frame."""
    root, rig_path, _ = pole_footage
    with caplog.at_level(logging.INFO, logger="surround360_tpu_torch"):
        TRV.render_video(rig_path, str(root / "imgs"), str(tmp_path / "out"), 0, 1,
                         RenderConfig(**dict(KW, sharpening=0.25)), profile_stages=True,
                         device="cpu")
    tables = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("stage breakdown")]
    assert [t.split()[4] for t in tables] == ["000000", "000001"]
    for table in tables:
        lines = table.splitlines()[1:]
        names = [ln.split()[0] for ln in lines]
        assert names[:6] == ["frame", *TPROF.STAGES]
        flows = names[6:]
        assert flows and all(n.startswith(("flow.side_flow.L", "flow.pole_flow.L"))
                             for n in flows)
        assert {"flow.side_flow.L0", "flow.pole_flow.L0"} <= set(flows)
        assert all(" ms host" in ln and "n/a ms stream" in ln and "% of frame" in ln
                   for ln in lines)
        assert lines[0].split()[1] != "0.00"
    assert os.path.exists(tmp_path / "out" / "eqr_frames" / "eqr_000001.png")


def test_stage_breakdown_selects_stages_and_counts_launches(monkeypatch):
    """The table reads a traced frame's spans: each stage once per frame
    (``novel_view``'s spans summed), shares of the frame's host time, the
    flow by level with one finest level per call, and the launches that
    the wrappers count into the innermost span (here: a stub that counts
    through the wrappers' counter, since the CPU twins launch nothing)."""
    import collections

    import torch

    from surround360_tpu_torch import cuda_build
    from surround360_tpu_torch.geometry.rig import make_ring_rig as port_rig
    from surround360_tpu_torch.ops import fused_window as fw
    from surround360_tpu_torch.render.panorama import build_render_context, render_frame
    from surround360_tpu_torch.utils import tracing

    monkeypatch.setattr(cuda_build, "LAUNCHES", collections.Counter())
    rig = port_rig().rescaled(0.03125)
    ctx = build_render_context(rig, RenderConfig(**dict(KW, side_flow_alg="pixflow_tpu",
                                                        enable_top=False,
                                                        enable_bottom=False)))
    side = torch.rand((14, 4, 64, 64), generator=torch.Generator().manual_seed(0))
    real = fw.fused_window_sample

    def counting(*a, site="", **k):
        cuda_build._count(fw.K1, site)
        return real(*a, site=site, **k)

    monkeypatch.setattr("surround360_tpu_torch.ops.remap.fused_window_sample", counting)
    with tracing.recording():
        render_frame(ctx, side)
        rows = TPROF.stage_breakdown(tracing.session())
    assert list(rows)[:6] == ["frame", *TPROF.STAGES]
    assert rows["frame"]["share"] == 1.0
    assert sum(rows[s]["share"] for s in TPROF.STAGES) <= 1.0
    assert rows["projection"]["launches"] == {fw.K1: 1}
    assert rows["frame"]["launches"] == {fw.K1: 1} and not rows["side_flow"]["launches"]
    assert cuda_build.LAUNCHES[(fw.K1, "side_projection")] == 1
    levels = [r for r in rows if r.startswith("flow.side_flow.L")]
    assert levels[-1] == "flow.side_flow.L0"
    table = TPROF.format_breakdown(rows)
    assert "fused_window_sample x1" in table and "% of frame" in table
    with pytest.raises(ValueError, match="no frame span"):
        TPROF.stage_breakdown(tracing.session(), frame=-1)


# --- unpack, raw2rgb, run_all ---------------------------------------------

ISP_KW = dict(bayer_pattern="GBRG", bits_per_pixel=12, black_level=(40.0, 48.0, 56.0),
              white_balance_gain=(1.2, 1.0, 1.5), gamma=(0.8, 0.8, 0.8),
              ccm=((1.1, -0.05, -0.05), (-0.05, 1.1, -0.05), (0.0, -0.1, 1.1)),
              vignette_rolloff_h=((1.0, 1.0, 1.0), (1.1, 1.1, 1.1), (1.0, 1.0, 1.0)),
              sharpening=(0.3, 0.3, 0.3))


@pytest.fixture(scope="module")
def capture_tree(tmp_path_factory):
    """A 2-frame capture as tests/test_cli.py::capture_tree makes it (rig
    JSON, 12-bit .bin footage of the 17 cameras, per-serial ISP JSONs),
    written with the port's writers, with a non-trivial ISP config, and
    the serials in another order than the cameras."""
    from surround360_tpu_torch import isp as TI

    root = tmp_path_factory.mktemp("capture")
    rig = make_ring_rig().rescaled(0.03125)
    rig_path = str(root / "rig.json")
    save_rig(rig_path, rig)
    views = render_camera_views(rig)
    cfg = TISP.IspConfig(**ISP_KW)
    H, W = views[0].shape[-2:]
    red, green, _, _ = bayer_masks(cfg, H, W)
    serials = [10000 + i for i in range(len(rig.cameras))]
    (root / "isp").mkdir()
    for serial in serials:
        (root / "isp" / f"{serial}.json").write_text(json.dumps(cfg.to_json()))
    payloads = []
    for v in views:
        mosaic = np.where(red, v[0], np.where(green, v[1], v[2]))
        payloads.append(TI.pack_12bit_frame(
            np.clip(mosaic * 4095.0 + 0.5, 0, 4095).astype(np.uint16)))
    (root / "bins").mkdir()
    TI.write_footage_file(str(root / "bins" / "0.bin"), [payloads, payloads], W, H, 12, serials)
    JI.write_footage_file(str(root / "jax.bin"), [payloads, payloads], W, H, 12, serials)
    assert (root / "jax.bin").read_bytes() == (root / "bins" / "0.bin").read_bytes()
    return dict(root=root, rig_path=rig_path, isp_dir=str(root / "isp"),
                bins=str(root / "bins"), views=views)


@pytest.mark.parametrize("bpp", [8, 16])
def test_unpack_matches_jax(capture_tree, bpp):
    """The same camera names, and every PNG within 1/255 (8 bit: one code
    where a value rounds the other way) or 2e-3 (16 bit: one tone-LUT
    entry) of the JAX package's unpack of the same footage."""
    root = capture_tree["root"]
    bins = [os.path.join(capture_tree["bins"], "0.bin")]
    want = JU.unpack(bins, str(root / f"jax{bpp}"), capture_tree["isp_dir"], output_bpp=bpp)
    timer = TC.StageTimer()
    got = TU.unpack(bins, str(root / f"port{bpp}"), capture_tree["isp_dir"],
                    output_bpp=bpp, device="cpu", timer=timer)
    assert got == want == [f"cam{i}" for i in range(17)]
    assert _tree(root / f"port{bpp}") == _tree(root / f"jax{bpp}")
    assert len(_tree(root / f"port{bpp}")) == 17 * 2
    bound = 1.0 / 255 + 1e-6 if bpp == 8 else 2e-3
    for rel in _tree(root / f"port{bpp}"):
        a = TC.read_image_rgba(str(root / f"port{bpp}" / rel))
        b = JC.read_image_rgba(str(root / f"jax{bpp}" / rel))
        assert a.shape == b.shape == (4, 64, 64)
        assert float(np.abs(a - b).max()) <= bound, rel
    totals = timer.totals()
    assert {k: totals[k][0] for k in ("read", "isp", "write", "drain")} == \
        {"read": 17, "isp": 17, "write": 34, "drain": 1}
    # a frame range: frames [1, 2) only
    only = TU.main(["--binary_prefix", capture_tree["bins"], "--dest_path",
                    str(root / f"range{bpp}"), "--isp_dir", capture_tree["isp_dir"],
                    "--start_frame", "1", "--frame_count", "1", "--device", "cpu"])
    assert only == want
    assert os.listdir(root / f"range{bpp}" / "cam3") == ["000001.png"]


def test_unpacked_rgb_reads_as_rgba_like_jax(capture_tree):
    """unpack writes 3-channel PNGs where the render loop reads RGBA: the
    port's reader fills alpha with 1, as the JAX package's does."""
    root = capture_tree["root"]
    path = str(root / "port16" / "cam0" / "000000.png")
    if not os.path.exists(path):
        TU.unpack([os.path.join(capture_tree["bins"], "0.bin")], str(root / "port16"),
                  capture_tree["isp_dir"], output_bpp=16, device="cpu")
    assert TC.read_png(path).shape == (64, 64, 3) and TC.read_png(path).dtype == np.uint16
    got = TC.read_image_rgba(path)
    np.testing.assert_array_equal(got, JC.read_image_rgba(path))
    assert np.all(got[3] == 1.0)


def test_raw2rgb_matches_the_pipeline_and_writes_a_dng(tmp_path):
    """raw2rgb on a 16-bit mosaic PNG: the written RGB equals isp_process
    on the same plane with the flags applied; the DNG is the helper's."""
    import dataclasses

    import torch

    from surround360_tpu_torch.cli.dng_helper import save_isp_dng

    rng = np.random.default_rng(0)
    raw = (rng.random((32, 48)) * 65535).astype(np.uint16)
    TC.write_png(str(tmp_path / "raw.png"), raw[..., None])
    cfg = TISP.IspConfig(**ISP_KW)
    (tmp_path / "isp.json").write_text(json.dumps(cfg.to_json()))
    TR2.main(["--input_image_path", str(tmp_path / "raw.png"), "--output_image_path",
              str(tmp_path / "rgb.png"), "--isp_config_path", str(tmp_path / "isp.json"),
              "--output_dng_path", str(tmp_path / "raw.dng"), "--demosaic_filter",
              "bilinear", "--disable_tone_curve", "--output_bpp", "16", "--device", "cpu"])
    cfg = dataclasses.replace(TISP.load_isp_config(str(tmp_path / "isp.json")),
                              demosaic_filter="bilinear", disable_tone_curve=True)
    want = TISP.isp_process(torch.from_numpy(raw.astype(np.float32) / 65535.0), cfg).numpy()
    got = TC.read_image_rgba(str(tmp_path / "rgb.png"))[:3]
    assert float(np.abs(got - want).max()) <= 1.0 / 65535 + 1e-7
    save_isp_dng(str(tmp_path / "want.dng"), raw, cfg)
    assert (tmp_path / "raw.dng").read_bytes() == (tmp_path / "want.dng").read_bytes()
    assert (tmp_path / "raw.dng").read_bytes()[:4] == b"II*\0"
    # a colour file: the JAX tool's OpenCV reader hands it BGR and it takes
    # channel 0, the blue one; both tools on the same file, within 1/255
    from surround360_tpu.cli import raw2rgb as JR2

    rgb8 = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    TC.write_png(str(tmp_path / "colour.png"), rgb8)
    argv = ["--input_image_path", str(tmp_path / "colour.png"), "--isp_config_path",
            str(tmp_path / "isp.json"), "--demosaic_filter", "bilinear"]
    JR2.main(argv + ["--output_image_path", str(tmp_path / "j.png")])
    TR2.main(argv + ["--output_image_path", str(tmp_path / "t.png"), "--device", "cpu"])
    diff = np.abs(TC.read_image_rgba(str(tmp_path / "t.png"))
                  - TC.read_image_rgba(str(tmp_path / "j.png")))
    assert float(diff.max()) <= 1.0 / 255 + 1e-6


def test_run_all_unpacks_and_renders(capture_tree, tmp_path, monkeypatch):
    """run_all --steps unpack,render on the capture, as the JAX package's
    tests/test_cli.py drives its run_all (the ring alone: run_all sets
    no feather sizes, and its defaults swallow 64 px fisheyes): the camera
    tree, the frames, the state pickles and runtimes.txt with a line per
    step."""
    monkeypatch.setitem(TRV.QUALITY_PRESETS, "preview", (140, 70, 0, 0))
    dest = tmp_path / "dest"
    TRA.main(["--steps", "unpack,render", "--binary_prefix", capture_tree["bins"],
              "--isp_dir", capture_tree["isp_dir"], "--rig_json_file",
              capture_tree["rig_path"], "--dest_dir", str(dest), "--quality", "preview",
              "--frame_count", "2", "--sharpening", "0", "--device", "cpu"])
    assert sorted(os.listdir(dest / "raw")) == sorted(f"cam{i}" for i in range(17))
    assert sorted(os.listdir(dest / "eqr_frames")) == ["eqr_000000.png", "eqr_000001.png"]
    assert sorted(os.listdir(dest / "flow_state")) == ["state_000000.pkl", "state_000001.pkl"]
    lines = (dest / "runtimes.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["unpack", "render"]
    assert all(ln.endswith(" sec") for ln in lines)
    eqr = TC.read_image_rgba(str(dest / "eqr_frames" / "eqr_000001.png"))
    assert eqr.shape == (4, 140, 140) and np.isfinite(eqr).all()
    assert float(eqr[:3].std()) > 0.05  # a picture, not a blank frame
