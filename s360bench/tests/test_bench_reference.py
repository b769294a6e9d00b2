"""The plain reference against the port at test scale (256 px cameras,
280x140 per eye): on the CPU the port's kernels run as plain gathers, so
the two agree bit for bit; the ISP too."""

import pytest
import torch

from s360bench.feed import Feed, quantize8
from s360bench.program import Program
from s360bench.reference.system import Reference
from s360bench.run import Stream
from s360bench.tests.tiny import tiny_cell


@pytest.mark.parametrize("name", ["video_6k", "raw_6k"])
def test_two_chained_frames_agree(name):
    cell = tiny_cell(name)
    prog, ref = Program(cell.config, "cpu"), Reference(cell.config, "cpu")
    feed = Feed(cell.config, cell.traffic, 2**31 + 99, ref.rig, "cpu")
    stream = Stream(prog, feed, ref.rig, "cpu")
    a0, sa = prog.first(*stream.inputs(0))
    b0, sb = ref.first(*stream.inputs(0, system=ref))
    a1, sa1 = prog.next(*stream.inputs(1), sa)
    b1, sb1 = ref.next(*stream.inputs(1, system=ref), sb)
    for a, b in ((a0, b0), (a1, b1)):
        assert torch.equal(quantize8(a["equirect"]), quantize8(b["equirect"]))
    assert set(sa1) == set(sb1)
    for k in sa1:
        assert torch.equal(sa1[k], sb1[k]), k


def test_isp_agrees():
    cell = tiny_cell("raw_6k")
    prog, ref = Program(cell.config, "cpu"), Reference(cell.config, "cpu")
    feed = Feed(cell.config, cell.traffic, 5, ref.rig, "cpu")
    raw = feed.pool[1].float() / 65535.0
    for c in (0, 5, 16):
        assert torch.equal(prog.isp(raw[c], feed.isp[c]), ref.isp(raw[c], feed.isp[c]))


def test_isp_takes_each_seeds_settings():
    """A system kept across seeds (as ``readings.py`` keeps it) puts each
    seed's footage through that seed's ISP settings, as a fresh one does."""
    cell = tiny_cell("raw_6k")
    for make in (Program, Reference):
        kept = make(cell.config, "cpu")
        for seed in (5, 6):
            feed = Feed(cell.config, cell.traffic, seed, kept.rig, "cpu")
            raw = feed.pool[0][:1].float() / 65535.0
            got = kept.isp(raw[0], feed.isp[0])
        assert torch.equal(got, make(cell.config, "cpu").isp(raw[0], feed.isp[0]))
