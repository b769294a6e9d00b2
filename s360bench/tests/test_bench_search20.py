"""``video_6k_search20`` at test scale (256 px cameras, 280x140 per eye):
the port with upstream's ``pixflow_search_20`` on ring and poles against
the plain reference, two chained frames, equal bit for bit on the CPU."""

import torch

from s360bench.feed import Feed, quantize8
from s360bench.program import Program
from s360bench.reference.system import Reference
from s360bench.run import Stream
from s360bench.tests.tiny import tiny_cell


def test_two_chained_search20_frames_agree():
    cell = tiny_cell("video_6k_search20")
    render = cell.config["render"]
    assert render["side_flow_alg"] == render["polar_flow_alg"] == "pixflow_search_20"
    prog, ref = Program(cell.config, "cpu"), Reference(cell.config, "cpu")
    feed = Feed(cell.config, cell.traffic, 2**31 + 299, ref.rig, "cpu")
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
    # the ring's flows move (the poles' stay 0 at this size: no alpha
    # passes the flow's gate there)
    assert all(sa1[k].abs().max() > 0 for k in ("pair_flow_ltr", "pair_flow_rtl"))
