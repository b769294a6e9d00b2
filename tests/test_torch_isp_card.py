"""The ISP on the card (imports no JAX): with its tables kept on the
device, a repeated ``isp_process`` call on a 2048x2048 mosaic with the
benchmark's ``raw_6k`` camera configuration neither synchronises the
stream nor copies to the device, and gives the first call's output."""

import json
from pathlib import Path

import pytest
import torch

from surround360_tpu_torch.isp import pipeline as TP

CONFIG = Path(__file__).resolve().parents[1] / "s360bench" / "configs" / "s360_6k.json"


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


@pytest.fixture
def raw_6k():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = json.loads(CONFIG.read_text())["isp"]
    cfg = TP.IspConfig(**{k: _tuples(v) for k, v in kw.items()})
    g = torch.Generator(device="cuda").manual_seed(0)
    raw = torch.rand((2048, 2048), generator=g, device="cuda")
    TP._TABLES.clear()
    TP._device_masks.cache_clear()
    yield cfg, raw
    torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_card_warm_isp_copies_and_synchronises_nothing(raw_6k):
    cfg, raw = raw_6k
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    with pytest.raises(RuntimeError):  # a cold call uploads its tables
        TP.isp_process(raw, cfg)
    torch.cuda.set_sync_debug_mode(0)
    cold = TP.isp_process(raw, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    warm = TP.isp_process(raw, cfg)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(warm, cold)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            TP.isp_process(raw, cfg)
        torch.cuda.synchronize()
    # the host's side: the spans and the runtime calls
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    calls = [e.time_range for e in events if e.name == "isp"]
    assert len(calls) == 2

    def inside(e):
        return any(r.start <= e.time_range.start and e.time_range.end <= r.end
                   for r in calls)

    names = [e.name for e in events if inside(e)]
    assert any("aunch" in n for n in names), names
    bad = [n for n in names if "ynchronize" in n or "emcpy" in n]
    assert bad == []
