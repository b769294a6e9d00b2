"""``pixflow_search_20``, upstream's PixFlow with the 20% coarse search,
against the benchmark's plain reference (``s360bench/reference/pixflow.py``)
on the CPU: the port's ``compute_flow`` and the reference's give the same
flows bit for bit, for every hint, for mixed hints, without a prior and
over a temporal chain; and the search uploads nothing after its first
call. No JAX here."""

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

from s360bench.reference import pixflow as RPF
from surround360_tpu_torch.flow import HINT_DOWN, HINT_LEFT, HINT_RIGHT, HINT_UP
from surround360_tpu_torch.flow import pixflow as TPF
from surround360_tpu_torch.ops import resize as R

PRESET = "pixflow_search_20"
HINTS = {
    "left": [HINT_LEFT] * 3,
    "right": [HINT_RIGHT] * 3,
    "down": [HINT_DOWN] * 3,
    "mixed": [HINT_LEFT, HINT_DOWN, HINT_RIGHT],
}


def _frames(seed, n, B, H, W, shift=(3, 2)):
    """n frames of a pair (B, 4, H, W): a smooth random texture and its
    copy shifted by (dx, dy) pixels plus the frame's index, so the search
    has a displacement to find."""
    g = torch.Generator().manual_seed(seed)
    pad = 16
    rgb = R.gaussian_blur(torch.rand((B, 3, H + 2 * pad, W + 2 * pad), generator=g), 1.5)
    rgb = (rgb - rgb.amin()) / (rgb.amax() - rgb.amin())
    alpha = torch.ones((B, 1, H + 2 * pad, W + 2 * pad))
    alpha[..., :, :3] = 0.0  # a band the flows' alpha gates see
    base = torch.cat([rgb, alpha], dim=1)
    dx, dy = shift
    return [(base[..., pad:pad + H, pad:pad + W],
             base[..., pad - dy:pad - dy + H, pad - dx - k:pad - dx - k + W])
            for k in range(n)]


def _chain(compute_flow, params, frames, hints):
    outs, prev = [], None
    h = torch.tensor(hints, dtype=torch.int32)
    for k, (a, b) in enumerate(frames):
        kw = {}
        if k:
            kw = dict(prev_flow=prev, prev_img0=frames[k - 1][0], prev_img1=frames[k - 1][1],
                      use_temporal=True)
        prev = compute_flow(a, b, params, hint=h, site="search_test", **kw)
        outs.append(prev)
    return outs


@pytest.mark.parametrize("hints", list(HINTS), ids=list(HINTS))
@pytest.mark.parametrize("frames", [1, 3], ids=["no_prior", "chain3"])
def test_search_flow_equals_reference(hints, frames):
    pair = _frames(11, frames, 3, 56, 88)
    got = _chain(TPF.compute_flow, TPF.make_flow_params(PRESET), pair, HINTS[hints])
    want = _chain(RPF.compute_flow, RPF.make_flow_params(PRESET), pair, HINTS[hints])
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        assert torch.equal(g, w), float((g - w).abs().max())
    assert float(got[0][:, 0].abs().mean()) > 0.5  # the flows found the shift


def test_search_picks_each_hints_box():
    """The search's own answer, per batch element: every offset it picks
    lies in that element's hint box, and the reference's search picks the
    same ones."""
    params = TPF.make_flow_params(PRESET)
    a, b = _frames(12, 1, 4, 30, 44, shift=(2, 1))[0]
    grey = [TPF._to_grey_alpha(x) for x in (a, b)]
    hint = torch.tensor([HINT_LEFT, HINT_RIGHT, HINT_DOWN, HINT_UP], dtype=torch.int32)
    zero = torch.zeros((4, 2, 30, 44))
    args = (grey[0][0], grey[1][0], grey[0][1], grey[1][1], zero, hint)
    got = TPF._adjust_initial_flow(*args, params)
    want = RPF._adjust_initial_flow(*args, RPF.make_flow_params(PRESET))
    assert torch.equal(got, want)
    boxes = {(dy, dx): h for dy, dx, h in TPF._search_offsets(params)}
    for i, h in enumerate(hint.tolist()):
        picked = {(int(dy), int(dx)) for dx, dy in got[i].reshape(2, -1).T.tolist()}
        assert picked - {(0, 0)}, "the search moved no pixel"
        assert all(h in boxes[o] for o in picked - {(0, 0)})


class _Uploads(TorchFunctionMode):
    """Records every call that makes a tensor from host data or moves one
    to a device: ``torch.tensor`` / ``as_tensor`` / ``asarray``, and
    ``Tensor.to`` / ``copy_`` / ``cuda`` given a device or another
    device's tensor."""

    FACTORIES = {torch.tensor, torch.as_tensor, torch.asarray}

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if func in self.FACTORIES or name == "cuda":
            self.calls.append(name)
        elif name in ("to", "copy_"):
            rest = list(args[1:]) + list(kwargs.values())
            if any(isinstance(x, (str, torch.device)) or
                   (isinstance(x, torch.Tensor) and x.device != args[0].device)
                   for x in rest):
                self.calls.append(name)
        return func(*args, **kwargs)


def test_search_uploads_nothing_after_its_first_call():
    """The hint boxes are a device constant, tested against the hints on
    the device: the first search uploads its constants (the boxes, the
    resize matrices), a second builds no tensor from host data and moves
    none to a device."""
    params = TPF.make_flow_params(PRESET)
    a, b = _frames(13, 1, 3, 40, 64)[0]
    (I0, a0), (I1, a1) = TPF._to_grey_alpha(a), TPF._to_grey_alpha(b)
    src = (I0, I1, a0, a1)
    hint = torch.tensor(HINTS["mixed"], dtype=torch.int32)
    sizes = TPF._pyramid_sizes(40, 64, params)
    R._cached_on_device.cache_clear()
    runs = []
    for _ in range(2):
        with _Uploads() as mode:
            out = TPF._search_step(src, None, len(sizes) - 1, sizes, params, hint)
        runs.append((mode.calls, out))
    (first_calls, first), (calls, second) = runs
    assert "to" in first_calls
    assert calls == []
    assert torch.equal(first, second)
