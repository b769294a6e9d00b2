"""The port's compile check and multi-device dry run
(``surround360_tpu_torch/graft_entry.py``) against the reference's root
entry (``__graft_entry__.py``): the same inputs and config, the step equal
to ``render_frame``, the dry run's line with both meshes within 1e-4 of
the sequential chain, and CUDA as the default device."""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

import __graft_entry__ as JG
from surround360_tpu_torch import graft_entry as TG
from surround360_tpu_torch.render.panorama import render_frame

CPU = torch.device("cpu")


def test_entry_inputs_and_config_match_jax():
    jctx, *jargs = JG._make_inputs(0.0625, 280, 140)
    tctx, *targs = TG._make_inputs(0.0625, 280, 140, CPU)
    assert dataclasses.asdict(tctx.config) == dataclasses.asdict(jctx.config)
    _, example = TG.entry(device="cpu")
    for j, t, e in zip(jargs, targs, example):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert torch.equal(t, e) and e.device == CPU


def test_entry_step_is_render_frame():
    fn, args = TG.entry(device="cpu")
    out = fn(*args)
    ctx = TG._make_inputs(0.0625, 280, 140, CPU)[0]
    want = render_frame(ctx, *args)[0]["equirect"]
    assert out.shape == (3, 280, 280) and out.device == CPU
    assert float((out - want).abs().max()) == 0.0


def test_dryrun_multichip_on_cpu(capsys):
    err, err14 = TG.dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: 8 devices, mesh {'data': 4, 'ring': 2}")
    assert "camera-width ring mesh {'data': 1, 'ring': 14}" in line
    assert err < TG.DRYRUN_TOL and err14 < TG.DRYRUN_TOL


def test_entries_default_to_cuda():
    import inspect

    for fn in (TG.entry, TG.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TG.entry()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TG.dryrun_multichip(8)
