"""The kernel probes of the port (K4 ``kernel_step_cost``, K5
``kernel_body_cost``) against the reference's own Pallas bodies.

The reference scripts (``benchmarks/kernel_step_cost.py::main``,
``benchmarks/kernel_body_cost.py::main``) run unchanged on the CPU with
``jax.experimental.pallas.pallas_call`` wrapped: for K4 the wrapper adds
``interpret=True`` and shrinks each grid (and its ``out_shape``) to 2 steps;
K5 already interprets off the TPU, and its grid pair is patched to (2, 4).
The wrapper records each distinct call's inputs and output (a repeat of
the same call returns the recorded output). Each variant's twin is then
held to the recorded outputs:

- K4 (``Precision.HIGHEST`` float32 in interpret mode): max-abs within
  1e-5 of the output's max |value| (measured: <= 8e-7 relative; the dots
  body reaches ~7e4). A plain emulation of the kernel's 3xTF32 products
  (``probe_common.tf32_round``) is held to the same records and bound.
- K5 (the reference's ``dot3`` is a 3-pass bf16 product even in interpret
  mode, and so is the twin's): max-abs within 2e-5 of max(1, the output's
  max |value|) (no_dot, which has no product, measured 1.8e-7).
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from surround360_tpu_torch.benchmarks import kernel_body_cost as KB  # noqa: E402
from surround360_tpu_torch.benchmarks import kernel_step_cost as KS  # noqa: E402
from surround360_tpu_torch.benchmarks import probe_common as pc  # noqa: E402

K4_REL = 1e-5
K5_REL = 2e-5


def _run_reference(module_name, shrink, patch):
    """Run the reference script ``module_name``'s main() with pallas_call
    wrapped; returns the recorded (inputs, output) of each distinct call,
    in call order."""
    import importlib

    real = pl.pallas_call
    real_update = jax.config.update
    records, seen = [], {}

    def wrapped(kernel, **kw):
        if shrink:
            shape = kw["out_shape"]
            kw = dict(kw, grid=(2,), interpret=True, out_shape=jax.ShapeDtypeStruct(
                (2,) + tuple(shape.shape[1:]), shape.dtype))
        fn = real(kernel, **kw)

        def call(*args):
            key = (id(fn) if shrink else None,) + tuple(id(a) for a in args)
            if key not in seen:
                out = fn(*args)
                seen[key] = (args, out)  # keeps the inputs alive: ids stay unique
                records.append(([np.array(a) for a in args], np.array(out)))
            return seen[key][1]

        return call

    def update(name, value):  # the reference points the compile cache at its TPU cache
        if not name.startswith(("jax_compilation_cache", "jax_persistent_cache")):
            real_update(name, value)

    module = importlib.import_module(module_name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S360_STEP_REPS", "1")
        mp.setattr(pl, "pallas_call", wrapped)
        mp.setattr(jax.config, "update", update)
        for name, value in patch.items():
            mp.setattr(module, name, value)
        with jax.disable_jit():
            module.main()
    return records


@pytest.fixture(scope="module")
def k4_records():
    """Two calls a variant (the grid pair of each, both cut to 2 steps),
    in the reference's order: the six K4 variants."""
    recs = _run_reference("benchmarks.kernel_step_cost", True, {})
    assert len(recs) == 2 * len(KS.VARIANTS)
    return {name: recs[2 * i:2 * i + 2] for i, name in enumerate(KS.VARIANTS)}


@pytest.fixture(scope="module")
def k5_records():
    """Two calls a variant (grids of 2 and 4 steps): the seven K5 variants."""
    recs = _run_reference("benchmarks.kernel_body_cost", False, {"N1": 2, "N2": 4})
    assert len(recs) == 2 * len(KB.VARIANTS)
    return {name: recs[2 * i:2 * i + 2] for i, name in enumerate(KB.VARIANTS)}


@pytest.mark.parametrize("variant", list(KS.VARIANTS))
def test_k4_twin_matches_reference_pallas_body(k4_records, variant):
    for args, want in k4_records[variant]:
        x = torch.from_numpy(args[0][:2].copy())  # the 2 steps the grid ran
        src = torch.from_numpy(args[1].copy())
        if KS.VARIANTS[variant][0] == KS.SITE_DMA:
            got = KS.step_cost(variant, x, None, src)
        else:
            got = KS.step_cost(variant, x, src)
        assert got.shape == want.shape == (2, KS.out_rows(variant), KS.PG)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= K4_REL * float(np.abs(want).max()), (variant, err)


def _tf32x3_summed(oh, w):
    """The K4 kernel's arithmetic in plain PyTorch: both operands split
    into TF32 hi + lo (cvt.rna), lo.hi + hi.lo + hi.hi in float32, then the
    64 columns summed."""
    ah = pc.tf32_round(oh)
    al = pc.tf32_round(oh - ah)
    bh = pc.tf32_round(w)
    bl = pc.tf32_round(w - bh)
    f = lambda p, q: torch.matmul(p, q.transpose(-1, -2))
    return (f(al, bh) + f(ah, bl) + f(ah, bh)).sum(-1)


@pytest.mark.parametrize("variant", list(KS.VARIANTS))
def test_k4_tf32x3_matches_reference(k4_records, variant, monkeypatch):
    """3xTF32 holds K4's tolerance against the reference's float32: the
    twin with its products taken as the kernel takes them."""
    monkeypatch.setattr(KS, "_summed", _tf32x3_summed)
    for args, want in k4_records[variant]:
        x = torch.from_numpy(args[0][:2].copy())
        src = torch.from_numpy(args[1].copy())
        dma = KS.VARIANTS[variant][0] == KS.SITE_DMA
        got = KS.step_cost_plain(variant, x, None if dma else src, src if dma else None)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= K4_REL * float(np.abs(want).max()), (variant, err)


def test_tf32_round_hand_picked():
    """cvt.rna.tf32.f32: 10 mantissa bits kept, to nearest, ties away
    from zero."""
    e = 2.0 ** -10  # one TF32 ulp at 1
    v = torch.tensor([1.0, 1 + e / 2, 1 + 3 * e / 2, 1 + e / 2 - 2.0 ** -23, 2 - e / 4,
                      -(1 + e / 2), -(1 + e / 2 - 2.0 ** -23), 0.0, -0.0, 3.0, 1e-40])
    want = [1.0, 1 + e, 1 + 2 * e, 1.0, 2.0, -(1 + e), -1.0, 0.0, -0.0, 3.0]
    got = pc.tf32_round(v)
    assert got[:-1].tolist() == want  # ties away (1 + e/2 -> 1 + e), a carry into 2
    assert torch.signbit(got[8])
    assert float(got[-1]) == pytest.approx(1e-40, rel=2 ** -10)  # subnormal: 10 bits kept
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


def test_k5_dot3_twin_is_the_references_dot3():
    """KB.dot3 takes the reference's ``dot3`` arithmetic: bf16 hi / lo
    splits bit-equal to jnp's astype (round to nearest even), the three
    float32 products summed alike (within 1e-6 of the scale: sums in
    another order)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    a = rng.standard_normal((64, KB.BWB)).astype(np.float32)
    b = rng.random((KB.C * KB.BH, KB.BWB)).astype(np.float32)

    def ref_dot3(ax, bx):  # benchmarks/kernel_body_cost.py::main.dot3
        ah = ax.astype(jnp.bfloat16)
        al = (ax - ah.astype(jnp.float32)).astype(jnp.bfloat16)
        bh_ = bx.astype(jnp.bfloat16)
        bl = (bx - bh_.astype(jnp.float32)).astype(jnp.bfloat16)
        dn = (((1,), (1,)), ((), ()))
        f = lambda p, q: jax.lax.dot_general(p, q, dimension_numbers=dn,
                                             preferred_element_type=jnp.float32)
        return f(ah, bh_) + f(al, bh_) + f(ah, bl), (ah, al)

    want, (ah, al) = ref_dot3(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a)
    th = ta.to(torch.bfloat16)
    assert np.array_equal(th.float().numpy(), np.asarray(ah.astype(jnp.float32)))
    assert np.array_equal((ta - th.float()).to(torch.bfloat16).float().numpy(),
                          np.asarray(al.astype(jnp.float32)))
    got = KB.dot3(ta, torch.from_numpy(b)).numpy()
    want = np.asarray(want)
    assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())
    f32 = a @ b.T  # and it is not the float32 product
    assert float(np.abs(got - f32).max()) > 1e-6 * float(np.abs(f32).max())


@pytest.mark.parametrize("variant", list(KB.VARIANTS))
def test_k5_twin_matches_reference_pallas_body(k5_records, variant):
    for args, want in k5_records[variant]:
        got = KB.body_cost(variant, *[torch.from_numpy(a.copy()) for a in args])
        assert got.shape == want.shape == (args[1].shape[0], KB.C, KB.PG)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= K5_REL * max(1.0, float(np.abs(want).max())), (variant, err)


def test_k4_reference_shapes_match_the_port(k4_records):
    """The port's geometry and input generator are the reference's."""
    args, _ = k4_records["tent_plus_dots_x5"][0]
    assert args[1].shape == (KS.C, KS.BH, KS.BW) and args[0].shape[1:] == (KS.XROWS, KS.PG)
    assert 2.0 <= args[0].min() and args[0].max() < KS.BW - 6
    args, _ = k4_records["tent_dots_dyn_dma_x5"][0]
    assert args[1].shape == (KS.C, KS.BIGH, KS.BW)
    x, win, big = KS.make_inputs(np.random.default_rng(0), "tent_dots_dyn_dma_x5", 3, "cpu")
    assert win is None and tuple(big.shape) == args[1].shape and x.shape[1:] == args[0].shape[1:]


def test_k5_reference_shapes_match_the_port(k5_records):
    for name in ("full", "full_dma"):
        args, _ = k5_records[name][0]
        port = KB.make_inputs(np.random.default_rng(0), name, 2, "cpu")
        assert [a.shape for a in args] == [tuple(p.shape) for p in port], name
        assert [a.dtype for a in args] == [p.numpy().dtype for p in port], name


def test_k4_roll_is_jnp_roll():
    """The roll body's product o reads the window shifted by o lanes the
    way jnp.roll shifts (the recorded outputs fix the direction; this pins
    it on an impulse)."""
    x = torch.full((1, KS.XROWS, KS.PG), 10.5)
    win = torch.zeros((KS.C, KS.BH, KS.BW))
    win[0, 0, 10] = 1.0
    out = KS.step_cost_plain("tent_dots_roll_x5", x, win)
    # the window shifted by o has its 1 at lane 10 + o, where the tent of
    # x = 10.5 weighs tent(0.5 - o) (the other direction: tent(0.5 + o))
    for o in range(KS.N_OX):
        want = float(pc.tent(torch.tensor(0.5 - o)))
        assert float(out[0, o, 0]) == pytest.approx(want, abs=1e-7)


def test_wrappers_take_the_twin_on_cpu_and_count_no_launch():
    rng = np.random.default_rng(1)
    launches = dict(pc.LAUNCHES)
    for name in KS.VARIANTS:
        args = KS.make_inputs(rng, name, 2, "cpu")
        assert torch.equal(KS.step_cost(name, *args), KS.step_cost_plain(name, *args))
    for name in KB.VARIANTS:
        args = KB.make_inputs(rng, name, 3, "cpu")
        assert torch.equal(KB.body_cost(name, *args), KB.body_cost_plain(name, *args))
    assert dict(pc.LAUNCHES) == launches


def test_twins_chunk_long_grids_like_short_ones(monkeypatch):
    """The twins walk long grids in chunks of steps; the chunking changes
    no value (full_dma's rotating row depends on the global step)."""
    rng = np.random.default_rng(2)
    args = KB.make_inputs(rng, "full_dma", 5, "cpu")
    want = KB.body_cost_plain("full_dma", *args)
    monkeypatch.setattr(KB, "_CHUNK", 2)
    assert torch.equal(KB.body_cost_plain("full_dma", *args), want)
    args = KS.make_inputs(rng, "tent_dots_dyn_dma_x5", 5, "cpu")
    want = KS.step_cost_plain("tent_dots_dyn_dma_x5", *args)
    monkeypatch.setattr(KS, "_CHUNK", 2)
    assert torch.equal(KS.step_cost_plain("tent_dots_dyn_dma_x5", *args), want)


def test_inputs_are_validated():
    rng = np.random.default_rng(3)
    x, win, _ = KS.make_inputs(rng, "dots_x5", 2, "cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        KS.step_cost("dots", x, win)
    with pytest.raises(ValueError, match="x must be"):
        KS.step_cost("dots_x5", x[:, :4], win)
    with pytest.raises(ValueError, match="big must be"):
        KS.step_cost("tent_dots_dyn_dma_x5", x, None, win)
    shifts, xs, ys, w = KB.make_inputs(rng, "full", 2, "cpu")
    with pytest.raises(ValueError, match="shifts must be"):
        KB.body_cost("full", shifts.long(), xs, ys, w)
    with pytest.raises(ValueError, match="win must be"):
        KB.body_cost("full_dma", shifts, xs, ys, w)  # 288 rows: full_dma needs 344
    with pytest.raises(ValueError, match="unsupported device"):
        KS.step_cost("dots_x5", x.to("meta"), win.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        KB.body_cost("full", *[a.to("meta") for a in (shifts, xs, ys, w)])


def test_probe_mains_run_on_cpu(capsys, monkeypatch):
    """Both probes' main() on the CPU (the twins, host clock) at tiny grids print
    the reference's lines and JSON; K5's summary is full and what each
    component adds."""
    monkeypatch.setenv("S360_STEP_REPS", "1")
    monkeypatch.setattr(KS, "STEPS", {name: (1, 2) for name in KS.VARIANTS})
    monkeypatch.setattr(KB, "N1", 1)
    monkeypatch.setattr(KB, "N2", 2)
    res = KS.main(["--device", "cpu"])
    assert list(res) == list(KS.VARIANTS) and "us_per_lead" in res["lead8_fori"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("dots_x5") and "us/step" in lines[0]
    assert list(json.loads(lines[-1])) == list(KS.VARIANTS)
    res = KB.main(["--device", "cpu"])
    assert list(res) == list(KB.VARIANTS)
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(summary) == ["full", "ohx", "ohy", "dot", "reduce", "roll", "dma"]


def test_components_are_the_references():
    res = {"full": 10.0, "no_ohx": 7.0, "no_dot": 2.0, "full_dma": 12.5}
    assert KB.components(res) == {"full": 10.0, "ohx": 3.0, "dot": 8.0, "dma": 2.5}
    assert KB.components({"no_roll": 1.0}) == {"no_roll": 1.0}


def test_probe_mains_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (KS.main, KB.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])


@pytest.mark.parametrize("variant", list(KS.VARIANTS) + list(KB.VARIANTS))
def test_smoke_yardstick_computes_the_variants_products(variant, monkeypatch):
    """chip_smoke.probe_library's batched torch.matmul is the variant's own
    product: finished like the body (K4: the 64 columns summed; K5: the
    channel reduction or its stub) it gives the twin's output. The
    yardstick is one float32 product, so K5's twin takes its product in
    float32 here, in place of ``dot3``."""
    import chip_smoke as cs

    monkeypatch.setattr(KB, "dot3", lambda a, b: torch.matmul(a, b.transpose(-1, -2)))

    rng = np.random.default_rng(6)
    if variant in KS.VARIANTS:
        site = KS.VARIANTS[variant][0]
        args = KS.make_inputs(rng, variant, 3, "cpu")
        out = cs.probe_library(site, variant, args)()
        got = out.reshape(3, KS.out_rows(variant), KS.PG, KS.BH).sum(-1)
        want = KS.step_cost_plain(variant, *args)
        assert float((got - want).abs().max()) <= K4_REL * float(want.abs().max())
        return
    args = KB.make_inputs(rng, variant, 3, "cpu")
    call = cs.probe_library(KB.SITE, variant, args)
    t = KB.VARIANTS[variant]
    if not t["dot"]:
        assert call is None
        return
    tmp = call()  # (n, PG, C * BH)
    y = args[2][:, 0, :, None]
    ohy = pc.tent(y - torch.arange(KB.BH, dtype=torch.float32)) if t["ohy"] else y * 1e-3
    if t["reduce"]:
        got = (tmp.reshape(3, KB.PG, KB.C, KB.BH) * ohy[:, :, None, :]).sum(-1)
    else:
        got = tmp[..., ::KB.BH] + ohy[..., :1]
    want = KB.body_cost_plain(variant, *args)
    assert torch.allclose(got.transpose(1, 2), want, atol=1e-6, rtol=0)


def test_smoke_bounds_are_the_hand_counts():
    """chip_smoke.probe_bound's SIMT column: 5 (8) products of 2 * 512 *
    512 * 64 FLOPs a K4 step at 67 TFLOP/s; K5's 2 * 512 * 256 * 288
    product plus its 2 * 512 * 288 reduction; no_dot's bound is its
    reduction's FLOPs, just above its 12 KB of bytes."""
    import chip_smoke as cs

    b = cs.probe_bound(KS.SITE_VARIANT, "tent_plus_dots_x5")
    assert b["flops"] == 5 * 2 * 512 * 512 * 64 and b["bound_by"] == "operations"
    assert b["simt_bound_us"] == pytest.approx(2.504, abs=1e-3)
    assert cs.probe_bound(KS.SITE_DYN, "lead8_fori")["simt_bound_us"] == pytest.approx(
        4.006, abs=1e-3)
    dma = cs.probe_bound(KS.SITE_DMA, "tent_dots_dyn_dma_x5")
    assert dma["bytes"] == 512 * 4 + 5 * 512 * 4 + 64 * 512 * 4
    full = cs.probe_bound(KB.SITE, "full")
    assert full["flops"] == 2 * 512 * 256 * 288 + 2 * 512 * 288
    assert full["simt_bound_us"] == pytest.approx(1.1312, abs=1e-4)
    no_dot = cs.probe_bound(KB.SITE, "no_dot")
    assert no_dot["bytes"] == 2 * 512 * 4 + 4 + 4 * 512 * 4 and no_dot["bound_by"] == "operations"
    assert cs.probe_bound(KB.SITE, "full_dma")["bytes"] == full["bytes"] + 288 * 256 * 4


def test_smoke_tensor_core_bounds_are_the_hand_counts():
    """chip_smoke.probe_bound at the rate of the products' precision: K4's
    products as 3 TF32 passes at 495 TFLOP/s (1.017 us a K4a / K4c step,
    1.627 us for K4b's 8 leads); K5's dot3 as 3 bf16 passes at 989 TFLOP/s
    plus its reduction at 67 TFLOP/s (0.2334 us); no_dot, with no product,
    keeps its SIMT bound."""
    import chip_smoke as cs

    k4 = 2 * 512 * 512 * 64
    for site, name, n in ((KS.SITE_VARIANT, "dots_x5", 5), (KS.SITE_VARIANT, "tent_dots_roll_x5", 5),
                          (KS.SITE_DMA, "tent_dots_dyn_dma_x5", 5), (KS.SITE_DYN, "lead8_unrolled", 8)):
        b = cs.probe_bound(site, name)
        assert b["tc_flops"] == 3 * n * k4 and b["bound_by"] == "operations"
        assert b["bound_us"] == pytest.approx(3 * n * k4 / 495e12 * 1e6, rel=1e-12)
    assert cs.probe_bound(KS.SITE_VARIANT, "tent_plus_dots_x5")["bound_us"] == pytest.approx(
        1.0168, abs=1e-4)
    assert cs.probe_bound(KS.SITE_DYN, "lead8_fori")["bound_us"] == pytest.approx(1.6269, abs=1e-4)
    full = cs.probe_bound(KB.SITE, "full")
    assert full["tc_flops"] == 3 * 2 * 512 * 256 * 288
    assert full["bound_us"] == pytest.approx(0.22901 + 0.00440, abs=1e-5)
    assert cs.probe_bound(KB.SITE, "no_reduce")["bound_us"] == pytest.approx(0.22901, abs=1e-5)
    assert cs.probe_bound(KB.SITE, "full_dma")["bound_by"] == "operations"
    no_dot = cs.probe_bound(KB.SITE, "no_dot")
    assert no_dot["tc_flops"] == 0 and no_dot["bound_us"] == no_dot["simt_bound_us"]
    for name in KB.VARIANTS:  # never above the SIMT bound, never below the bytes
        b = cs.probe_bound(KB.SITE, name)
        assert b["bytes_us"] <= b["bound_us"] <= b["simt_bound_us"]


def test_kernel_resources_read_ptxas(monkeypatch, tmp_path):
    """cuda_build.kernel_resources: registers and spill bytes per kernel
    from ptxas's -v report kept beside a build."""
    from surround360_tpu_torch import cuda_build

    so = tmp_path / "libk.so"
    (tmp_path / "libk.so.ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aPf\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 134656 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers\n")
    monkeypatch.setattr(cuda_build, "_so_path", lambda source: str(so))
    assert cuda_build.kernel_resources("k.cu") == {
        "_Z1aPf": {"registers": 168, "spill_stores": 8, "spill_loads": 12},
        "_Z1bPf": {"registers": 40, "spill_stores": None, "spill_loads": None}}
