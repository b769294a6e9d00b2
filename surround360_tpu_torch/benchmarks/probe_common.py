"""What the two kernel probes (``kernel_step_cost``, ``kernel_body_cost``)
share: the bicubic tent, TF32 rounding (the K4 kernel's operand split), the
device check and the grid-contrast timers. Their kernels load, launch and
count through ``cuda_build``, the site of a launch being its variant."""

from __future__ import annotations

import time

import torch

__all__ = [
    "tent",
    "tf32_round",
    "probe_device",
    "device_ms",
    "host_ms",
    "per_step_us",
]

SLEEP_CYCLES = 20_000_000  # ~10 ms queued ahead of the timed launches


def tent(d: torch.Tensor) -> torch.Tensor:
    """The bicubic (Keys, a = -0.75) distance kernel of ``d``, 0 beyond 2."""
    a = -0.75
    s = d.abs()
    k01 = ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0
    k12 = ((a * s - 5.0 * a) * s + 8.0 * a) * s - 4.0 * a
    return torch.where(s < 1.0, k01, torch.where(s < 2.0, k12, 0.0))


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32 (10 mantissa bits) as the card's
    ``cvt.rna.tf32.f32`` rounds: to nearest, ties away from zero. Bit
    arithmetic on the int32 view: half of the 13 dropped bits is added to
    the magnitude (a carry runs into the exponent), then they are cut."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    sign = bits & -(2**31)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def probe_device(*tensors: torch.Tensor) -> str:
    """"cpu" or "cuda", the one device of ``tensors``; raises on others."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    kind = next(iter(devs)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {next(iter(devs))}")
    return kind


def device_ms(call, reps: int) -> float:
    """Device ms per call of ``call``: one warm call, then ``reps`` calls
    between two CUDA events, queued behind a ~10 ms sleep kernel so that
    the host's launch cost stays out of the time."""
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(call, reps: int) -> float:
    """Host-clock ms per call of ``call`` (CPU tensors): one warm call,
    then ``reps`` calls."""
    call()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    return (time.perf_counter() - t0) / reps * 1e3


def per_step_us(make_call, n1: int, n2: int, reps: int, device="cuda"):
    """The reference probes' grid contrast: ``make_call(n)`` returns a call
    that runs an n-step grid; per-step us = (t(n2) - t(n1)) / (n2 - n1), so
    launch and fixed costs cancel. t is :func:`device_ms` on a CUDA device,
    :func:`host_ms` on the CPU. Returns (us per step, t(n1) ms, t(n2) ms)."""
    timer = device_ms if torch.device(device).type == "cuda" else host_ms
    t1 = timer(make_call(n1), reps)
    t2 = timer(make_call(n2), reps)
    return (t2 - t1) / (n2 - n1) * 1e3, t1, t2
