"""What the micro-benchmarks (and chip_smoke.py) share: the CUDA-event
timer, the card check and the card's name and power limit."""

from __future__ import annotations

import json
import statistics
import subprocess

import torch


def median_ms(fn, reps=20, warm=3):
    """Median time of ``fn`` on the current stream over ``reps`` calls
    after ``warm`` warm-up calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def card(dev=None) -> torch.device:
    """The CUDA device to time on; raises without one (no CPU timing)."""
    if not torch.cuda.is_available():
        raise RuntimeError("this timing needs a CUDA device "
                           "(torch.cuda.is_available() is False)")
    dev = torch.device(dev or "cuda")
    if dev.type != "cuda":
        raise RuntimeError(f"timing runs on a CUDA device, not {dev}")
    return dev


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of this machine."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def emit(rows: dict, name: str, val) -> None:
    """Keep one row and print it as a one-key JSON line."""
    rows[name] = val
    print(json.dumps({name: val}), flush=True)
