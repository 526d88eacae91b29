"""Load rates of the smoother's stream shapes on the card (K11).  Port of
``scripts/micro_dma_probe.py``: is the overlapping-window load pattern of
the fused sweeps itself slower than aligned blocks, or than a window laid
out j-lead so that each row window is one contiguous span?

Both of the JAX script's probe sets run, by name, at its shapes (nz 64,
H 512, tj 16, ws 24): ``main``'s cases A-C and ``main2``'s rows.

  element_windows_132      24 overlapping windows, 132 wide (case A)
  aligned_blocks_128       the same bytes as aligned blocks, 37 streams (B)
  element_windows_516      6 windows, 516 wide (C)
  jlead_windows_132x24     24 j-lead windows, 132 wide
  jlead_windows_132x6      6 j-lead windows
  aligned_blocks_128x12    12 aligned blocks
  one_wide_zmajor_stream   one (nz, H, 24 x 128) stream, its 24 lane groups
                           summed

Each row: ``ms`` (CUDA events, median), ``GB`` the JAX script's count
(every window at every step) with the output, ``GBps`` from it,
``unique_GB`` / ``unique_GBps`` each input byte once, and ``library_ms``:
one PyTorch call computing the same sum (ops/kernels/dma_probe.py).
Window rows that the next step loads again may be served by the 50 MB L2
cache, which is part of what is measured.

    python -m mgroms_tpu_torch.scripts.micro_dma_probe

:func:`check` runs on any device; :func:`timed` needs a card.
"""

from __future__ import annotations

import json

import torch

from ..ops.kernels import dma_probe as dp
from ._timing import card, card_line, emit, median_ms

NZ, H, TJ, WS = 64, 512, 16, 24    # micro_dma_probe.py:91-94, :199
WIDE_GROUPS = 24                   # :239


def cases(nz=NZ, H=H, tj=TJ, ws=WS):
    """(label, probe, stacked input shape, bytes) of both JAX probe sets
    at (nz, H, tj, ws).  Case B's stream count gives case A's bytes as
    aligned blocks (micro_dma_probe.py:124)."""
    hs = H - tj + ws
    a = dp.windows_bytes(24, nz, H, tj, ws, 132)
    nb = max(1, round((a["jax"] - 4 * nz * H * dp.LANES)
                      / (4 * nz * H * dp.LANES)))
    out = [("element_windows_132", "windows", (24, nz, hs, 132), a),
           ("aligned_blocks_128", "blocks", (nb, nz, H, 128),
            dp.blocks_bytes(nb, nz, H, 128)),
           ("element_windows_516", "windows", (6, nz, hs, 516),
            dp.windows_bytes(6, nz, H, tj, ws, 516))]
    for n in (24, 6):
        out.append((f"jlead_windows_132x{n}", "jlead", (n, hs, nz, 132),
                    dp.windows_bytes(n, nz, H, tj, ws, 132)))
    out.append(("aligned_blocks_128x12", "blocks", (12, nz, H, 128),
                dp.blocks_bytes(12, nz, H, 128)))
    out.append(("one_wide_zmajor_stream", "wide",
                (1, nz, H, WIDE_GROUPS * dp.LANES),
                dp.wide_stream_bytes(nz, H, WIDE_GROUPS)))
    return out


def calls(probe, X, tj, ws, H):
    """(kernel, plain, library) of ``probe`` on the streams X[s]."""
    xs = list(X.unbind(0))
    if probe == "windows":
        return (lambda: dp.probe_windows(xs, tj, ws, H),
                lambda: dp.probe_windows_plain(xs, tj, ws, H),
                lambda: dp.probe_windows_library(X, tj, ws, H))
    if probe == "jlead":
        return (lambda: dp.probe_windows_jlead(xs, tj, ws, H),
                lambda: dp.probe_windows_jlead_plain(xs, tj, ws, H),
                lambda: dp.probe_windows_jlead_library(X, tj, ws, H))
    if probe == "blocks":
        return (lambda: dp.probe_blocks(xs, tj),
                lambda: dp.probe_blocks_plain(xs, tj),
                lambda: dp.probe_blocks_library(X, tj))
    return (lambda: dp.probe_wide_stream(X[0], tj),
            lambda: dp.probe_wide_stream_plain(X[0], tj),
            lambda: dp.probe_wide_stream_library(X[0], tj))


def inputs(shape, dev, seed):
    """A stacked float32 input, uniform [0, 1), from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev)


def check(dev, nz=2, H=16, tj=8, ws=12) -> dict:
    """Every probe against its plain version (max |difference|, exact on
    the card) and its library call (max relative difference, another
    summation order), at a small shape."""
    dev = torch.device(dev)
    rows = {}
    for k, (label, probe, shape, _) in enumerate(cases(nz, H, tj, ws)):
        X = inputs(shape, dev, k)
        kern, plain, lib = calls(probe, X, tj, ws, H)
        want = plain()
        rows[label] = float((kern() - want).abs().max())
        rows[f"{label}_library"] = float((lib() - want).abs().max()
                                         / want.abs().max())
    return rows


def timed(dev=None, reps=20) -> dict:
    """The rows of the module docstring at the JAX script's shapes."""
    dev = card(dev)
    print(card_line(), flush=True)
    rows = {}
    for k, (label, probe, shape, nb) in enumerate(cases()):
        X = inputs(shape, dev, k)
        kern, _, lib = calls(probe, X, TJ, WS, H)
        ms = median_ms(kern, reps=reps)
        row = {"ms": ms, "GB": nb["jax"] / 1e9,
               "GBps": nb["jax"] / 1e6 / ms,
               "unique_GB": nb["unique"] / 1e9,
               "unique_GBps": nb["unique"] / 1e6 / ms,
               "library_ms": median_ms(lib, reps=reps)}
        emit(rows, label, row)
        del X, kern, lib
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    print(json.dumps(timed()))


if __name__ == "__main__":
    main()
