"""K11, the load-rate probes (mgroms_tpu_torch/ops/kernels/dma_probe.py),
on the CPU: the plain versions of probe_windows, probe_blocks and
probe_windows_jlead against the JAX script's Pallas probes
(scripts/micro_dma_probe.py, interpret mode) bit for bit, main2's
one-wide-stream sum against a numpy transcription of its kernel
(micro_dma_probe.py:242-247), the byte counts against the JAX script's
own, and the entry point's check on the CPU.  The CUDA kernels are held to
these plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgroms_tpu_torch.ops.kernels import dma_probe as dp
from mgroms_tpu_torch.scripts import micro_dma_probe as mdp

torch.set_num_threads(1)

NZ, H, TJ, WS, WIDE, N = 2, 16, 8, 12, 132, 3
HS = H - TJ + WS


@pytest.fixture(scope="module")
def jprobe():
    """The JAX script as a module (its probes build Pallas calls)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "micro_dma_probe.py")
    spec = importlib.util.spec_from_file_location("jax_micro_dma_probe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _streams(shape, seed):
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return x, [torch.from_numpy(np.ascontiguousarray(s)) for s in x]


def test_windows_plain_equals_jax(jprobe):
    x, xs = _streams((N, NZ, HS, WIDE), 0)
    f = jprobe.probe_windows(N, NZ, HS, WIDE, TJ, WS, H, interpret=True)
    want = np.asarray(f(*[jnp.asarray(s) for s in x]))
    got = dp.probe_windows(xs, TJ, WS, H)
    assert got.shape == (NZ, H, dp.LANES)
    np.testing.assert_array_equal(got.numpy(), want)


def test_blocks_plain_equals_jax(jprobe):
    x, xs = _streams((N, NZ, H, 128), 1)
    f = jprobe.probe_blocks(N, NZ, H, 128, TJ, interpret=True)
    want = np.asarray(f(*[jnp.asarray(s) for s in x]))
    got = dp.probe_blocks(xs, TJ)
    np.testing.assert_array_equal(got.numpy(), want)
    # one stream: the sum is a copy, never the input itself
    one = dp.probe_blocks(xs[:1], TJ)
    assert torch.equal(one, xs[0]) and one.data_ptr() != xs[0].data_ptr()


def test_jlead_plain_equals_jax(jprobe):
    x, xs = _streams((N, HS, NZ, WIDE), 2)
    f = jprobe.probe_windows_jlead(N, NZ, HS, WIDE, TJ, WS, H,
                                   interpret=True)
    want = np.asarray(f(*[jnp.asarray(s) for s in x]))
    got = dp.probe_windows_jlead(xs, TJ, WS, H)
    assert got.shape == (H, NZ, dp.LANES)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wide_stream_plain_equals_numpy():
    """micro_dma_probe.py:242-247: acc = r[:, :, 0:128], then acc + each
    next 128-lane group, in float32."""
    x = np.random.default_rng(3).random((NZ, H, 24 * 128), dtype=np.float32)
    acc = None
    for m in range(24):
        s = x[:, :, m * 128:(m + 1) * 128]
        acc = s if acc is None else acc + s
    got = dp.probe_wide_stream(torch.from_numpy(x), TJ)
    np.testing.assert_array_equal(got.numpy(), acc)


def test_byte_counts_match_the_jax_script():
    """The ``jax`` count less the output is the JAX script's ``gb``
    (micro_dma_probe.py:116, :136, :157, :215, :234, :269) at its shapes;
    ``unique`` reads each input byte once, ``slice`` each byte the sum
    reads."""
    nz, Hj, tj, ws = mdp.NZ, mdp.H, mdp.TJ, mdp.WS
    hs = Hj - tj + ws
    out = 4 * nz * Hj * 128
    gb = {label: (b["jax"] - out) / 1e9 for label, _, _, b in mdp.cases()}
    want = {"element_windows_132": 24 * 32 * 64 * 24 * 132 * 4,
            "aligned_blocks_128": 37 * 512 * 64 * 128 * 4,
            "element_windows_516": 6 * 32 * 64 * 24 * 516 * 4,
            "jlead_windows_132x24": 24 * 32 * 64 * 24 * 132 * 4,
            "jlead_windows_132x6": 6 * 32 * 64 * 24 * 132 * 4,
            "aligned_blocks_128x12": 12 * 512 * 64 * 128 * 4,
            "one_wide_zmajor_stream": 64 * 512 * 3072 * 4}
    assert gb == {k: v / 1e9 for k, v in want.items()}
    labels = [c[0] for c in mdp.cases()]
    assert labels == list(want)
    a = dp.windows_bytes(24, nz, Hj, tj, ws, 132)
    assert a["unique"] == 24 * nz * hs * 132 * 4 + out
    assert round(a["jax"] / 1e9, 3) == 0.640       # 0.623 GB + the output
    assert round((a["unique"] - out) / 1e9, 3) == 0.422
    assert a["slice"] == 24 * nz * Hj * 128 * 4 + out
    b = dp.blocks_bytes(37, nz, Hj, 128)
    assert b["jax"] == b["unique"] == b["slice"]
    w = dp.wide_stream_bytes(nz, Hj, mdp.WIDE_GROUPS)
    assert w["jax"] == w["unique"] == w["slice"]


def test_check_on_cpu_and_block_plans():
    rows = mdp.check("cpu")
    for label, probe, _, _ in mdp.cases():
        assert rows[label] == 0.0
        assert rows[f"{label}_library"] <= 1e-6
    assert [dp.jlead_planes(nz) for nz in (64, 2, 3)] == [4, 2, 1]
    assert dp.wide_rows(16, 3072) == 4
    assert all(v == 0 for v in dp.LAUNCHES.values())
