"""The session's plain reference (``sdbench/reference/session.py``) on
its own: it imports nothing of either package; its exit carries, fed
back as the next block's entry, reproduce the program's two consecutive
blocks run straight through (on the digital lanes the first block holds
whole); its PSD is the FFT; its TF32 rounds to nearest even."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
from session_small import small_session

from sdbench.manifest import HERE, Bench
from sdbench.traffic import make_ring

FORBIDDEN = {"jax", "jaxlib", "flax", "sigdigger_tpu", "sigdigger_tpu_torch"}


def imported_tops(path: str) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("name", ["reference/session.py", "session_mix.py"])
def test_reference_imports_neither_package(name):
    tops = imported_tops(os.path.join(HERE, name))
    assert not tops & FORBIDDEN and tops <= {"__future__", "numpy",
                                             "sdbench"}


def test_exit_carries_reproduce_two_blocks_run_straight_through():
    bench = Bench()
    cell = small_session(bench)
    cfg, wl = cell.config, cell.traffic
    ring = make_ring(cfg, wl, 21, "cpu")
    prog = bench.module("drivers", "session").Program(cfg, wl, "cpu")
    try:
        outs = [prog.drain(h) for h in [prog.feed(ring[n % 4])
                                        for n in range(5)]]
    finally:
        prog.close()
    ref_mod = bench.module("reference", "session")
    ref = ref_mod.Reference(cfg, wl, ring, "cpu")
    first = ref.block(3, ref_mod.narrow(ref, outs[3]["entry"]),
                      outs[3]["demap"][0], hold=True)
    entry, host = ref.chain(first["exit"])
    chained = ref.block(4, entry, host, hold=True)
    # a digital lane's loops carry on from block 3 only where block 3
    # held it whole
    rows = len(chained["view"]["dig_sym"])
    chained["held"] = np.where(first["held"] >= rows, chained["held"], 0)
    nums = ref_mod._compare(ref, ref_mod.program_view(ref, outs[4]),
                            chained["view"], ref_mod._exit_of(ref, outs[4]),
                            chained)
    limits = wl["limits"]
    assert all(v <= limits[k] for k, v in nums.items()), nums
    # and the chain is the program's own: block 4 from the program's
    # entry carries reads the same
    own = ref.block(4, ref_mod.narrow(ref, outs[4]["entry"]),
                    outs[4]["demap"][0])
    np.testing.assert_allclose(own["view"]["audio"],
                               chained["view"]["audio"], atol=1e-5)
    np.testing.assert_allclose(own["view"]["power"],
                               chained["view"]["power"], rtol=1e-6)


def test_reference_psd_is_the_fft():
    bench = Bench()
    cell = small_session(bench)
    ring = (np.random.default_rng(1).standard_normal((2, 65536, 2))
            .view(np.complex128)[..., 0] * 0.3).astype(np.complex64)
    mod = bench.module("reference", "session")
    ref = mod.Reference(cell.config, cell.traffic, ring, "cpu")
    xr, xi = ref._ext(1)
    x = (xr + 1j * xi)[:65536].reshape(16, 4096)
    w = mod.blackman_harris(4096)
    p = (np.abs(np.fft.fft(x * w, axis=1)) ** 2).sum(0) * ref.psd_scale
    got = ref.psd(xr[:1024 * 64].reshape(1024, 64),
                  xi[:1024 * 64].reshape(1024, 64))
    # the (k1, k2) layout: bin k1 + A·k2
    assert np.max(np.abs(got.T.reshape(-1) - p)) <= 1e-9 * np.max(p)


def test_tf32_rounding():
    mod = Bench().module("reference", "session")
    x = np.array([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12,
                  -3.0 - 2 ** -10, -3.0 - 3 * 2 ** -10], np.float32)
    assert mod.tf32(x).tolist() == [1.0, 1.0 + 4 * 2 ** -11, 1.0, -3.0,
                                    -3.0 - 4 * 2 ** -10]
