"""The port's column compactor (``kernels/compact.py``) against the
reference's ``ColumnCompactor`` in interpret mode: float32, bfloat16 and
scaled int16 outputs, several row tiles, several channel tiles on the
reference's side, a remap without a rebuild.

Tolerance: none.  A gather and the reference's one-hot matmul give the
same value for finite inputs (x·1 plus zeros), bfloat16 rounds to
nearest even on both sides and int16 truncates toward zero on both, so
the outputs are compared for equality.  The one place they differ is
stated in the module and held in ``test_non_finite_unmapped_column``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.kernels.compact import ColumnCompactor as RefCompactor
from sigdigger_tpu.kernels.compact import (
    ColumnCompactorConfig as RefCompactorConfig,
)
from sigdigger_tpu_torch.kernels import compact
from sigdigger_tpu_torch.kernels.compact import (
    ColumnCompactor,
    ColumnCompactorConfig,
)

COLS = [3, 130, 255, 64, 17, 200]
OUTS = {"f32": dict(), "bf16": dict(out_bf16=True),
        "i16": dict(out_i16=True, scales=(1000.5, 8192.0, 3.3))}


def _pair(n_planes=3, **kw):
    geom = dict(n_rows=512, n_channels=256, width=16, n_planes=n_planes,
                m_tile=128, **kw)
    # channel_tile is the reference's TPU tile; the port has none
    return (RefCompactor(RefCompactorConfig(**geom, channel_tile=128),
                         interpret=True),
            ColumnCompactor(ColumnCompactorConfig(**geom), device="cpu"))


def _planes(n: int, seed: int):
    rng = np.random.default_rng(seed)
    # fractional values of every size, some past the int16 range once
    # scaled
    return [(rng.standard_normal((512, 256)) * 3.7).astype(np.float32)
            for _ in range(n)]


def _as_f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("out", list(OUTS))
def test_matches_reference(out):
    ref, ours = _pair(**OUTS[out])
    ref.set_mapping(COLS)
    ours.set_mapping(COLS)
    planes = _planes(3, seed=len(out))
    got = ours.dispatch(*planes)
    want = ref.dispatch(*planes)
    assert got.dtype == ours.cfg.dtype and tuple(got.shape) == (3 * 512, 16)
    np.testing.assert_array_equal(got.float().numpy(), _as_f32(want))
    for g, w in zip(ours.fetch(got), ref.fetch(want)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    # the gathered columns, then zeros
    (o0, *_) = ours.fetch(got)
    if out == "f32":
        np.testing.assert_array_equal(o0[:, :6], planes[0][:, COLS])
    np.testing.assert_array_equal(o0[:, 6:], 0.0)


def test_int16_truncates_toward_zero_and_saturates():
    cfg = ColumnCompactorConfig(n_rows=2, n_channels=4, width=4,
                                out_i16=True, scales=(1.0,))
    comp = ColumnCompactor(cfg, device="cpu")
    comp.set_mapping([0, 1, 2, 3])
    x = torch.tensor([[1.7, -1.7, 2.5, -2.5],
                      [40000.0, -40000.0, 32767.9, -0.4]])
    got = comp.dispatch(x)
    assert got.dtype == torch.int16
    assert got.tolist() == [[1, -1, 2, -2], [32767, -32768, 32767, 0]]
    ref = RefCompactor(RefCompactorConfig(
        n_rows=2, n_channels=4, width=4, channel_tile=4, out_i16=True,
        scales=(1.0,)), interpret=True)
    ref.set_mapping([0, 1, 2, 3])
    np.testing.assert_array_equal(np.asarray(ref.dispatch(x.numpy())),
                                  got.numpy())


def test_remap_rewrites_the_map_in_place():
    ref, ours = _pair(n_planes=1)
    slots = ours._slots
    ptr = slots.data_ptr()
    (x,) = _planes(1, seed=9)
    for cols in ([5], [7, 2], list(range(255, 239, -1)), []):
        ref.set_mapping(cols)
        ours.set_mapping(cols)
        assert ours._slots is slots and slots.data_ptr() == ptr
        assert slots.tolist() == cols + [-1] * (16 - len(cols))
        np.testing.assert_array_equal(ours(x)[0], ref(x)[0])
    with pytest.raises(AssertionError):
        ours.set_mapping(list(range(17)))


def test_non_finite_unmapped_column():
    """The gather never reads an unmapped column; the reference's
    one-hot matmul multiplies it by 0, so an inf there makes its whole
    output row NaN."""
    ref, ours = _pair(n_planes=1)
    (x,) = _planes(1, seed=4)
    x[10, 100] = np.inf
    ref.set_mapping(COLS)
    ours.set_mapping(COLS)
    got = ours(x)[0]
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got[:, :6], x[:, COLS])
    want = ref(x)[0]
    assert np.all(np.isnan(want[10]))
    np.testing.assert_array_equal(np.delete(got, 10, 0),
                                  np.delete(want, 10, 0))


def test_wrapper_runs_the_plain_version_on_cpu():
    ours = _pair()[1]
    ours.set_mapping(COLS)
    planes = tuple(torch.from_numpy(p) for p in _planes(3, seed=1))
    launches = compact.compact_kernel.launches
    got = compact.compact_kernel(planes, ours._slots, ours._runs, ours.cfg)
    want = compact.compact_kernel_reference(planes, ours._slots, ours.cfg)
    assert compact.compact_kernel.launches == launches
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        compact.compact_kernel(planes, ours._slots.to("meta"), ours._runs,
                               ours.cfg)


# column maps of the run-table tests, on 256 bank columns: (width, map)
MAPS = {
    "identity": (64, list(range(64))),
    "scattered": (64, sorted(np.random.default_rng(5).choice(
        256, 64, replace=False).tolist())),
    "holes": (64, [c if c % 11 else -1 for c in range(64)]),
    "unaligned": (64, list(range(1, 65))),
    "odd_width": (77, list(range(8, 80))),
}


def _plain_runs(slots, n_channels, v):
    """The run table by its definition, one run at a time."""
    table = []
    for j in range(-(-len(slots) // v)):
        run = list(slots[j * v:(j + 1) * v])
        table.append(int(
            len(run) == v and n_channels % 4 == 0 and run[0] >= 0
            and run[0] % 4 == 0
            and run == list(range(run[0], run[0] + v))))
    return table


@pytest.mark.parametrize("out", list(OUTS))
@pytest.mark.parametrize("name", list(MAPS))
def test_run_table_matches_its_definition(name, out):
    width, cols = MAPS[name]
    comp = ColumnCompactor(ColumnCompactorConfig(
        n_rows=64, n_channels=256, width=width, n_planes=3, **OUTS[out]),
        device="cpu")
    runs = comp._runs
    comp.set_mapping(cols)
    assert comp._runs is runs                 # rewritten in place
    full = cols + [-1] * (width - len(cols))
    v = compact.run_width(comp.cfg.dtype)
    assert v == (4 if out == "f32" else 8)
    assert comp._runs.tolist() == _plain_runs(full, 256, v)
    assert compact.run_table(full, 98, comp.cfg.dtype).sum() == 0
    if name == "identity":
        assert comp._runs.all()
    if name in ("unaligned", "scattered", "holes"):
        assert not comp._runs.all()


@pytest.mark.parametrize("out", list(OUTS))
@pytest.mark.parametrize("name", list(MAPS))
def test_compactor_gathers_every_run_map(name, out):
    """The compactor on the CPU (``compact_kernel``'s plain version) for
    each map against a plain numpy gather, and, where the map has no
    interior -1 (the reference selects its last column for one), against
    the reference."""
    width, cols = MAPS[name]
    geom = dict(n_rows=512, n_channels=256, width=width, n_planes=3,
                m_tile=128, **OUTS[out])
    ours = ColumnCompactor(ColumnCompactorConfig(**geom), device="cpu")
    ours.set_mapping(cols)
    planes = _planes(3, seed=width)
    got = ours(*planes)
    full = np.asarray(cols + [-1] * (width - len(cols)))
    for p, x in enumerate(planes):
        want = np.where(full >= 0, x[:, np.maximum(full, 0)], 0.0)
        if out == "bf16":
            want = torch.from_numpy(want.astype(np.float32)).to(
                torch.bfloat16).float().numpy()
        elif out == "i16":
            scale = np.float32(OUTS[out]["scales"][p])
            q = np.clip(want.astype(np.float32) * scale, -32768, 32767)
            want = q.astype(np.int16).astype(np.float32) * np.float32(
                1.0 / scale)
        np.testing.assert_array_equal(got[p], want.astype(np.float32))
    if -1 not in cols:
        ref = RefCompactor(RefCompactorConfig(**geom, channel_tile=128),
                           interpret=True)
        ref.set_mapping(cols)
        for a, b in zip(got, ref(*planes)):
            np.testing.assert_array_equal(a, _as_f32(b))


def test_config_matches_reference():
    for kw in (dict(n_rows=8192), dict(n_rows=1000), dict(n_rows=96)):
        geom = dict(n_channels=128, width=32, **kw)
        assert ColumnCompactorConfig(**geom).m_tile == \
            RefCompactorConfig(**geom).m_tile
    with pytest.raises(AssertionError):
        ColumnCompactorConfig(n_rows=8, n_channels=8, width=4,
                              out_i16=True)
