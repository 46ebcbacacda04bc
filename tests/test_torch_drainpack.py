"""The port's drain packer (``kernels/drainpack.py``) against the
reference's ``DrainPacker`` in interpret mode, at several layouts:
every section present, lane groups G 1, 2 and 4, squeezed digital rows,
no audio, no raw, no digital.

Tolerance: none for the int16 buffer and its decoded sections.  A gather
and the reference's one-hot matmul give the same value for finite
inputs (x·1 plus zeros), and the quantizer and the status residual split
are the same IEEE float32 operations on both sides.  The status values
decode within 1e-5 relative (4e-12 absolute) of the input; the one place
the two differ is stated in the module and held in
``test_non_finite_unmapped_column``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.kernels.drainpack import DrainPacker as RefPacker
from sigdigger_tpu.kernels.drainpack import (
    DrainPackerConfig as RefPackerConfig,
)
from sigdigger_tpu_torch.kernels import drainpack
from sigdigger_tpu_torch.kernels.drainpack import (
    DrainPacker,
    DrainPackerConfig,
)

C = 32

# name -> (config fields, live columns per section)
LAYOUTS = {
    "every_section": (
        dict(n_rows=256, audio_rows=64, width=16),
        dict(status=12, audio=5, digital=9, raw=3)),
    "grouped_g2": (
        dict(n_rows=256, audio_rows=64, width=16, audio_width=16,
             digital_width=8, raw_width=8),
        dict(status=12, audio=3, digital=4, raw=2)),
    "grouped_g4": (
        dict(n_rows=512, audio_rows=128, width=32, audio_width=8,
             digital_width=8, raw_width=16),
        dict(status=20, audio=8, digital=6, raw=11)),
    "squeezed_digital": (
        dict(n_rows=256, audio_rows=32, width=16, digital_width=8,
             digital_rows=64),
        dict(status=10, audio=7, digital=5, raw=2)),
    "no_audio": (
        dict(n_rows=256, audio_rows=64, width=16, has_audio=False,
             digital_width=8),
        dict(status=9, digital=6, raw=4)),
    "no_raw": (
        dict(n_rows=256, audio_rows=32, width=8, has_raw=False),
        dict(status=8, audio=3, digital=5)),
    "no_digital": (
        dict(n_rows=128, audio_rows=16, width=16, has_digital=False,
             raw_width=8),
        dict(status=14, audio=14, raw=8)),
}


def _inputs(cfg: DrainPackerConfig, seed: int):
    rng = np.random.default_rng(seed)
    x = {}
    if cfg.has_audio:
        # audio past the int16 range once scaled, to exercise the clip
        x["audio"] = (rng.standard_normal((cfg.audio_rows, C)) * 4.0
                      ).astype(np.float32)
    if cfg.has_digital:
        md = cfg.digital_rows
        x["dig"] = ((rng.standard_normal((md, C)) * 1.5).astype(np.float32),
                    (rng.standard_normal((md, C)) * 1.5).astype(np.float32),
                    (rng.random((md, C)) < 0.3).astype(np.float32))
    if cfg.has_raw:
        x["raw"] = tuple((rng.standard_normal((cfg.n_rows, C)) * 0.3)
                         .astype(np.float32) for _ in range(2))
    x["pw"] = np.logspace(-1, -9, C).astype(np.float32)[None,
                                                         rng.permutation(C)]
    x["sq"] = (rng.random((1, C)) * 0.05).astype(np.float32)
    return x


def _maps(live: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed + 100)
    return {sec: [int(v) for v in rng.choice(C, n, replace=False)]
            for sec, n in live.items()}


def _pair(name: str):
    fields, live = LAYOUTS[name]
    ref = RefPacker(RefPackerConfig(n_channels=C, **fields), interpret=True)
    ours = DrainPacker(DrainPackerConfig(n_channels=C, **fields),
                       device="cpu")
    maps = _maps(live, seed=len(name))
    status = maps.pop("status")
    ref.set_mappings(status, **maps)
    ours.set_mappings(status, **maps)
    return ref, ours, status, maps


def _dispatch(pk, x, as_torch: bool):
    conv = torch.from_numpy if as_torch else np.asarray
    kw = {k: (tuple(conv(a) for a in v) if isinstance(v, tuple)
              else conv(v)) for k, v in x.items()}
    return pk.dispatch(**kw)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_buffer_and_sections_match_reference(name):
    ref, ours, status, maps = _pair(name)
    cfg = ours.cfg
    assert cfg.sections() == ref.cfg.sections()
    assert (cfg.m_tile, cfg.total_tiles) == (ref.cfg.m_tile,
                                             ref.cfg.total_tiles)
    x = _inputs(cfg, seed=len(name))
    want = np.asarray(_dispatch(ref, x, False))
    got = _dispatch(ours, x, True)
    assert got.dtype == torch.int16
    assert tuple(got.shape) == (cfg.total_tiles * cfg.m_tile, cfg.width)
    np.testing.assert_array_equal(got.numpy(), want)
    s_ref, s_ours = ref.fetch(want), ours.fetch(got)
    assert s_ref.keys() == s_ours.keys()
    for k in s_ref:
        assert s_ours[k].dtype == s_ref[k].dtype, k
        np.testing.assert_array_equal(s_ours[k], s_ref[k], err_msg=k)
    # the decoded sections hold the mapped columns
    n = len(status)
    np.testing.assert_allclose(s_ours["power"][:n], x["pw"][0, status],
                               rtol=1e-5, atol=4e-12)
    np.testing.assert_allclose(s_ours["sq"][:n], x["sq"][0, status],
                               rtol=1e-5, atol=4e-12)
    if "digital" in maps:
        cols = maps["digital"]
        np.testing.assert_array_equal(
            s_ours["strobe"][:, :len(cols)], x["dig"][2][:, cols] > 0.5)
        # soft symbols saturate at ±4 (D_SCALE 8192 into int16)
        np.testing.assert_allclose(
            s_ours["soft"][:, :len(cols)].real,
            np.clip(x["dig"][0][:, cols], -4.0, 32767 / 8192),
            rtol=0, atol=1.0 / 8192)
    if "raw" in maps:
        cols = maps["raw"]
        np.testing.assert_allclose(s_ours["y_im"][:, :len(cols)],
                                   x["raw"][1][:, cols], rtol=0,
                                   atol=1.0 / 4096)


def test_drainpack_status_precision_small_powers():
    """The reference's test_kernel_engine.py:446, on the port: the
    3-lane residual status encoding round-trips channel powers and
    squelch EMAs from 1e-1 down to 1e-9 at float32 precision (a single
    ×256 int16 lane would round them to zero)."""
    c, w = 16, 8
    cfg = DrainPackerConfig(n_rows=64, audio_rows=8, n_channels=c,
                            width=w, has_audio=True, has_digital=False,
                            has_raw=True)
    pk = DrainPacker(cfg, device="cpu")
    pk.set_mapping(list(range(w)))
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((8, c)).astype(np.float32) * 0.1
    y_re = rng.standard_normal((64, c)).astype(np.float32) * 0.01
    y_im = rng.standard_normal((64, c)).astype(np.float32) * 0.01
    pw = np.logspace(-1, -9, c).astype(np.float32)[None, :]
    sq = (pw * 0.5).astype(np.float32)
    sec = pk.fetch(pk.dispatch(audio=torch.from_numpy(audio),
                               sq=torch.from_numpy(sq),
                               pw=torch.from_numpy(pw),
                               raw=(torch.from_numpy(y_re),
                                    torch.from_numpy(y_im))))
    np.testing.assert_allclose(sec["power"], pw[0, :w], rtol=1e-5,
                               atol=4e-12)
    np.testing.assert_allclose(sec["sq"], sq[0, :w], rtol=1e-5,
                               atol=4e-12)
    # AGC gain derived from the drained power must match the true gain
    g_true = 1.0 / np.sqrt(pw[0, :w])
    g_got = 1.0 / np.sqrt(np.maximum(sec["power"], 1e-18))
    np.testing.assert_allclose(g_got, g_true, rtol=1e-4)


def test_quantizer_truncates_toward_zero_and_saturates():
    cfg = DrainPackerConfig(n_rows=8, audio_rows=8, n_channels=4, width=8,
                            has_digital=False, has_raw=False)
    pk = DrainPacker(cfg, device="cpu")
    pk.set_mappings([0, 1, 2, 3], audio=[0, 1, 2, 3])
    a = np.zeros((8, 4), np.float32)
    a[0] = [1.5 / 4096, -1.5 / 4096, 9.0, -9.0]
    got = pk.dispatch(audio=torch.from_numpy(a))
    np.testing.assert_array_equal(got[0, :4].numpy(),
                                  [1, -1, 32767, -32768])
    np.testing.assert_array_equal(got[0, 4:].numpy(), 0)


def test_remap_rewrites_the_index_lists_in_place():
    """A slot-lifecycle change rewrites the device lists; nothing is
    rebuilt, and an empty lane packs 0."""
    _, ours, status, maps = _pair("every_section")
    lists = dict(ours._maps)
    x = _inputs(ours.cfg, seed=5)
    ours.set_mappings(status[:3], audio=maps["audio"][:1], digital=[],
                      raw=maps["raw"])
    assert all(ours._maps[k] is v for k, v in lists.items())
    sec = ours.fetch(_dispatch(ours, x, True))
    np.testing.assert_array_equal(sec["audio"][:, 1:], 0.0)
    np.testing.assert_array_equal(sec["soft"], 0.0)
    np.testing.assert_array_equal(sec["power"][3:], 0.0)


def test_non_finite_unmapped_column():
    """Divergence from the reference, by design: an inf in a column no
    lane maps stays out of the port's pack, where the reference's
    one-hot matmul (inf·0 = NaN) turns that row of the section NaN."""
    ref, ours, status, maps = _pair("every_section")
    x = _inputs(ours.cfg, seed=7)
    free = next(c for c in range(C) if c not in maps["audio"])
    x["audio"][0, free] = np.inf
    got = ours.fetch(_dispatch(ours, x, True))
    want = ref.fetch(np.asarray(_dispatch(ref, x, False)))
    cols = maps["audio"]
    np.testing.assert_allclose(got["audio"][0, :len(cols)],
                               np.clip(x["audio"][0, cols], -8, 8),
                               rtol=0, atol=1.0 / 4096)
    assert not np.array_equal(want["audio"][0], got["audio"][0])
    np.testing.assert_array_equal(got["audio"][1:], want["audio"][1:])


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch():
    _, ours, _, _ = _pair("grouped_g2")
    x = _inputs(ours.cfg, seed=9)
    before = drainpack.pack_kernel.launches
    _dispatch(ours, x, True)
    assert drainpack.pack_kernel.launches == before
    with pytest.raises(ValueError):
        drainpack.pack_kernel({}, torch.zeros((1, C), device="meta"),
                              torch.zeros((1, C), device="meta"),
                              ours._maps, ours.cfg)


def test_layout_rules_match_reference():
    for fields, _ in LAYOUTS.values():
        a = RefPackerConfig(n_channels=C, **fields)
        b = DrainPackerConfig(n_channels=C, **fields)
        assert (a.m_tile, a.sections(), a.total_tiles) == \
            (b.m_tile, b.sections(), b.total_tiles)
    with pytest.raises(ValueError):
        DrainPackerConfig(n_rows=64, audio_rows=8, n_channels=C, width=16,
                          audio_width=6)


def test_drainpack_lane_grouping_roundtrip():
    """The reference's test_kernel_engine.py:564, on the port: sections
    narrower than the buffer fold G consecutive time tiles into the lane
    groups of one output tile and demap to their columns."""
    c = 32
    cfg = DrainPackerConfig(n_rows=256, audio_rows=64, n_channels=c,
                            width=16, audio_width=16, digital_width=8,
                            raw_width=8)
    assert cfg.group("digital") == 2 and cfg.group("raw") == 2
    pk = DrainPacker(cfg, device="cpu")
    audio, digital, raw = [0, 2, 4], [5, 6, 7, 8], [9, 11]
    pk.set_mappings(list(range(12)), audio=audio, digital=digital, raw=raw)
    rng = np.random.default_rng(7)
    a = rng.standard_normal((64, c)).astype(np.float32)
    planes = [rng.standard_normal((256, c)).astype(np.float32) * 0.3
              for _ in range(5)]
    strobe = (rng.random((256, c)) < 0.3).astype(np.float32)
    sq = rng.random((1, c)).astype(np.float32) * 0.01
    pw = rng.random((1, c)).astype(np.float32) * 0.01
    t = torch.from_numpy
    sec = pk.fetch(pk.dispatch(
        audio=t(a), sq=t(sq), pw=t(pw),
        dig=(t(planes[0]), t(planes[1]), t(strobe)),
        raw=(t(planes[3]), t(planes[4]))))
    assert sec["audio"].shape == (64, 16)
    assert sec["soft"].shape == (256, 8)
    assert sec["y_re"].shape == (256, 8)
    for w_col, ch in enumerate(audio):
        np.testing.assert_allclose(sec["audio"][:, w_col], a[:, ch],
                                   atol=1.0 / 4096)
    for w_col, ch in enumerate(digital):
        np.testing.assert_allclose(sec["soft"][:, w_col].real,
                                   planes[0][:, ch], atol=1.0 / 8192)
        np.testing.assert_array_equal(sec["strobe"][:, w_col],
                                      strobe[:, ch] > 0.5)
    for w_col, ch in enumerate(raw):
        np.testing.assert_allclose(sec["y_re"][:, w_col], planes[3][:, ch],
                                   atol=1.0 / 4096)
        np.testing.assert_allclose(sec["y_im"][:, w_col], planes[4][:, ch],
                                   atol=1.0 / 4096)
    np.testing.assert_allclose(sec["power"][:12], pw[0, :12], rtol=1e-5,
                               atol=4e-12)
    np.testing.assert_allclose(sec["sq"][:12], sq[0, :12], rtol=1e-5,
                               atol=4e-12)


def _emulate_kernel(table, planes, sq, pw, maps, cfg):
    """csrc/drainpack.cu's addressing in numpy: every entry of the block
    table packs its rows 8 lanes at a time, as the kernel's threads do
    (the quantizer and the residual split from the plain version)."""
    mt, w = cfg.m_tile, cfg.width
    out = np.full((cfg.total_tiles * mt, w), 12345, np.int16)
    kinds = {v: k for k, v in drainpack.SECTION_IDS.items()}
    for kind, row0, src0, nrows, ws, bits, _, _ in table:
        name = kinds[int(kind)]
        assert 1 <= nrows and row0 + nrows <= len(out)
        for l0 in range(0, w, drainpack.LANES):
            lanes = slice(l0, l0 + drainpack.LANES)
            if name == "zero":
                out[row0:row0 + nrows, lanes] = 0
                continue
            if name == "status":
                col = maps["status"][lanes]
                for r in range(nrows):
                    src = (sq if r < 3 else pw)[0]
                    v = np.where(col >= 0, src[np.maximum(col, 0)], 0.0)
                    out[row0 + r, lanes] = drainpack._residual3(
                        torch.from_numpy(v.astype(np.float32)))[r % 3].numpy()
                continue
            g = l0 // ws
            col = maps[drainpack._SEL_OF[name]][l0 - g * ws:][:8]
            scale = np.int32(bits).view(np.float32)
            for r in range(nrows):
                row = planes[name][src0 + g * mt + r]
                v = np.where(col >= 0, row[np.maximum(col, 0)], 0.0)
                out[row0 + r, lanes] = drainpack._quantize(
                    torch.from_numpy(v.astype(np.float32)), scale).numpy()
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_block_table_matches_sections(name):
    """The kernel's block table against ``DrainPackerConfig.sections()``:
    every output row in exactly one entry, each entry inside one tile of
    its section (or the status tile's rows 0-5, or its zero rows 6..),
    its source rows the ones that tile's lane groups read, its width and
    scale the section's; and the kernel's addressing through the table,
    emulated in numpy, gives the plain version's buffer bit for bit."""
    _, ours, _, _ = _pair(name)
    cfg = ours.cfg
    mt = cfg.m_tile
    table = drainpack.block_table(cfg)
    kinds = {v: k for k, v in drainpack.SECTION_IDS.items()}
    cover = np.zeros(cfg.total_tiles * mt, np.int64)
    rb = drainpack.THREAD_ROWS * (drainpack.BLOCK_THREADS
                                  // drainpack.lane_octets(cfg.width))
    lay = {s: (t0, cnt, g) for s, t0, cnt, g in cfg.sections()}
    for kind, row0, src0, nrows, ws, bits, *_ in table.tolist():
        cover[row0:row0 + nrows] += 1
        assert 1 <= nrows <= rb
        t, r = divmod(row0, mt)
        assert (row0 + nrows - 1) // mt == t         # inside one tile
        sec = kinds[kind]
        if sec in ("status", "zero"):
            assert t == lay["status"][0]
            assert (r, nrows) == (0, 6) if sec == "status" else r >= 6
            continue
        t0, cnt, g = lay[sec]
        assert t0 <= t < t0 + cnt
        assert src0 == (t - t0) * g * mt + r
        assert ws == cfg.width // g and ws % drainpack.LANES == 0
        assert np.int32(bits).view(np.float32) == drainpack._SCALES[sec]
    np.testing.assert_array_equal(cover, 1)
    x = _inputs(cfg, seed=len(name))
    planes = {"audio": x.get("audio")}
    if cfg.has_digital:
        planes.update(zip(("d_sr", "d_si", "d_st"), x["dig"]))
    if cfg.has_raw:
        planes.update(zip(("y_re", "y_im"), x["raw"]))
    maps = {k: v.numpy() for k, v in ours._maps.items()}
    got = _emulate_kernel(table, planes, x["sq"], x["pw"], maps, cfg)
    want = _dispatch(ours, x, True).numpy()
    np.testing.assert_array_equal(got, want)


def test_block_table_spreads_small_packs():
    """Rows a thread: 4 when the pack has blocks enough for the card
    (MIN_BLOCKS), fewer for a small one (the bench session's 5 tiles of
    64 rows at width 1024: one row a thread, 41 runs × 4 lane spans)."""
    big = DrainPackerConfig(n_rows=8192, audio_rows=256, n_channels=1024,
                            width=1024, audio_width=512, digital_width=512,
                            raw_width=512, digital_rows=2048)
    small = DrainPackerConfig(n_rows=8192, audio_rows=256, n_channels=1024,
                              width=1024, has_digital=False, has_raw=False,
                              m_tile=64)
    assert drainpack.block_table(big)[:, 3].max() == 32      # 8 rows × 4
    t = drainpack.block_table(small)
    assert t[:, 3].max() == 8 and len(t) == 41


def test_wrapper_checks_and_dispatch_keep_device_tensors():
    """The CUDA wrapper's checks, run on CPU tensors: the right ones
    pass, a plane of the wrong height or dtype and a missing map raise;
    ``dispatch`` hands a tensor already on the packer's device on as it
    is (no copy, no conversion)."""
    _, ours, _, _ = _pair("grouped_g4")
    cfg = ours.cfg
    x = _inputs(cfg, seed=3)
    planes = {"audio": torch.from_numpy(x["audio"])}
    planes.update(zip(("d_sr", "d_si", "d_st"),
                      map(torch.from_numpy, x["dig"])))
    planes.update(zip(("y_re", "y_im"), map(torch.from_numpy, x["raw"])))
    sq, pw = torch.from_numpy(x["sq"]), torch.from_numpy(x["pw"])
    cpu = torch.device("cpu")
    drainpack._check(planes, sq, pw, ours._maps, cfg, cpu)
    for bad in (dict(planes, audio=planes["audio"][:8]),
                dict(planes, y_im=planes["y_im"].double())):
        with pytest.raises(ValueError):
            drainpack._check(bad, sq, pw, ours._maps, cfg, cpu)
    with pytest.raises(ValueError):
        drainpack._check(planes, sq, pw, {"status": ours._maps["status"]},
                         cfg, cpu)
    assert ours._on_device(sq) is sq
    assert torch.equal(ours._on_device(x["sq"]), sq)


def test_plan_goes_with_its_layout(monkeypatch):
    """The CUDA wrapper's plan of a layout (its block table, its checked
    argument keys) lives as long as the layout and no longer, so a long
    run that builds layouts does not keep their tables.  Run on CPU
    tensors with the entry point replaced by a stand-in."""
    import gc

    monkeypatch.setattr(drainpack, "load_library",
                        lambda name: type("Lib", (), {
                            "sd_drainpack": staticmethod(lambda *a: 0)}))
    monkeypatch.setattr(drainpack, "launch", lambda fn, dev, *a: fn(*a))
    monkeypatch.setattr(drainpack.pack_kernel, "launches", 0)
    before = set(drainpack._PLANS)
    fields, live = LAYOUTS["grouped_g4"]
    pk = DrainPacker(DrainPackerConfig(n_channels=C, **fields),
                     device="cpu")
    x = _inputs(pk.cfg, seed=4)
    planes = {"audio": torch.from_numpy(x["audio"])}
    planes.update(zip(("d_sr", "d_si", "d_st"),
                      map(torch.from_numpy, x["dig"])))
    planes.update(zip(("y_re", "y_im"), map(torch.from_numpy, x["raw"])))
    sq, pw = torch.from_numpy(x["sq"]), torch.from_numpy(x["pw"])
    for _ in range(2):
        out = drainpack.pack_kernel.cuda(planes, sq, pw, pk._maps, pk.cfg)
    assert out.shape == (pk.cfg.total_tiles * pk.cfg.m_tile, pk.cfg.width)
    assert drainpack.pack_kernel.launches == 2
    (key,) = set(drainpack._PLANS) - before
    plan = drainpack._PLANS[key]
    assert key == (id(pk.cfg), torch.device("cpu")) and len(plan.checked) == 1
    with pytest.raises(ValueError):            # a plane of the wrong height
        drainpack.pack_kernel.cuda(dict(planes, audio=planes["audio"][:8]),
                                   sq, pw, pk._maps, pk.cfg)
    del pk
    gc.collect()
    assert set(drainpack._PLANS) == before
