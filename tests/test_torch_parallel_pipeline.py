"""The port's sharded pipeline (``parallel/sharding.py``) against the
reference's (``tests/test_pipeline.py:124-190``): the same FM stations,
configurations and (n_time, n_ch) meshes, the port's on ``[cpu] * 8``,
the reference's on its 8 virtual CPU devices.

Tolerances: against the reference's sharded step, the PSD within rtol
1e-3 (the oracle's), FM and AM audio within 2e-3 and 3e-3 (the
port's unsharded FM differs from the reference's by up to ~1.3e-3 at
the first block's start, tests/test_torch_pipeline.py), raw IQ within
3e-3, psk strobes agreeing on more than 99.5% of samples and the
symbols within 3e-3 where both strobe on more than 99.5% of them (the
oracle's), that bound times the symbol's magnitude where it passes 1:
on the first block the AGC starts at its gain cap on the zero tail and
the symbols reach ~280; the carried tail within 1e-5 and phase within
1e-4 of the port's unsharded step (the oracle's); against the port's
unsharded step, every output within 1e-5 (psk under
``handoff="exact"``: equal strobes and the symbols within the oracle's
3e-3 plus 1e-4 of themselves, for the same start-up gain: the time
shards' channel samples round apart by ~1e-7 and the loops carry it).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.parallel.sharding import make_mesh as ref_make_mesh
from sigdigger_tpu.parallel.sharding import shard_pipeline as ref_shard
from sigdigger_tpu.pipeline import PipelineConfig as RefConfig
from sigdigger_tpu.pipeline import init_state as ref_init
from sigdigger_tpu.pipeline import make_constants as ref_consts
from sigdigger_tpu_torch.parallel.sharding import (
    _demod_output_keys,
    make_mesh,
    shard_pipeline,
)
from sigdigger_tpu_torch.pipeline import (
    PipelineConfig,
    init_state,
    jit_pipeline,
    make_constants,
)

CPUS = [torch.device("cpu")] * 8
STATIONS = np.linspace(-400e3, 400e3, 8)


def fm_signal(n, fs, stations, dev=5000.0, fm=800.0):
    t = np.arange(n) / fs
    x = np.zeros(n, np.complex128)
    for f0 in stations:
        msg = np.sin(2 * np.pi * fm * t)
        x += 0.5 * np.exp(1j * (2 * np.pi * f0 * t +
                                2 * np.pi * dev * np.cumsum(msg) / fs))
    return x.astype(np.complex64)


def _pair(demod):
    kw = dict(sample_rate=1_024_000.0, fft_size=1024, n_channels=8,
              n_sub=64, demod=demod)
    cfg, rcfg = PipelineConfig(**kw), RefConfig(**kw)
    return (cfg, make_constants(cfg, STATIONS, np.full(8, 30e3),
                                device="cpu"),
            rcfg, ref_consts(rcfg, STATIONS, np.full(8, 30e3)))


def _run(step, consts, state, x, blocks):
    outs = []
    for _ in range(blocks):
        state, out = step(consts, state, x)
        outs.append(out)
    return state, outs


@pytest.mark.parametrize("n_time,n_ch", [(1, 8), (8, 1), (2, 4), (4, 2)])
def test_sharded_matches_single_device(n_time, n_ch):
    cfg, consts, rcfg, rconsts = _pair("fm")
    x = fm_signal(1 << 15, cfg.sample_rate, STATIONS)
    s_one, (o_one,) = _run(jit_pipeline(cfg), consts,
                           init_state(cfg, device="cpu"), x, 1)
    step = shard_pipeline(cfg, make_mesh(n_time, n_ch, CPUS))(
        consts, init_state(cfg, device="cpu"))
    s_sh, (o_sh,) = _run(step, consts, init_state(cfg, device="cpu"), x, 1)
    rstep = ref_shard(rcfg, ref_make_mesh(n_time, n_ch))(
        rconsts, ref_init(rcfg))
    _, (o_ref,) = _run(rstep, rconsts, ref_init(rcfg), x, 1)
    a_sh = o_sh["audio"].numpy()
    assert a_sh.shape == np.asarray(o_ref["audio"]).shape
    assert np.allclose(a_sh, np.asarray(o_ref["audio"]), atol=2e-3)
    assert np.allclose(o_sh["psd"].numpy(), np.asarray(o_ref["psd"]),
                       rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(a_sh, o_one["audio"].numpy(), atol=1e-5)
    np.testing.assert_allclose(o_sh["psd"].numpy(), o_one["psd"].numpy(),
                               rtol=1e-5, atol=1e-12)
    # the carried state equals the unsharded step's
    assert np.allclose(s_sh["tail"].numpy(), s_one["tail"].numpy(),
                       atol=1e-5)
    assert np.allclose(s_sh["phi"].numpy(), s_one["phi"].numpy(), atol=1e-4)
    assert int(s_sh["psd_count"]) == int(s_one["psd_count"])
    assert int(s_sh["frame_parity"]) == int(s_one["frame_parity"])


@pytest.mark.parametrize("demod", ["am", "raw", "psk"])
@pytest.mark.parametrize("n_time,n_ch", [(8, 1), (2, 4), (4, 2)])
def test_sharded_matches_single_device_all_demods(demod, n_time, n_ch):
    """Every demod, over two blocks (the cross-shard and the cross-block
    carries): AM exact by the closed-form DC reshard, psk exact under
    ``handoff="exact"``, raw without recurrent state."""
    cfg, consts, rcfg, rconsts = _pair(demod)
    x = fm_signal(1 << 15, cfg.sample_rate, STATIONS)
    _, one = _run(jit_pipeline(cfg), consts, init_state(cfg, device="cpu"),
                  x, 2)
    step = shard_pipeline(cfg, make_mesh(n_time, n_ch, CPUS),
                          handoff="exact")(consts,
                                           init_state(cfg, device="cpu"))
    s_sh, got = _run(step, consts, init_state(cfg, device="cpu"), x, 2)
    rstep = ref_shard(rcfg, ref_make_mesh(n_time, n_ch), handoff="exact")(
        rconsts, ref_init(rcfg))
    _, ref = _run(rstep, rconsts, ref_init(rcfg), x, 2)
    assert set(got[0]) == set(_demod_output_keys(cfg)) | {"psd"}
    for o_sh, o_one, o_ref in zip(got, one, ref):
        if demod == "psk":
            sa = np.asarray(o_ref["strobes"])
            sb = o_sh["strobes"].numpy()
            assert (sa == sb).mean() > 0.995
            both = sa & sb
            ya = np.asarray(o_ref["symbols"])[both]
            d = np.abs(ya - o_sh["symbols"].numpy()[both])
            assert (d < 3e-3 * np.maximum(np.abs(ya), 1.0)).mean() > 0.995
            np.testing.assert_array_equal(sb, o_one["strobes"].numpy())
            np.testing.assert_allclose(o_sh["symbols"].numpy(),
                                       o_one["symbols"].numpy(), rtol=1e-4,
                                       atol=3e-3)
            continue
        k = {"am": "audio", "raw": "iq"}[demod]
        a, b = np.asarray(o_ref[k]), o_sh[k].numpy()
        assert a.shape == b.shape
        assert np.allclose(b, a, atol=3e-3), (k, np.abs(b - a).max())
        np.testing.assert_allclose(b, o_one[k].numpy(), atol=1e-5)
    if demod == "am":
        assert np.isfinite(s_sh["dc"].numpy()).all()


def test_replica_handoff_runs_every_time_shard_from_the_carry():
    """``handoff="replica"``: each time shard's loops restart from the
    carried state, so only the first shard's symbols equal the
    unsharded step's; the call shape and the keys stay."""
    cfg, consts, _, _ = _pair("psk")
    x = fm_signal(1 << 14, cfg.sample_rate, STATIONS)
    step = shard_pipeline(cfg, make_mesh(2, 1, CPUS))(
        consts, init_state(cfg, device="cpu"))
    _, out = step(consts, init_state(cfg, device="cpu"), x)
    _, one = jit_pipeline(cfg)(consts, init_state(cfg, device="cpu"), x)
    half = out["symbols"].shape[1] // 2
    np.testing.assert_allclose(out["symbols"][:, :half].numpy(),
                               one["symbols"][:, :half].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="handoff"):
        shard_pipeline(cfg, make_mesh(2, 1, CPUS), handoff="bogus")
    with pytest.raises(ValueError, match="need 16 devices"):
        make_mesh(4, 4, CPUS)
