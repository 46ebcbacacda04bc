"""The port's multi-process layer (``parallel/distributed.py``) against
the reference's ``tests/test_distributed.py``: two processes join a
``torch.distributed`` group (gloo), each drives the cells of its channel
half of a hybrid ("time", "ch") mesh over ``[cpu] * 4`` with the sharded
pipeline, and rank 0 holds its channels' audio and the PSD against the
single-process pipeline (FM exact by the halos: atol 2e-3 and rtol
1e-3, the reference's).  Each child has a 240 s timeout and is killed
after it."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import sys
    pid = int(sys.argv[1]); port = sys.argv[2]
    import numpy as np
    import torch
    from sigdigger_tpu_torch.parallel import distributed
    from sigdigger_tpu_torch.parallel.sharding import shard_pipeline
    from sigdigger_tpu_torch.pipeline import (
        PipelineConfig, init_state, jit_pipeline, make_constants)

    distributed.initialize(f"localhost:{port}", num_processes=2,
                           process_id=pid)
    assert torch.distributed.get_backend() == "gloo"
    assert distributed.process_count() == 2

    cfg = PipelineConfig(sample_rate=1_024_000.0, fft_size=1024,
                         n_channels=8, n_sub=64, demod="fm")
    stations = np.linspace(-400e3, 400e3, 8)
    consts = make_constants(cfg, stations, np.full(8, 30e3), device="cpu")

    n = 1 << 15
    t = np.arange(n) / cfg.sample_rate
    x = np.zeros(n, np.complex128)
    for f0 in stations:
        msg = np.sin(2 * np.pi * 800.0 * t)
        x += 0.5 * np.exp(1j * (2 * np.pi * f0 * t
                                + 2 * np.pi * 5000.0
                                * np.cumsum(msg) / cfg.sample_rate))
    x = x.astype(np.complex64)

    mesh = distributed.make_hybrid_mesh(
        n_time=4, devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"time": 4, "ch": 2}
    # the ch axis spans processes, time does not
    assert len({int(mesh.ranks[i, 0]) for i in range(4)}) == 1
    assert {int(mesh.ranks[0, j]) for j in range(2)} == {0, 1}
    assert distributed.process_channels(mesh, 8) == slice(4 * pid,
                                                          4 * pid + 4)

    state0 = init_state(cfg, device="cpu")
    step = shard_pipeline(cfg, mesh)(consts, state0)
    xg = distributed.host_array(mesh, None, x)
    state, out = step(consts, state0, xg)
    mine = distributed.local_outputs(out["audio"])
    assert [idx[0] for idx, _ in mine] == [slice(4 * pid, 4 * pid + 4)]

    if pid == 0:
        ref_state, ref_out = jit_pipeline(cfg)(
            consts, init_state(cfg, device="cpu"), x)
        a_ref = ref_out["audio"].numpy()
        for index, data in mine:
            assert np.allclose(data, a_ref[index], atol=2e-3), \\
                np.abs(data - a_ref[index]).max()
        assert np.allclose(out["psd"].numpy(), ref_out["psd"].numpy(),
                           rtol=1e-3, atol=1e-8)
    torch.distributed.barrier()
    distributed.shutdown()
    print(f"OK {pid}", flush=True)
""")


def test_two_process_pipeline(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=ROOT) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"OK {i}" in out


def test_single_process_is_a_no_op_and_meshes_are_local():
    from sigdigger_tpu_torch.parallel import distributed

    distributed.initialize()                 # WORLD_SIZE unset: no-op
    assert not torch.distributed.is_initialized()
    assert distributed.process_count() == 1
    mesh = distributed.make_hybrid_mesh(
        n_time=2, devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"time": 2, "ch": 2}
    assert mesh.local().all()
    assert distributed.process_channels(mesh, 8) == slice(0, 8)
    with pytest.raises(ValueError, match="3x1 != 4"):
        distributed.make_hybrid_mesh(n_time=3,
                                     devices=[torch.device("cpu")] * 4)
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    full = distributed.host_array(mesh, None, x, global_shape=(4, 2))
    assert torch.equal(full, torch.from_numpy(x))
    # a whole tensor is this process's one shard
    (idx, data), = distributed.local_outputs(torch.ones(2, 3))
    assert idx == (slice(None), slice(None)) and data.shape == (2, 3)
