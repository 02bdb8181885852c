"""``parallel.multihost`` of the port, and the sharded pipeline across two
processes.

The two-process test runs ``multihost.launch_ranks``: two fresh
interpreters (``multihost.rank_main``), joined by a ``torch.distributed``
gloo group on a free localhost port.  Each reads only its half of four
dwell files (``host_local_time_range``), lays it out over its four shards
of an 8-shard mesh (``devices=["cpu"] * 4`` each) and runs
``ShardedPipeline``'s oracle ``step`` on an (8, 1) mesh and its packed cm2
step on a (4, 2) mesh; the test holds the rows they write against the
single-process 8-shard run of the port (``multihost.run_capture_set``), bit
for bit, and against the JAX package's single-process run.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FS = 8e6
M = 8
HALO = 64


def _cfg():
    from sdr_channelizer_tpu_torch.config import PdwConfig

    return PdwConfig.channelized(max_pulses=32, max_pulse_samples=64)


def _job() -> dict:
    """The oracle step on (8, 1) and the packed cm2 step on (4, 2)."""
    return {"channels": M, "pdw": dataclasses.asdict(_cfg()),
            "halo_frames": HALO, "halo_mode": "strict",
            "runs": [{"name": "", "mesh": [8, 1], "step": "step"},
                     {"name": "cm2_", "mesh": [4, 2], "step": "packed",
                      "route": "cm2"}]}


def write_dwells(directory, n_files: int = 4) -> int:
    """Contiguous 16-bit dwell files whose pulses straddle the split
    between the two processes; returns the total sample count."""
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.signal.synth import (
        PulseTrainSpec,
        pulse_train,
    )

    spec = PulseTrainSpec(sample_rate_sps=FS, duration_sec=8e-3,
                          frequency_hz=1.9e6, pulse_width_sec=80e-6,
                          pri_sec=310e-6, start_index=333, noise_std=2e-3)
    iq = pulse_train(spec, seed=11)
    chunk = len(iq) // n_files
    for k in range(n_files):
        part = iq[k * chunk:(k + 1) * chunk]
        hdr = iqpacket.IqHeader(
            frequency_hz=0, bandwidth_hz=FS, sample_rate_sps=FS,
            rx_gain_db=0, num_samples=len(part), bit_width=16,
            sample_start_time=100.0 + k * chunk / FS)
        iqpacket.write_iq(os.path.join(directory, f"d{k}.iq"), hdr,
                          iqpacket.from_complex(part, 16))
    return chunk * n_files


def _segment(directory):
    from sdr_channelizer_tpu_torch.dsp.streaming import CaptureSet

    return CaptureSet.from_dir(str(directory)).segments[0]


# ---------------------------------------------------------------- tests

def test_time_shard_bounds_and_the_local_range_match_jax():
    from sdr_channelizer_tpu.parallel import make_mesh as jmake_mesh
    from sdr_channelizer_tpu.parallel import multihost as jmh
    from sdr_channelizer_tpu_torch.parallel import make_mesh
    from sdr_channelizer_tpu_torch.parallel import multihost as tmh

    for n, k in ((1000, 4), (64, 8), (9, 3)):
        assert tmh.time_shard_bounds(n, k) == jmh.time_shard_bounds(n, k)
    with pytest.raises(ValueError, match="divisible"):
        tmh.time_shard_bounds(10, 4)
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    assert tmh.host_local_time_range(mesh, 800) == \
        jmh.host_local_time_range(jmake_mesh(4, 2), 800) == (0, 800)


def test_ingest_and_global_capture_in_one_process(tmp_path):
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.parallel import make_mesh
    from sdr_channelizer_tpu_torch.parallel.multihost import (
        ingest_capture_set,
        make_global_capture,
    )

    n = write_dwells(tmp_path)
    seg = _segment(tmp_path)
    iq = np.concatenate([
        iqpacket.to_complex(np.asarray(iqpacket.read_iq(p)[1]), h.bit_width)
        for p, h in zip(seg.paths, seg.headers)])
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    cap = ingest_capture_set(mesh, seg, n)
    assert cap.n_samples == n and sorted(cap.parts) == mesh.local_shards
    for (i, j), part in cap.parts.items():
        np.testing.assert_array_equal(part.numpy(),
                                      iq[i * n // 4:(i + 1) * n // 4])
    # a span that does not cover this process's shards is refused
    with pytest.raises(ValueError, match="outside"):
        make_global_capture(mesh, iq[: n // 2], n, 0)


def test_two_processes_match_one_process_and_jax(tmp_path):
    """Two gloo ranks, four shards each: the stitched rows equal the
    single-process port run bit for bit, and the JAX package's run."""
    from sdr_channelizer_tpu_torch.parallel.multihost import (
        launch_ranks,
        run_capture_set,
    )

    n = write_dwells(tmp_path)
    z0, z1 = launch_ranks(str(tmp_path), _job(), [["cpu"] * 4] * 2,
                          timeout=240)
    # disjoint spans that cover the capture
    for name in ("", "cm2_"):
        assert tuple(z0[name + "span"]) == (0, n // 2)
        assert tuple(z1[name + "span"]) == (n // 2, n)

    one = run_capture_set(str(tmp_path), ["cpu"] * 8, _job())
    for key in one:
        if key.endswith("span"):
            continue
        if key.endswith("nf"):
            for z in (z0, z1):
                np.testing.assert_array_equal(z[key], one[key], err_msg=key)
            continue
        np.testing.assert_array_equal(np.concatenate([z0[key], z1[key]]),
                                      one[key], err_msg=key)
    assert int(one["count"].sum()) > 10 and int(one["cm2_count"].sum()) > 10

    # the JAX package's single-process 8-device run of the oracle step
    import jax.numpy as jnp

    from sdr_channelizer_tpu.config import PdwConfig as JPdwConfig
    from sdr_channelizer_tpu.dsp.channelizer import Channelizer as JChan
    from sdr_channelizer_tpu.io import iqpacket
    from sdr_channelizer_tpu.parallel import make_mesh as jmake_mesh
    from sdr_channelizer_tpu.parallel.pipeline import ShardedPipeline as JPipe

    seg = _segment(tmp_path)
    iq = np.concatenate([
        iqpacket.to_complex(np.asarray(iqpacket.read_iq(p)[1]), h.bit_width)
        for p, h in zip(seg.paths, seg.headers)])
    jcfg = JPdwConfig(**dataclasses.asdict(_cfg()))
    jpipe = JPipe(jmake_mesh(n_time=8, n_chan=1), JChan.create(M), jcfg,
                  halo_frames=HALO, halo_mode="strict")
    _, _, ref = jpipe.step(jnp.asarray(iq))
    for f in ("toa_idx", "te_idx", "saturated", "valid", "count"):
        np.testing.assert_array_equal(
            np.concatenate([z0[f], z1[f]]), np.asarray(getattr(ref, f)),
            err_msg=f)
    for f in ("pw_sec", "mag"):
        np.testing.assert_allclose(np.concatenate([z0[f], z1[f]]),
                                   np.asarray(getattr(ref, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)

