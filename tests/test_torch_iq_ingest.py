"""``io.iqpacket.to_complex``'s one pass, on the caller's thread and cut
into row chunks on its thread pool: bit for bit the JAX package's
``to_complex`` for every payload type, byte order, layout and output type,
at sizes about the pool's threshold (set low here, so that chunk edges
fall at odd rows); its counters; its pool made again in a forked child."""

import os
import signal
import time

import numpy as np
import pytest

from sdr_channelizer_tpu.io import iqpacket as jiq
from sdr_channelizer_tpu_torch.io import iqpacket as tiq
from sdr_channelizer_tpu_torch.utils import profiling

THRESHOLD_ROWS = 1001     # the pool's three chunks end at rows 333 and 667
WORKERS = 3


@pytest.fixture
def small_pool(monkeypatch):
    """A pool of three workers, whatever the host's cores, that takes an
    output from ``THRESHOLD_ROWS`` complex64 rows on; shut down after."""
    monkeypatch.setattr(tiq, "_pool", None)
    monkeypatch.setattr(tiq, "TO_COMPLEX_MAX_WORKERS", WORKERS)
    monkeypatch.setattr(tiq, "TO_COMPLEX_PARALLEL_MIN_BYTES",
                        THRESHOLD_ROWS * 8)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    yield
    if tiq._pool is not None and tiq._pool[0] is not None:
        tiq._pool[0].shutdown()


def _payload(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":     # a .mat's doubles, some not whole
        return (rng.integers(-2048, 2048, size=(n, 2))
                + rng.choice([0, 0.5, 1e-3], size=(n, 2))).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=(n, 2), endpoint=True,
                        dtype=np.dtype(dtype).newbyteorder("=")).astype(dtype)


def _source(layout, pairs, tmp_path):
    if layout == "contiguous":
        return pairs
    if layout == "strided":
        doubled = np.repeat(pairs, 2, axis=0)
        doubled[1::2] = 0
        return doubled[::2]
    if layout == "fortran":
        return np.asfortranarray(pairs)
    # a map of a file, a row in: an offset view, as ``read_iq`` gives
    path = tmp_path / "payload.bin"
    m = np.memmap(path, dtype=pairs.dtype, mode="w+",
                  shape=(pairs.shape[0] + 1, 2))
    m[1:] = pairs
    m.flush()
    del m
    return np.memmap(path, dtype=pairs.dtype, mode="r",
                     shape=(pairs.shape[0] + 1, 2))[1:]


# (payload type, bit width): the .iq storage classes, big-endian int16 as
# such files give it, int32 with values beyond 2^24, and a .mat's doubles
PAYLOADS = [("i1", 8), ("<i2", 12), ("<i2", 16), (">i2", 12), ("<i4", 16),
            ("<f8", 12)]
ROWS = [0, 1, THRESHOLD_ROWS - 1, THRESHOLD_ROWS, THRESHOLD_ROWS + 1]


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("layout", ["contiguous", "strided", "fortran",
                                    "memmap"])
@pytest.mark.parametrize("out_dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("payload,bit_width", PAYLOADS)
def test_to_complex_is_bit_for_bit_the_jax_package(
        small_pool, tmp_path, payload, bit_width, out_dtype, layout, n):
    pairs = _payload(payload, n, seed=n + bit_width)
    src = _source(layout, pairs, tmp_path)
    got = tiq.to_complex(src, bit_width, dtype=out_dtype)
    want = jiq.to_complex(pairs, bit_width, dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (n,)
    bits = np.uint32 if out_dtype == np.complex64 else np.uint64
    np.testing.assert_array_equal(got.view(bits), want.view(bits))


def _counted(samples, **kw) -> dict:
    profiling.enable()
    try:
        tiq.to_complex(samples, 12, **kw)
        return profiling.snapshot()["counters"]
    finally:
        profiling.disable()


def test_counters_of_the_pool_and_of_the_callers_thread(small_pool):
    large = _payload("<i2", THRESHOLD_ROWS + 1, seed=1)
    nbytes = (THRESHOLD_ROWS + 1) * 8
    assert _counted(large) == {"ingest.to_complex_bytes": nbytes,
                               "ingest.to_complex_parallel_bytes": nbytes}
    small = _payload("<i2", THRESHOLD_ROWS - 1, seed=2)
    assert _counted(small) == {
        "ingest.to_complex_bytes": (THRESHOLD_ROWS - 1) * 8}
    # more columns than I and Q: the two strided passes over the first
    # two, on the caller's thread, whatever the size
    wide = np.concatenate([large, large[:, :1]], axis=1)
    assert _counted(wide) == {"ingest.to_complex_bytes": nbytes}
    np.testing.assert_array_equal(
        tiq.to_complex(wide, 12).view(np.uint32),
        jiq.to_complex(wide, 12).view(np.uint32))


def test_the_recorder_off_counts_nothing(small_pool):
    before = profiling.snapshot()["counters"]
    tiq.to_complex(_payload("<i2", THRESHOLD_ROWS, seed=3), 12)
    assert profiling.snapshot()["counters"] == before


# the child runs numpy and the pool alone, none of the threads it left behind
@pytest.mark.filterwarnings("ignore:This process .* is multi-threaded")
def test_a_forked_child_makes_its_own_pool(small_pool):
    tiq.to_complex(_payload("<i2", THRESHOLD_ROWS, seed=4), 12)
    parent_pool = tiq._pool
    assert parent_pool is not None and parent_pool[1] == WORKERS
    pid = os.fork()
    if pid == 0:       # the child: no pool until its first large call
        ok = tiq._pool is None
        x = _payload("<i2", THRESHOLD_ROWS, seed=4)
        ok = ok and np.array_equal(tiq.to_complex(x, 12),
                                   jiq.to_complex(x, 12))
        ok = ok and tiq._pool is not None and tiq._pool is not parent_pool
        os._exit(0 if ok else 1)
    deadline = time.monotonic() + 30
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    if not done:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
    assert done and os.waitstatus_to_exitcode(status) == 0
    assert tiq._pool is parent_pool
