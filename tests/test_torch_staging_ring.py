"""The staged steps' copy-in through page-locked memory
(``_staging._pinned_copy``), which a host source of ``PINNED_MIN_BYTES``
or more takes to a graph's input buffer.

On the CPU: the copy through a stand-in page-locked tensor (every byte
lands, in row order, from any layout into any layout; one stage a copy,
of the source's shape and dtype, written before the DMA is queued), the
routing by size in ``Staged._copy_in`` (a view of a file's map the same
as memory), and a CPU staged step that makes no page-locked memory.  On
the card (the ``card`` marker; skipped without one): the graph's input
equals the source bit for bit (a dense dwell, a ragged length, a
non-contiguous source, a read-only map of an ``.iq`` file and a complex64
wideband capture), back-to-back payloads give each its own PDWs, equal
to the eager step's, the caller's array may be rewritten as soon as a
call returns, and the counters.  This file imports no JAX, so that the
card can run it:

    python -m pytest tests/test_torch_staging_ring.py -q -p no:cacheprovider \\
        -o addopts="" --noconftest -m card
"""

import os

import numpy as np
import pytest
import torch

from sdr_channelizer_tpu_torch import _staging
from sdr_channelizer_tpu_torch._staging import PINNED_MIN_BYTES, Staged
from sdr_channelizer_tpu_torch.utils import profiling


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the copy on the card")
    return torch.device("cuda", 0)


# ------------------------------------------- the copy on the host

class _Stages:
    """Stand-in page-locked tensors in plain host memory: each is kept,
    and the destination's ``copy_`` is watched, so that a test sees that
    the stage held the source's bytes when the DMA was queued."""

    def __init__(self, monkeypatch):
        self.made = []
        monkeypatch.setattr(_staging, "_pinned", self.pinned)

    def pinned(self, shape, dtype):
        stage = torch.full(shape, 7, dtype=dtype)
        self.made.append(stage)
        return stage


class _Dst(torch.Tensor):
    """A destination that checks, at its ``copy_``, that the copy is
    queued without a wait and that its source is the stage."""

    stages = None
    queued = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.copy_:
            assert kwargs.get("non_blocking") is True
            assert args[1] is cls.stages.made[-1]
            cls.queued += 1
        return super().__torch_function__(func, types, args, kwargs)


COPY_CASES = {
    "int8_ragged": (np.int8, (7 * 4099 + 37,)),
    "int16_packed_pairs": (np.int16, (7 * 1031 + 5, 2)),
    "int32_packed_plane": (np.int32, (56 * 64,)),
    "complex64_ragged": (np.complex64, (7 * 523 + 3,)),
    "float32_matrix": (np.float32, (31, 17)),
    "uint8_one_byte": (np.uint8, (1,)),
    "one_element_pair": (np.int16, (1, 2)),
}


@pytest.mark.parametrize("case", sorted(COPY_CASES))
def test_the_pinned_copy_lands_every_byte_through_one_stage(case,
                                                            monkeypatch):
    dtype, shape = COPY_CASES[case]
    g = np.random.default_rng(sum(map(ord, case)))
    raw = g.integers(0, 256, int(np.prod(shape)) * np.dtype(dtype).itemsize,
                     dtype=np.uint8)
    src = raw.view(dtype).reshape(shape)
    stages = _Stages(monkeypatch)
    _Dst.stages, _Dst.queued = stages, 0
    dst = torch.zeros(shape, dtype=_staging._torch_dtype(src)).as_subclass(
        _Dst)
    _staging._pinned_copy(dst, torch.from_numpy(src))
    (stage,) = stages.made
    assert stage.shape == dst.shape and stage.dtype == dst.dtype
    assert _Dst.queued == 1
    np.testing.assert_array_equal(
        dst.as_subclass(torch.Tensor).numpy().view(np.uint8),
        src.view(np.uint8))
    np.testing.assert_array_equal(stage.numpy().view(np.uint8),
                                  src.view(np.uint8))


LAYOUTS = {"transposed_source": (True, False),
           "transposed_destination": (False, True),
           "both_transposed": (True, True)}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_the_pinned_copy_keeps_row_order_in_any_layout(case, monkeypatch):
    src_t, dst_t = LAYOUTS[case]
    src = torch.arange(40 * 30, dtype=torch.int16).reshape(40, 30)
    src = src.T if src_t else src.T.contiguous()
    dst = torch.zeros(40, 30, dtype=torch.int16).T if dst_t \
        else torch.zeros(30, 40, dtype=torch.int16)
    assert src.is_contiguous() != src_t and dst.is_contiguous() != dst_t
    stages = _Stages(monkeypatch)
    _staging._pinned_copy(dst, src)
    assert torch.equal(dst, src) and torch.equal(stages.made[0], src)


# --------------------------------------------------------- the routing

class _Spy:
    def __init__(self, monkeypatch):
        self.copied = []
        monkeypatch.setattr(_staging, "_pinned_copy", self.copy)

    def copy(self, dst, src):
        self.copied.append(src.nbytes)
        dst.copy_(src)


def test_copy_in_routes_by_size_and_layout(monkeypatch):
    spy = _Spy(monkeypatch)
    small = np.arange(PINNED_MIN_BYTES // 2 - 1, dtype=np.int16)
    large = np.arange(PINNED_MIN_BYTES // 4, dtype=np.int32)
    tensor = torch.arange(PINNED_MIN_BYTES // 8 + 1, dtype=torch.float64)
    permuted = torch.zeros(PINNED_MIN_BYTES // 4, 2, dtype=torch.int16).T
    args = [small, None, large, tensor, permuted]
    buffers = [torch.empty(small.shape, dtype=torch.int16), None,
               torch.empty(large.shape, dtype=torch.int32),
               torch.empty_like(tensor), torch.empty_like(permuted)]
    assert not buffers[-1].is_contiguous()
    host, pinned = Staged._copy_in(buffers, args)
    assert spy.copied == [large.nbytes, tensor.nbytes, permuted.nbytes]
    assert pinned == large.nbytes + tensor.nbytes + permuted.nbytes
    assert host == pinned + small.nbytes
    for buf, x in zip(buffers, args):
        if x is not None:
            assert torch.equal(buf, torch.as_tensor(x))


EDGES = {"a_byte_under": -1, "exactly": 0, "a_byte_over": 1}


@pytest.mark.parametrize("case", sorted(EDGES))
@pytest.mark.parametrize("kind", ["ndarray", "host_tensor"])
def test_the_threshold_is_the_sources_byte_size(case, kind, monkeypatch):
    spy = _Spy(monkeypatch)
    n = PINNED_MIN_BYTES + EDGES[case]
    x = np.arange(n, dtype=np.uint8)
    if kind == "host_tensor":
        x = torch.from_numpy(x)
    buf = torch.empty(n, dtype=torch.uint8)
    host, pinned = Staged._copy_in([buf], [x])
    assert host == n and pinned == (n if n >= PINNED_MIN_BYTES else 0)
    assert spy.copied == ([n] if pinned else [])
    assert torch.equal(buf, torch.as_tensor(x))


def test_a_view_of_a_files_map_goes_through_page_locked_memory(
        monkeypatch, tmp_path):
    spy = _Spy(monkeypatch)
    path = str(tmp_path / "payload.bin")
    n = PINNED_MIN_BYTES // 4 + 3
    np.arange(n, dtype=np.int32).tofile(path)
    mapped = np.memmap(path, dtype=np.int32, mode="r")
    views = [mapped, np.asarray(mapped[3:]),
             np.asarray(mapped).view(np.int16)[6:].view(np.int32),
             np.fromfile(path, dtype=np.int32)[3:]]
    for x in views:
        buf = torch.empty(x.shape, dtype=torch.int32)
        host, pinned = Staged._copy_in([buf], [x])
        assert host == pinned == x.nbytes
        assert torch.equal(buf, torch.from_numpy(np.array(x)))
    assert spy.copied == [x.nbytes for x in views]


def test_the_cpu_path_makes_no_page_locked_memory(monkeypatch):
    def refuse(shape, dtype):
        raise AssertionError("page-locked memory asked for on the CPU path")

    monkeypatch.setattr(_staging, "_pinned", refuse)
    x = np.arange(PINNED_MIN_BYTES // 2, dtype=np.int16).reshape(-1, 2)
    step = Staged(lambda t: t[:, 0].sum(), "cpu")
    for _ in range(2):
        assert int(step(x)) == int(x[:, 0].sum())
    assert (step.hits, step.misses) == (0, 0)


# ---------------------------------------------------------- on the card

def _payload(kind: str, tmp_path, seed: int) -> np.ndarray:
    g = np.random.default_rng(seed)
    if kind == "dense_dwell":          # the packed plane of 262,144 frames
        return g.integers(-2048, 2048, (56 * 262144, 2),
                          dtype=np.int16).view(np.int32).ravel()
    if kind == "ragged_int8":
        return g.integers(-128, 128, PINNED_MIN_BYTES + 12345,
                          dtype=np.int8)
    if kind == "non_contiguous":
        return g.integers(-2048, 2048, (2 * 56 * 65536, 2),
                          dtype=np.int16)[::2]
    if kind == "mapped_iq_block":
        from sdr_channelizer_tpu_torch.io.iqpacket import (
            IqHeader,
            read_iq,
            write_iq,
        )

        path = os.path.join(tmp_path, f"block{seed}.iq")
        write_iq(path, IqHeader(0.0, 56e6, 56e6, 0.0, 0, 12, 0.0),
                 g.integers(-2048, 2048, (56 * 65536 + 11, 2),
                            dtype=np.int16))
        _, raw = read_iq(path, mmap=True)
        assert not raw.flags.writeable
        return raw[11:].view(np.int32).ravel()
    if kind == "wideband_complex64":
        n = 16_000_000
        return (g.standard_normal(n, np.float32)
                + 1j * g.standard_normal(n, np.float32)).astype(np.complex64)
    raise ValueError(kind)


PAYLOADS = ["dense_dwell", "ragged_int8", "non_contiguous", "mapped_iq_block",
            "wideband_complex64"]


@pytest.mark.card
@pytest.mark.parametrize("kind", PAYLOADS)
def test_the_graph_input_is_the_source_bit_for_bit(card, kind, tmp_path):
    first, second = (_payload(kind, tmp_path, s) for s in (1, 2))
    assert first.nbytes >= PINNED_MIN_BYTES
    step = Staged(lambda x: x.reshape(-1)[-1024:] + 0, card)
    for x in (first, second, first):      # a capture, then two hits
        step(x)
        torch.cuda.synchronize(card)
        buf = step._graphs[step.key(x)].inputs[0]
        np.testing.assert_array_equal(
            buf.cpu().numpy().view(np.uint8),
            np.ascontiguousarray(x).view(np.uint8))
    assert (step.hits, step.misses) == (2, 1)


def _dwell(seed: int, m: int = 56, frames: int = 262144) -> np.ndarray:
    g = np.random.default_rng(seed)
    t = np.arange(m * frames)
    iq = 1e-3 * (g.standard_normal(t.size) + 1j * g.standard_normal(t.size))
    on = ((t + 997 * seed) // 7000) % 3 == 0
    iq += 0.5 * np.exp(2j * np.pi * (0.11 + 0.02 * seed) * t) * on
    return np.round(np.stack([iq.real, iq.imag], -1) * 2047).astype(np.int16)


def _eager_pdws(pipe, raw: np.ndarray) -> dict:
    xq = torch.from_numpy(raw.view(np.int32).ravel()).to(pipe.device)
    _, _, batch = pipe.forward_packed(xq, bit_width=12)
    return pipe._finalize(batch, 56e6, 0.0, 0.0)


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.card
def test_back_to_back_payloads_give_each_its_own_pdws(card):
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    pipe = ChannelizerPipeline.create(56, device=card)
    raws = [_dwell(1), _dwell(2)]
    eager = [_eager_pdws(pipe, raw) for raw in raws]
    assert len(eager[0]["toa"]) > 0 and len(eager[1]["toa"]) > 0
    assert not np.array_equal(eager[0]["toa"], eager[1]["toa"])
    for _ in range(2):                    # the capture's round, then hits
        staged = [pipe.extract_fused(raw, bit_width=12, fs=56e6)
                  for raw in raws]
        for got, want in zip(staged, eager):
            _assert_same(got, want)


@pytest.mark.card
def test_the_callers_array_may_be_rewritten_once_a_call_returns(card):
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    first, second = _dwell(3), _dwell(4)
    step = Staged(lambda x: x.reshape(-1)[-4096:] + 0, card)
    xq = first.view(np.int32).ravel()
    step(xq.copy())                       # the capture
    want = torch.from_numpy(xq[-4096:].copy())
    for _ in range(3):
        src = xq.copy()
        out = step(src)                   # its DMA queued
        src[:] = 0
        assert torch.equal(out.cpu(), want)

    pipe = ChannelizerPipeline.create(56, device=card)
    want = _eager_pdws(pipe, first)
    pipe.extract_fused(first.copy(), bit_width=12, fs=56e6)
    src = first.copy()
    got = pipe.extract_fused(src, bit_width=12, fs=56e6)
    src[:] = second
    _assert_same(got, want)
    _assert_same(pipe.extract_fused(src, bit_width=12, fs=56e6),
                 _eager_pdws(pipe, second))


@pytest.mark.card
def test_the_ring_counter_reads_the_dense_dwell_and_not_a_small_array(
        card, tmp_path):
    step = Staged(lambda x: x.reshape(-1)[:8] + 0, card)
    dense = _payload("dense_dwell", None, 5)
    small = dense[:PINNED_MIN_BYTES // 4 - 1].copy()
    mapped = _payload("mapped_iq_block", tmp_path, 6)
    for x in (dense, small, mapped):
        step(x)                           # the captures
        profiling.enable()
        try:
            step(x)
        finally:
            profiling.disable()
        counters = profiling.snapshot()["counters"]
        assert counters["staged.copy_in_bytes"] == x.nbytes
        assert counters.get("staged.copy_in_ring_bytes", 0) == (
            0 if x is small else x.nbytes)
