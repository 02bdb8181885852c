"""Kernels K4 and B10: per-pulse median magnitude, median phase
difference and, with a saturation mask, the saturated flag.

The counterparts of ``pulse_stats`` (a slot grid, row = channel) and
``pulse_stats_dense`` (a flat slot list with a channel per slot) of the JAX
package.  Both launch the CUDA selection (``csrc/pulse_stats.cu``) for CUDA
tensors, or raise; for CPU tensors they take ``pulse_stats_plain`` /
``pulse_stats_dense_plain``, a gather of the windows and a sort.

The selection is sized to each pulse: a run of up to ``SHORT_KEYS``
samples is sorted by a warp (up to four short runs at once) with its keys
in registers, a longer one is selected by a block of the select kernel,
from shared memory where the run fits ``BLOCK_KEYS`` keys, else from two
reads of the run.  Dead slots get no warp: the chunk kernel writes them 0
while it sorts the live ones by length, on the device, with no host sync.
Any window is taken.

``batch_tiles`` chooses the kernel as the JAX package does
(:func:`batched_tiles`): where it gives more than one tile of 128 slots a
batch, B10 runs over the list of live tiles compacted on the device
(:func:`_live_tiles`), its blocks on the live tiles only, else K4 with its
blocks on every chunk of slots.  The two give the same bits, and the plain
versions take ``batch_tiles`` and ignore it.

All give, for a dead slot (``toa`` outside ``[0, t_len)``), 0 in every
output, and NaN for a live slot whose range is empty (the phase
difference of a one-sample pulse); callers mask by slot validity.  The
saturated flag is 1.0 where a sample strictly inside the pulse, ``toa + 1
.. toa + plen - 2`` cut at ``t_len``, is saturated, else 0.0; the cm2 route
passes no mask and takes saturation from its cumulative count.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sdr_channelizer_tpu_torch.ops.cuda import _build
from sdr_channelizer_tpu_torch.ops.medians import masked_median

launches = 0                # times pulse_stats launched K4
launches_dense = 0          # times pulse_stats_dense launched K4
launches_batched = 0        # times pulse_stats launched B10
launches_dense_batched = 0  # times pulse_stats_dense launched B10
# launches of either kernel whose window exceeds a block's stretch of shared
# memory (its pulses longer than the stretch are read twice)
launches_long_window = 0

TILE = 128          # slots a tile, as the JAX kernel's
SHORT_KEYS = 128    # runs up to this long: a warp, keys in registers
BLOCK_KEYS = 8192   # a select block's stretch of shared memory, in keys
# the select kernel's persistent grid: blocks a multiprocessor, as many as
# stay resident (512 threads, 40 registers and 48 KB of shared memory each)
SELECT_BLOCKS_PER_SM = 3
_sm_count = {}


def batched_tiles(batch_tiles: int, window: int, n_slots: int) -> int:
    """Tiles a batch of the batched kernel (``_pulse_stats_flat`` of the JAX
    package): ``batch_tiles`` (0 means 1), at most ``48 // rows`` with
    ``rows = ceil(window / 128) + 1``, at most the slot list's tiles.  B10
    runs where this is above 1, K4 elsewhere."""
    rows = (window + TILE - 1) // TILE + 1
    n_tiles = max(1, (n_slots + TILE - 1) // TILE)
    return min(max(batch_tiles, 1), max(1, 48 // rows), n_tiles)


def _check_streams(mag_cm, dph_cm, sat_cm, window, t_len):
    for name, x in (("mag_cm", mag_cm), ("dph_cm", dph_cm),
                    ("sat_cm", sat_cm)):
        if x is None and name == "sat_cm":
            continue
        if x.dtype != torch.float32 or x.ndim != 2:
            raise TypeError(f"{name} must be a 2-D float32 tensor (M, T)")
        if x.shape != mag_cm.shape:
            raise ValueError("the streams must have one shape")
    if window < 1:
        raise ValueError("window must be >= 1")
    t_len = mag_cm.shape[1] if t_len is None else t_len
    if not 0 <= t_len <= mag_cm.shape[1]:
        raise ValueError(f"t_len={t_len} outside [0, {mag_cm.shape[1]}]")
    return t_len


def _check_args(mag_cm, dph_cm, toa, te, window, t_len, sat_cm=None):
    t_len = _check_streams(mag_cm, dph_cm, sat_cm, window, t_len)
    for name, x in (("toa", toa), ("te", te)):
        if x.dtype != torch.int32 or x.ndim != 2:
            raise TypeError(f"{name} must be a 2-D int32 tensor (M, P_slots)")
    if toa.shape != te.shape or toa.shape[0] > mag_cm.shape[0]:
        raise ValueError("toa and te must share a shape (M, P_slots) with "
                         "M <= the streams' rows")
    return t_len


def _check_args_dense(mag_cm, dph_cm, sat_cm, toa, te, chan, window, t_len):
    t_len = _check_streams(mag_cm, dph_cm, sat_cm, window, t_len)
    for name, x in (("toa", toa), ("te", te), ("chan", chan)):
        if x.dtype != torch.int32 or x.ndim != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor (P,)")
    if not toa.shape == te.shape == chan.shape:
        raise ValueError("toa, te and chan must share a shape (P,)")
    return t_len


def _stats_plain(mag_cm, dph_cm, sat_cm, toa, te, rows, window, t_len):
    """Medians (and the flag) of flat slots: ``rows`` is each slot's row of
    the streams.  Slots are gathered as (P, window) windows, the window cut
    at the longest live pulse (a bound on memory, not on the values)."""
    toa_l, te_l = toa.to(torch.int64), te.to(torch.int64)
    live = (toa_l >= 0) & (toa_l < t_len)
    plen = torch.clamp(te_l - toa_l + 1, max=window)
    if live.any():
        window = max(1, min(window, int(plen[live].max())))
    pos = torch.arange(window, device=toa.device)
    idx = toa_l[:, None] + pos                        # (P, window)
    in_any = live[:, None] & (idx < t_len)
    m_mask = in_any & (pos < plen[:, None])
    d_mask = in_any & (pos < plen[:, None] - 1)
    t_arr = mag_cm.shape[1]
    flat = rows.to(torch.int64)[:, None] * t_arr + idx.clamp(0, max(t_arr - 1, 0))

    def win(stream):
        return stream.reshape(-1)[flat]

    def med(stream, mask):
        out = masked_median(win(stream), mask, dim=-1)
        return torch.where(live, out, torch.zeros_like(out))

    outs = (med(mag_cm, m_mask), med(dph_cm, d_mask))
    if sat_cm is None:
        return outs
    hit = ((win(sat_cm) > 0.5) & d_mask & (pos >= 1)).any(-1)
    return outs + (hit.to(torch.float32),)


def pulse_stats_plain(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    toa: torch.Tensor,
    te: torch.Tensor,
    window: int,
    t_len: Optional[int] = None,
    sat_cm: Optional[torch.Tensor] = None,
    batch_tiles: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`pulse_stats` (``batch_tiles`` changes
    no value)."""
    t_len = _check_args(mag_cm, dph_cm, toa, te, window, t_len, sat_cm)
    m, p_slots = toa.shape
    rows = torch.arange(m, device=toa.device).repeat_interleave(p_slots)
    outs = _stats_plain(mag_cm, dph_cm, sat_cm, toa.reshape(-1),
                        te.reshape(-1), rows, window, t_len)
    return tuple(o.reshape(m, p_slots) for o in outs)


def pulse_stats_dense_plain(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    sat_cm: Optional[torch.Tensor],
    toa: torch.Tensor,
    te: torch.Tensor,
    chan: torch.Tensor,
    window: int,
    t_len: Optional[int] = None,
    batch_tiles: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`pulse_stats_dense` (``batch_tiles``
    changes no value)."""
    t_len = _check_args_dense(mag_cm, dph_cm, sat_cm, toa, te, chan, window,
                              t_len)
    return _stats_plain(mag_cm, dph_cm, sat_cm, toa, te, chan, window, t_len)


def _library():
    import ctypes

    lib = _build.load("pulse_stats")
    if not getattr(lib, "_sdr_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sdr_pulse_stats.argtypes = ([vp] * 9 + [cll, ci, ci, ci, ci]
                                        + [vp, vp, cll, ci, vp, vp])
        lib.sdr_pulse_stats.restype = ci
        lib.sdr_live_tiles.argtypes = [vp, ci, ci, ci, vp, vp, vp]
        lib.sdr_live_tiles.restype = ci
        lib._sdr_typed = True
    return lib


def _live_tiles(toa: torch.Tensor, t_len: int, nt: int):
    """B10's list of live tiles, on the device: ``(tile_ids, n_live,
    n_batches)``, the live tile indices in order, -1 past them (``n_batches
    * nt + 1`` places), and the live count as a one-element tensor; no host
    sync.  The list is padded to ``n_batches`` batches of ``nt`` tiles, as
    the JAX package batches them; on the card a block of B10 takes a
    quarter of one entry's tile.  A CUDA ``toa`` gets the list from the
    kernel that B10's launch runs first (``sdr_live_tiles``, one block), a
    CPU one from its plain version, a cumsum rank and a scatter."""
    n_slots = toa.numel()
    n_tiles = (n_slots + TILE - 1) // TILE
    n_batches = (n_tiles + nt - 1) // nt
    if toa.is_cuda:
        out = torch.empty(n_batches * nt + 2, dtype=torch.int32,
                          device=toa.device)
        if n_slots:
            with torch.cuda.device(toa.device):
                code = _library().sdr_live_tiles(
                    toa.data_ptr(), n_slots, t_len, n_batches * nt + 1,
                    out.data_ptr(), out[-1:].data_ptr(),
                    torch.cuda.current_stream(toa.device).cuda_stream)
            _build.check_launch(code, "sdr_live_tiles")
        else:
            out.fill_(-1)[-1] = 0
        return out[:-1], out[-1:], n_batches
    live = (toa >= 0) & (toa < t_len)
    if n_tiles * TILE != n_slots:
        live = torch.cat([live, live.new_zeros(n_tiles * TILE - n_slots)])
    live = live.view(n_tiles, TILE).any(dim=1)
    rank = torch.cumsum(live.to(torch.int32), 0) - 1
    dst = torch.where(live, rank, n_batches * nt).to(torch.int64)
    tile_ids = torch.full((n_batches * nt + 1,), -1, dtype=torch.int32,
                          device=toa.device)
    tile_ids.scatter_(0, dst, torch.arange(n_tiles, dtype=torch.int32,
                                           device=toa.device))
    return tile_ids, live.sum(dtype=torch.int32).reshape(1), n_batches


def _select_grid(dev: torch.device, window: int, t_len: int, n_slots: int):
    """The select kernel's persistent grid and each block's scratch in
    keys: ``SELECT_BLOCKS_PER_SM`` blocks a multiprocessor; one where a run
    can outgrow the block's stretch (``window > BLOCK_KEYS``), each then
    with scratch for a whole run.  Never more blocks than two tasks a
    slot."""
    sms = _sm_count.get(dev.index)
    if sms is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _sm_count[dev.index] = sms
    if window > BLOCK_KEYS:
        return min(2 * n_slots, sms), min(window, t_len)
    return min(2 * n_slots, SELECT_BLOCKS_PER_SM * sms), 0


def _launch(mag_cm, dph_cm, sat_cm, toa, te, chan, p_slots, window, t_len,
            batch_tiles):
    """Checks shared by both wrappers, then K4 or B10 over ``toa.numel()``
    slots; outputs in the shape of ``toa``."""
    global launches, launches_dense, launches_batched
    global launches_dense_batched, launches_long_window
    streams = [x for x in (mag_cm, dph_cm, sat_cm) if x is not None]
    indices = [x for x in (toa, te, chan) if x is not None]
    if len({x.device for x in streams + indices}) != 1 or not mag_cm.is_cuda:
        raise ValueError("all tensors must lie on one CUDA device")
    if mag_cm.stride(1) != 1 or any(x.stride() != mag_cm.stride()
                                    for x in streams):
        raise ValueError("streams must be contiguous along time, one stride")
    if not all(x.is_contiguous() for x in indices):
        raise ValueError("toa, te and chan must be contiguous")
    dev = mag_cm.device
    n_slots = toa.numel()
    n_out = 2 if sat_cm is None else 3
    nt = batched_tiles(batch_tiles, window, n_slots)
    # one allocation: the outputs end to end, then (int32) B10's list of
    # live tiles, the count and list of the runs longer than SHORT_KEYS and
    # the select blocks' scratch
    n_list = (n_slots + TILE - 1) // TILE + 1 if nt > 1 else 0
    n_big = n_slots + 1 if window > SHORT_KEYS else 0
    blocks, stride = (_select_grid(dev, window, t_len, n_slots) if n_big
                      else (0, 0))
    buf = torch.empty(n_out * n_slots + n_list + n_big + blocks * stride,
                      dtype=torch.float32, device=dev)
    outs = buf[:n_out * n_slots].view((n_out,) + tuple(toa.shape)).unbind(0)
    if n_slots == 0:
        return outs
    base = buf.data_ptr()
    tiles = base + 4 * n_out * n_slots
    big = tiles + 4 * n_list
    args = (mag_cm.data_ptr(), dph_cm.data_ptr(),
            None if sat_cm is None else sat_cm.data_ptr(), toa.data_ptr(),
            te.data_ptr(), None if chan is None else chan.data_ptr(),
            base, base + 4 * n_slots,
            None if sat_cm is None else base + 8 * n_slots, mag_cm.stride(0),
            n_slots, p_slots, window, t_len, big if n_big else None,
            big + 4 * n_big if stride else None, stride, blocks,
            tiles if n_list else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        code = _library().sdr_pulse_stats(*args)
    else:
        with torch.cuda.device(dev):
            code = _library().sdr_pulse_stats(*args)
    _build.check_launch(code, "sdr_pulse_stats")
    if nt > 1 and chan is None:
        launches_batched += 1
    elif nt > 1:
        launches_dense_batched += 1
    elif chan is None:
        launches += 1
    else:
        launches_dense += 1
    if window > BLOCK_KEYS:
        launches_long_window += 1
    return outs


def pulse_stats(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    toa: torch.Tensor,
    te: torch.Tensor,
    window: int,
    t_len: Optional[int] = None,
    sat_cm: Optional[torch.Tensor] = None,
    batch_tiles: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Per-slot ``(median magnitude, median phase difference)``, (M, P_slots),
    and with ``sat_cm`` a third tensor, the saturated flag.

    ``mag_cm`` / ``dph_cm``: (rows >= M, T) channel-major streams; ``toa`` /
    ``te``: (M, P_slots) int32 leading and trailing edge indices, row ``c``
    belonging to channel ``c``.  With ``plen = min(te - toa + 1, window)``
    the magnitude median runs over samples ``toa .. toa + plen - 1`` (the
    trailing edge included) and the phase-difference median over ``toa ..
    toa + plen - 2``, both cut at ``t_len`` (default T).  ``sat_cm``: the
    (rows, T) 0/1 saturation mask; the flag is 1.0 where a sample of ``toa +
    1 .. toa + plen - 2`` (cut at ``t_len``) is saturated.  Any ``window``
    is accepted.  ``batch_tiles``: see the module docstring; the slot grid
    is tiled in row-major order.
    """
    t_len = _check_args(mag_cm, dph_cm, toa, te, window, t_len, sat_cm)
    tensors = [x for x in (mag_cm, dph_cm, sat_cm, toa, te) if x is not None]
    if not any(x.is_cuda for x in tensors):
        return pulse_stats_plain(mag_cm, dph_cm, toa, te, window, t_len,
                                 sat_cm)
    return _launch(mag_cm, dph_cm, sat_cm, toa, te, None, toa.shape[1],
                   window, t_len, batch_tiles)


def pulse_stats_dense(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    sat_cm: Optional[torch.Tensor],
    toa: torch.Tensor,
    te: torch.Tensor,
    chan: torch.Tensor,
    window: int,
    t_len: Optional[int] = None,
    batch_tiles: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """The statistics of :func:`pulse_stats` over one flat slot list that
    mixes channels: ``toa``, ``te``, ``chan`` are (P,) int32, ``chan`` the
    row of the streams each slot reads; outputs are (P,).  ``sat_cm`` may be
    ``None`` (then two outputs)."""
    t_len = _check_args_dense(mag_cm, dph_cm, sat_cm, toa, te, chan, window,
                              t_len)
    tensors = [x for x in (mag_cm, dph_cm, sat_cm, toa, te, chan)
               if x is not None]
    if not any(x.is_cuda for x in tensors):
        return pulse_stats_dense_plain(mag_cm, dph_cm, sat_cm, toa, te, chan,
                                       window, t_len)
    return _launch(mag_cm, dph_cm, sat_cm, toa, te, chan, 0, window, t_len,
                   batch_tiles)
