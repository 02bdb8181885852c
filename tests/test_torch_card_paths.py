"""The port's single-shot paths on the card at M = 64 x 262144 frames, on
the sparse and dense captures: the main path through ``extract_fused``
(its kernels launched, the PDWs against the plain versions and, on the
sparse capture, against the generator), the routes ``"flat"`` and
``"cm"`` against ``"cm2"`` and against their own plain versions, a float
payload and the complex-free step, the JAX package's call forms on B9,
the batched statistics (B10) bit for bit the per-slot kernel's, and the
staged steps (CUDA graphs replayed) bit for bit their eager forms with the
graph cache's hits, misses and bound.

Marked ``card``: skipped without a CUDA card.  No JAX in this file:

    python -m pytest tests/test_torch_card_paths.py -q -p no:cacheprovider \\
        -o addopts="" --noconftest -m card
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_card_fixtures import (
    BIT_WIDTH, DENSE_COUNT_BAND, FRAMES_MAIN, FS_MAIN, M_MAIN, MAG_TOL, check,
    main_pipe, max_abs, pack, pdws_agree, pdws_identical, outputs_identical,
    read_counts, recovers_generator, reset_counts, same, step_runs)
from torch_card_fixtures import caps, card, pipe  # noqa: F401  (fixtures)

pytestmark = pytest.mark.card

ROUTE_COUNTS = {
    "noise_floor_cm": "nf_kernel.launches",
    "channelize_streams_packed": "channelizer_kernel.launches_flat",
    "cm_streams": "transpose_kernel.launches",
    "channelize_complex": "channelizer_kernel.launches_complex",
    "channelize_cm": "channelizer_kernel.launches_cm",
    "channelize_cm2": "channelizer_kernel.launches",
    "latch_cumsums": "latch_kernel.launches_tm",
    "pulse_stats_dense": "pulse_stats_kernel.launches_dense"}


def test_pipeline_leaves_tf32_off(pipe):
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")


def test_main_path(pipe, caps):
    """The main path at full width through ``extract_fused``: K1-K4
    launched, every field finite, the sparse capture's PDWs the plain
    versions' and the generator's pulses, the dense capture's count within
    DENSE_COUNT_BAND of the plain versions'."""
    from sdr_channelizer_tpu_torch.ops.cuda import (
        channelizer_kernel, latch_kernel, nf_kernel, pulse_stats_kernel)

    mods = {"channelize_streams_packed_cm2": channelizer_kernel,
            "noise_floor_cm": nf_kernel, "latch_cumsums_cm": latch_kernel,
            "pulse_stats": pulse_stats_kernel}
    n = M_MAIN * FRAMES_MAIN
    fs = M_MAIN * 1e6
    for mod in mods.values():
        mod.launches = 0
    pdws = {}
    for name, samples in caps.items():
        pdws[name] = pipe.extract_fused(samples, BIT_WIDTH, fs=fs)
        torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in mods.items()}
    for name, count in launches.items():
        check(count > 0, f"main path never launched {name}")

    for name, samples in caps.items():
        for key in ("toa", "freq", "pw", "mag", "snr"):
            vals = pdws[name][key]
            ok = np.isfinite(vals) | (np.isnan(vals) if key == "freq" else False)
            check(bool(ok.all()), f"{name}: non-finite {key}")
        check(len(pdws[name]["toa"]) > 0, f"{name}: no pulses")
        plain = pipe.extract_fused(samples, BIT_WIDTH, fs=fs, plain=True)
        if name == "sparse":
            pdws_agree(pdws[name], plain, "sparse capture, kernels vs plain")
            recovers_generator(pdws[name], n, M_MAIN)
        else:
            band = DENSE_COUNT_BAND * len(plain["toa"])
            check(abs(len(pdws[name]["toa"]) - len(plain["toa"])) <= band,
                  f"dense capture: {len(pdws[name]['toa'])} pulses vs "
                  f"{len(plain['toa'])} from the plain versions")


@pytest.mark.parametrize("name", ["sparse", "dense"])
def test_routes(pipe, caps, name):
    """The single-shot routes ``"flat"`` and ``"cm"`` against ``"cm2"`` and
    against their own plain versions: every route takes its floor with K2
    once, the same floor as cm2's; route flat launches B5, B8, B7 once and
    K4 twice, route cm B6 and B7 once and no flip; the exact keys equal to
    cm2's; the tail alone on the kernel's streams bit for bit its plain
    version; the whole route within the plain versions' bars; and K2 on
    the flip as the routes' floor, equal to a median along frames."""
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel
    from sdr_channelizer_tpu_torch.ops.medians import median

    fs = M_MAIN * 1e6
    samples = caps[name]
    xq = torch.as_tensor(pack(samples), device=pipe.device)
    pdws, floors = {}, {}
    for route in ("cm2", "flat", "cm"):
        reset_counts(ROUTE_COUNTS)
        floors[route], _, batch = pipe.forward_packed(xq, BIT_WIDTH,
                                                      route=route)
        pdws[route] = pipe._finalize(batch, fs, 0.0, 0.0)
        seen = read_counts(ROUTE_COUNTS)
        # every route takes its floor with K2, once
        check(seen["noise_floor_cm"] == 1,
              f"route {route}, {name}: launch counts {seen}")
        if route == "flat":
            check(seen["channelize_streams_packed"] == 1
                  and seen["cm_streams"] == 1
                  and seen["latch_cumsums"] == 1
                  and seen["pulse_stats_dense"] == 2,
                  f"route flat, {name}: launch counts {seen}")
        if route == "cm":
            check(seen["channelize_cm"] == 1 and seen["cm_streams"] == 0
                  and seen["latch_cumsums"] == 1,
                  f"route cm, {name}: launch counts {seen}")
        # one body gives every route the same magnitude: the same floor
        check(same(floors[route], floors["cm2"]),
              f"route {route}, {name}: the floor differs from cm2's")
    for route in ("flat", "cm"):
        if name == "sparse":
            pdws_agree(pdws[route], pdws["cm2"],
                       f"route {route} vs cm2, sparse capture")
        else:
            band = DENSE_COUNT_BAND * len(pdws["cm2"]["toa"])
            check(abs(len(pdws[route]["toa"]) - len(pdws["cm2"]["toa"]))
                  <= band, f"route {route} vs cm2, dense capture: "
                           f"{len(pdws[route]['toa'])} pulses vs "
                           f"{len(pdws['cm2']['toa'])}")
        for key in ("toa", "pw", "channel", "sat"):
            check(np.array_equal(pdws[route][key], pdws["cm2"][key]),
                  f"route {route} vs cm2, {name} capture: {key} differs")

        # the route against its plain versions on the card: the tail
        # alone on the streams the channelizer kernel gave (the latch,
        # the flip and the statistics kernels are exact, so the PDWs
        # are bit-identical), then the whole route (the channelizer's
        # plain version differs in the last place of a float32)
        front = {"flat": k.KERNELS.channelize_flat,
                 "cm": k.KERNELS.channelize_cm}[route]
        streams = front(xq, pipe.channelizer.taps_rev,
                        bit_width=BIT_WIDTH,
                        sat_level=pipe.pdw_cfg.saturation_level)
        tail = {}
        for label, ops in (("kernels", k.KERNELS), ("plain", k.PLAIN)):
            batch = pipe._fused_tail(route, lambda _: streams, ops)[2]
            tail[label] = pipe._finalize(batch, fs, 0.0, 0.0)
        del streams, batch
        where = f"route {route}, {name} capture"
        pdws_identical(tail["kernels"], pdws[route],
                       f"{where}: the tail alone vs the route")
        pdws_identical(tail["kernels"], tail["plain"],
                       f"{where}: tail kernels vs plain")
        _, _, batch = pipe.forward_packed(xq, BIT_WIDTH, route=route,
                                          plain=True)
        plain = pipe._finalize(batch, fs, 0.0, 0.0)
        del batch
        if name == "sparse":
            pdws_agree(pdws[route], plain, f"{where}: kernels vs plain")
        else:
            band = DENSE_COUNT_BAND * len(plain["toa"])
            check(abs(len(pdws[route]["toa"]) - len(plain["toa"]))
                  <= band, f"{where}: {len(pdws[route]['toa'])} pulses "
                           f"vs {len(plain['toa'])} from the plain "
                           f"versions")
    # the flat and cm routes' noise floor: K2 on the flip, where a sort
    # along the strided axis was
    mag = channelizer_kernel.channelize_streams_packed(
        xq, pipe.channelizer.taps_rev, BIT_WIDTH)[0]
    mag_cm = mag.T.contiguous()
    check(same(k.noise_floor_cm(mag_cm, FRAMES_MAIN), median(mag, dim=0)),
          f"K2 route shape, {name}: differs from median(mag, dim=0)")


def test_float_payload_and_planes(pipe, caps):
    """A float32 payload takes the planes ingest of the cm2 form and gives
    the int16 payload's PDWs; so does a complex capture through
    ``extract()``; the complex-free step (``extract_planes``: B9, stream
    math in torch, the kernel tail) launches B9 and B8 once a run and
    recovers the generator's pulses."""
    from sdr_channelizer_tpu_torch.io import iqpacket

    fs = M_MAIN * 1e6
    n = M_MAIN * FRAMES_MAIN
    samples = caps["sparse"]
    ref = pipe.extract_fused(samples, BIT_WIDTH, fs=fs)
    iq = iqpacket.to_complex(samples, BIT_WIDTH)
    as_float = np.stack([iq.real, iq.imag], -1)
    reset_counts(ROUTE_COUNTS)
    misses = pipe._staged_forward_fused.misses
    got = pipe.extract_fused(as_float, 0, fs=fs)
    check(read_counts(ROUTE_COUNTS)["channelize_cm2"]
          == step_runs(pipe._staged_forward_fused, misses),
          "float payload: the cm2 form on planes was not launched")
    pdws_agree(got, ref, "float32 payload vs int16 payload")
    pdws_identical(got, ref, "float32 payload vs int16 payload")
    pdws_identical(pipe.extract(iq, fs=fs), ref,
                   "extract() of the complex capture vs int16 payload")
    reset_counts(ROUTE_COUNTS)
    misses = pipe._staged_forward_planes.misses
    planes = pipe.extract_planes(iq, fs=fs)
    seen = read_counts(ROUTE_COUNTS)
    runs = step_runs(pipe._staged_forward_planes, misses)
    check(seen["channelize_complex"] == runs and seen["cm_streams"] == runs,
          f"extract_planes: launch counts {seen}, {runs} runs")
    check(abs(len(planes["toa"]) - len(ref["toa"]))
          <= DENSE_COUNT_BAND * len(ref["toa"]),
          f"extract_planes: {len(planes['toa'])} pulses vs {len(ref['toa'])}")
    recovers_generator(planes, n, M_MAIN)


def test_api_calls_on_b9(pipe, caps):
    """The JAX package's call forms on the card at M = 64 x 262144 frames:
    ``chan(x)`` (``method="auto"``: B9) is ``channelize(x, chan,
    method="dft")`` bit for bit in one launch; a (3, N) batch is its three
    1-D calls bit for bit, one launch a row; ``stream_block`` over four
    blocks (B9 seeded with each block's history) folds to ``chan(x)`` bit
    for bit.  ``chan(x)`` is also held against B9's plain version and the
    FFT oracle."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import channelize
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck

    b9 = {"channelize_complex": "channelizer_kernel.launches_complex"}
    chan = pipe.channelizer
    dev = pipe.device
    rows = [torch.as_tensor(iqpacket.to_complex(caps[name], BIT_WIDTH),
                            device=dev) for name in ("sparse", "dense")]
    rows.append(torch.roll(rows[0], 12345))
    x = rows[0]

    def launches_of(fn):
        reset_counts(b9)
        got = fn()
        torch.cuda.synchronize()
        return got, read_counts(b9)["channelize_complex"]

    y, calls = launches_of(lambda: chan(x))
    check(calls == 1, f"chan(x): B9 launched {calls} times, not once")
    check(tuple(y.shape) == (FRAMES_MAIN, M_MAIN)
          and y.dtype == torch.complex64, f"chan(x): shape {tuple(y.shape)}")
    check(same(y, channelize(x, chan, method="dft")),
          "chan(x) vs channelize(x, chan, method='dft'): not bit for bit")
    y_ri = torch.view_as_real(y)
    for what, ref in (("plain", ck.channelize_complex_plain(x, chan.taps_rev)),
                      ("fft", channelize(x, chan, method="fft"))):
        ref = torch.view_as_real(ref)
        check(torch.allclose(y_ri, ref, rtol=MAG_TOL, atol=MAG_TOL),
              f"chan(x) vs the {what} form: off by {max_abs(y_ri, ref):.3g}")
    del ref

    xb = torch.stack(rows)
    yb, calls = launches_of(lambda: chan(xb))
    check(calls == len(rows),
          f"chan(x) on a ({len(rows)}, N) batch: {calls} launches")
    check(tuple(yb.shape) == (len(rows), FRAMES_MAIN, M_MAIN),
          f"batch: shape {tuple(yb.shape)}")
    for i, row in enumerate(rows):
        check(same(yb[i], chan(row)), f"batch row {i} vs its 1-D call: not "
                                      f"bit for bit")
    del xb, yb

    cuts = [0, 5, 70000, 70001, FRAMES_MAIN]   # a block shorter than P
    state = chan.init_state(dev)
    parts = []
    reset_counts(b9)
    for lo, hi in zip(cuts, cuts[1:]):
        part, state = chan.stream_block(x[lo * M_MAIN:hi * M_MAIN], state)
        parts.append(part)
    torch.cuda.synchronize()
    calls = read_counts(b9)["channelize_complex"]
    check(calls == len(cuts) - 1, f"stream_block: B9 launched {calls} times")
    check(same(torch.cat(parts), y),
          "stream_block folded over four blocks vs chan(x): not bit for bit")


@pytest.mark.parametrize("name", ["sparse", "dense"])
def test_stats_batch(pipe, caps, name):
    """B10 on its paths: ``extract_fused`` (a pipeline whose staged step is
    captured with the knob set) and route ``"cm"`` with
    ``dsp.pdw._STATS_BATCH = 8``, bit for bit the PDWs of the runs with 1
    (K4), and no K4 launch."""
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk

    fs = M_MAIN * 1e6
    samples = caps[name]
    # a staged step reads the knob where it is captured (as jax.jit does
    # where it traces): the batched run has a pipeline of its own
    pipe8 = dataclasses.replace(pipe)
    batched = pipe8._staged_forward_packed
    try:
        xq = torch.as_tensor(pack(samples), device=pipe.device)
        pdwmod._STATS_BATCH = 1
        ref = pipe.extract_fused(samples, BIT_WIDTH, fs=fs)
        _, _, batch = pipe.forward_packed(xq, BIT_WIDTH, route="cm")
        ref_cm = pipe._finalize(batch, fs, 0.0, 0.0)
        pdwmod._STATS_BATCH = 8
        psk.launches_batched = psk.launches = 0
        misses = batched.misses
        got = pipe8.extract_fused(samples, BIT_WIDTH, fs=fs)
        torch.cuda.synchronize()
        n_b, n_k4 = psk.launches_batched, psk.launches
        check(n_b == 2 * step_runs(batched, misses) and n_k4 == 0,
              f"stats_batch, {name}: B10 {n_b} / K4 {n_k4} launches")
        pdws_identical(got, ref, f"stats_batch, {name}: 8 vs 1")
        psk.launches_dense_batched = psk.launches_dense = 0
        _, _, batch = pipe.forward_packed(xq, BIT_WIDTH, route="cm")
        got_cm = pipe._finalize(batch, fs, 0.0, 0.0)
        torch.cuda.synchronize()
        n_db, n_dk4 = psk.launches_dense_batched, psk.launches_dense
        check(n_db == 2 and n_dk4 == 0, f"stats_batch, route cm, {name}:"
                                        f" B10 {n_db} / K4 {n_dk4}")
        pdws_identical(got_cm, ref_cm, f"stats_batch, route cm, {name}")
    finally:
        pdwmod._STATS_BATCH = 1


def test_staged_steps(caps, card):
    """The staged steps (``_staging``: a CUDA graph a key, replayed) at the
    main path's size on a pipeline of their own: the packed step
    (``extract_fused``'s) and ``step_fused`` bit for bit their eager forms
    on the dense and sparse captures; dense, sparse, dense again, the first
    call's outputs intact; the graph cache's hits and misses (a new route,
    bit width, shape; the bound); ``step`` / ``step_planes`` (B9 and the
    oracle tail) on the sparse capture's complex samples; a staged
    function with a host sync, whose capture must raise, after which the
    card works on."""
    from sdr_channelizer_tpu_torch import _staging
    from sdr_channelizer_tpu_torch.io import iqpacket

    pipe = main_pipe()
    packed_step = pipe._staged_forward_packed
    xq = {name: torch.as_tensor(pack(s), device=pipe.device)
          for name, s in caps.items()}
    eager = {name: pipe.forward_packed(x, BIT_WIDTH) for name, x in xq.items()}

    # dense, sparse, dense again: each bit for bit the eager step, and the
    # first call's outputs still so after the later calls
    first = pipe._step_packed(xq["dense"], BIT_WIDTH)
    second = pipe._step_packed(xq["sparse"], BIT_WIDTH)
    third = pipe._step_packed(xq["dense"], BIT_WIDTH)
    outputs_identical(second, eager["sparse"], "staged packed step, sparse")
    outputs_identical(third, eager["dense"], "staged packed step, dense")
    outputs_identical(first, pipe.forward_packed(xq["dense"], BIT_WIDTH),
                      "staged packed step, the first call after two more")
    ptrs = [t.data_ptr() for t in (*first[:2], first[2].toa_idx)]
    check(not set(ptrs) & {t.data_ptr() for t in
                           (*third[:2], third[2].toa_idx)},
          "staged packed step: two calls share an output")
    pulses = {name: int(eager[name][2].count.sum()) for name in caps}
    check(pulses["dense"] == M_MAIN * pipe.pdw_cfg.max_pulses
          and int(second[2].count.sum()) == pulses["sparse"] > 0,
          f"staged packed step: pulses {pulses}")
    for name, samples in caps.items():   # the host payload, copied once
        pdws_identical(pipe.extract_fused(samples, BIT_WIDTH, fs=FS_MAIN),
                       pipe._finalize(eager[name][2], FS_MAIN, 0.0, 0.0),
                       f"extract_fused {name}: staged vs eager")
    cache = {"after_dense_sparse_dense": (packed_step.hits,
                                          packed_step.misses)}
    check(cache["after_dense_sparse_dense"] == (4, 1),
          f"staged packed step: hits, misses {cache}")

    # step_fused on the captures' float planes (its cm2 route) and the
    # staged forward_fused on routes cm and flat (jax.jit's route=)
    planes = {}
    for name, samples in caps.items():
        iq = iqpacket.to_complex(samples, BIT_WIDTH)
        planes[name] = tuple(torch.as_tensor(
            np.ascontiguousarray(v, np.float32), device=pipe.device)
            for v in (iq.real, iq.imag))
        outputs_identical(pipe.step_fused(*planes[name]),
                          pipe.forward_fused(*planes[name]),
                          f"step_fused {name}: staged vs eager")
    for route in ("cm", "flat"):
        outputs_identical(
            pipe._staged_forward_fused(*planes["dense"], bit_width=0,
                                       route=route),
            pipe.forward_fused(*planes["dense"], route=route),
            f"staged forward_fused route {route}: vs eager")
        outputs_identical(pipe._step_packed(xq["dense"], BIT_WIDTH, route),
                          pipe.forward_packed(xq["dense"], BIT_WIDTH, route),
                          f"staged packed step route {route}: vs eager")
    cache["after_routes"] = (packed_step.hits, packed_step.misses)
    outputs_identical(pipe._step_packed(xq["dense"], BIT_WIDTH - 1),
                      pipe.forward_packed(xq["dense"], BIT_WIDTH - 1),
                      "staged packed step, bit width 11: vs eager")
    cache["after_bit_width_11"] = (packed_step.hits, packed_step.misses)
    half = xq["dense"][: xq["dense"].numel() // 2]
    outputs_identical(pipe._step_packed(half, BIT_WIDTH),
                      pipe.forward_packed(half, BIT_WIDTH),
                      "staged packed step, half the frames: vs eager")
    cache["after_half_shape"] = (packed_step.hits, packed_step.misses)
    pipe._step_packed(xq["dense"], BIT_WIDTH)
    cache["dense_again"] = (packed_step.hits, packed_step.misses)
    check(cache["after_routes"] == (4, 3)
          and cache["after_bit_width_11"] == (4, 4)
          and cache["after_half_shape"] == (4, 5)
          and cache["dense_again"] == (4, 6)
          and len(packed_step) == _staging.MAX_GRAPHS == 4,
          f"staged packed step: hits, misses {cache}, {len(packed_step)} "
          f"graphs kept")
    del planes, half, first, second, third

    # step and step_planes on the sparse capture's complex samples
    iq = iqpacket.to_complex(caps["sparse"], BIT_WIDTH)
    outputs_identical(pipe.step(iq), pipe.forward(iq),
                      "step (B9, the oracle tail): staged vs eager")
    xr, xi = (np.ascontiguousarray(v, np.float32) for v in (iq.real, iq.imag))
    outputs_identical(pipe.step_planes(xr, xi), pipe.forward_planes(xr, xi),
                      "step_planes: staged vs eager")

    # a host sync in a staged function: its capture raises; nothing runs
    # it eagerly instead, and the card works on
    def host_sync(x):
        return x * x.sum().item()

    bad = _staging.Staged(host_sync, pipe.device)
    try:
        bad(torch.ones(4, device=pipe.device))
        raised = None
    except _staging.StagingError as e:
        raised = str(e)
    check(raised is not None and "capture failed for key" in raised
          and "(4,)" in raised and len(bad) == 0,
          f"a capture with a host sync: {raised!r}")
    torch.cuda.synchronize()
    outputs_identical(pipe._step_packed(xq["dense"], BIT_WIDTH),
                      eager["dense"], "staged packed step after a failed "
                                      "capture")
