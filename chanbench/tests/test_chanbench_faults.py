"""The check fails what it must: the control (the reference in the
configuration's lower precision, in the program's place) and faults
planted in the timed path, each through a whole dry run on the CPU."""

import pytest

from chanbench.tests.helpers import dry_run


@pytest.mark.parametrize("cell", ["ch56_dense", "wb56_pulsetrain"])
def test_control_is_not_correct(cell):
    rc, line, err = dry_run(cell, seed=31, extra=["--control"])
    assert rc == 0, err[-3000:]
    assert line["correct"] is False


def _wrap_finalize(monkeypatch, change):
    from sdr_channelizer_tpu_torch.dsp import pdw

    inner = pdw.finalize_pdws

    def finalize_pdws(*args, **kwargs):
        return change(inner(*args, **kwargs))

    monkeypatch.setattr(pdw, "finalize_pdws", finalize_pdws)


def _altered(d):
    """One answer altered where it is produced: a pulse's magnitude 1 %
    high."""
    d = dict(d)
    d["mag"] = d["mag"].copy()
    d["mag"][len(d["mag"]) // 2] *= 1.01
    return d


def _half(d):
    """Half of the batch left out: the upper half of the bands."""
    keep = d["channel"] < max(int(d["channel"].max()) // 2, 1)
    return {k: v[keep] for k, v in d.items()}


@pytest.mark.parametrize("cell", ["ch56_dense", "ch56_stream"])
@pytest.mark.parametrize("change", [_altered, _half])
def test_planted_fault_is_not_correct(monkeypatch, cell, change):
    _wrap_finalize(monkeypatch, change)
    rc, line, err = dry_run(cell, seed=32)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False and line["failed"] >= 1


def test_stale_answer_is_not_correct(monkeypatch):
    """A step that returns its state unchanged: every capture gets the first
    capture's PDWs."""
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    inner = ChannelizerPipeline.extract_fused
    seen = {}

    def extract_fused(self, *args, **kwargs):
        if "first" not in seen:
            seen["first"] = inner(self, *args, **kwargs)
        return seen["first"]

    monkeypatch.setattr(ChannelizerPipeline, "extract_fused", extract_fused)
    rc, line, err = dry_run("ch56_dense", seed=33, seconds=1.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False
