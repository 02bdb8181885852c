"""``dsp.pdw.finalize_pdws`` (the batch's device-to-host transfers and the
float64 PDWs), a capture: the span ``finalize`` of a wrapper that the
traced run puts on the module attribute the entries call.  Where the
attribute is gone the metric is missing; the run goes on."""

import importlib


def install(run):
    try:
        mod = importlib.import_module("sdr_channelizer_tpu_torch.dsp.pdw")
    except ImportError:
        return
    inner = getattr(mod, "finalize_pdws", None)
    if inner is None:
        return

    def finalize_pdws(*args, **kwargs):
        with run.span("finalize"):
            return inner(*args, **kwargs)

    mod.finalize_pdws = finalize_pdws


def read(res):
    spans = res.run.spans.get("finalize")
    if not spans:
        return None
    return sum(spans) / res.captures * 1e3
