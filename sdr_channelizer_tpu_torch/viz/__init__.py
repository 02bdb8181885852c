"""Visualization: the reference's plot outputs as PNG renderers (and the
waterfall video).  ``matplotlib`` and ``cv2`` are imported where they are
used."""

from sdr_channelizer_tpu_torch.viz.plots import (  # noqa: F401
    plot_iq_png,
    waterfall_png,
    waterfall_video,
    waterfall_window_pngs,
    pdw_plot_png,
    event_fit_png,
)
