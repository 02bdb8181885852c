"""``io.iqpacket.to_complex`` on the host, a capture: the harness's span
``ingest`` around the call, which the entry makes as ``cmd_pdw`` does."""


def read(res):
    spans = res.run.spans.get("ingest")
    if not spans:
        return None
    return sum(spans) / res.captures * 1e3
