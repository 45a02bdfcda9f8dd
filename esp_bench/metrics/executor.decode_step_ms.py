"""Mean host-clock wall of the decode executor calls in the window, in
milliseconds (each ends in a device->host copy of its logits)."""


def read(rec):
    w = [c["end"] - c["start"] for c in rec.calls if c["kind"] == "decode"]
    return 1e3 * sum(w) / len(w) if w else None
