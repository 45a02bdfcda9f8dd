"""Mean instances per prefill executor call in the window (the ESP group's
degree of parallelism)."""


def read(rec):
    dop = [c["dop"] for c in rec.calls if c["kind"] == "prefill"]
    return sum(dop) / len(dop) if dop else None
