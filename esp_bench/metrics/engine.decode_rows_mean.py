"""Mean rows per decode executor call in the window (the batch the engine
hands the executor)."""


def read(rec):
    rows = [c["rows"] for c in rec.calls if c["kind"] == "decode"]
    return sum(rows) / len(rows) if rows else None
