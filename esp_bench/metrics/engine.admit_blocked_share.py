"""Share of the window's scheduling rounds that found requests waiting and
admitted none, in %: `engine.schedule` spans with a value (requests waiting
at entry) above 0 whose `engine.admitted` marks (`repro_torch.obs`) sum to
0."""
from esp_bench.timeline import window


def read(rec):
    recs = window(rec)
    if recs is None:
        return None
    rounds = [(a, b) for n, a, b, v in recs if n == "engine.schedule" and v]
    if not rounds:
        return None
    marks = [(a, v or 0) for n, a, _, v in recs if n == "engine.admitted"]
    blocked = sum(1 for a, b in rounds
                  if not sum(v for t, v in marks if a <= t <= b))
    return 100.0 * blocked / len(rounds)
