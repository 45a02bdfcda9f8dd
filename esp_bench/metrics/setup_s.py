"""Set-up: process start to the first timed request (weights drawn on the
device, engine and pools built, the pool mirrors' full upload, the mix's
warm-up requests served; compilation in a checkout's first run)."""


def read(rec):
    return rec.setup_s
