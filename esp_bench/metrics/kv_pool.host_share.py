"""Share of the window the host spends in the KV pool: the mirror's sync
(`KVPool.device_kv`), the host pool's write of new KV (`KVPool.fill`) and
the decode epilogue's copy of the sampled ids and the new KV to the host,
in %."""

NAMES = ("mirror_sync", "kv_fill_host", "emit_to_host")


def read(rec):
    if rec.kernels is None:  # the spans are taken in the traced run only
        return None
    s = sum(b - a for n, a, b in rec.spans if n in NAMES)
    return 100.0 * s / rec.window_s
