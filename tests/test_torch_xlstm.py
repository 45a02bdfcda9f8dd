"""The port's xLSTM (the ssm family, xlstm-350m reduced) against the JAX
reference.

  * The cells on the same seeded inputs, the cases of the reference's
    tests/test_recurrent.py: chunkwise mLSTM (prompts that are and are not a
    chunk multiple, with and without a carried state) against its JAX
    namesake and against the port's own decode steps; `mlstm_state_only` and
    `mlstm_combine_states` (the sequence-parallel handoff); the sLSTM scan
    against its JAX namesake and against the port's steps; both blocks.
  * The port's real-mode `LoongServeEngine` on reduced xlstm-350m (no KV:
    the recurrent state rides ``engine._real_cache``) emits exactly the JAX
    engine's tokens on the same parameters, and exactly the port's serial
    oracle's.

Tolerance: 1e-4 relative to max|reference| (f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.engine.request import Request as JRequest  # noqa: E402
from repro.engine.server import LoongServeEngine as JEngine  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine.request import Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402

RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, atol=rtol * scale, rtol=0)


def _gates(seed, b, t, h, dh):
    """q, k, v [B,T,H,Dh] and the raw gates [B,T,H] as in the reference's
    tests (forget gate biased towards remembering)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, t, h, dh)).astype(np.float32) for _ in range(3))
    ig = rng.normal(size=(b, t, h)).astype(np.float32)
    fg = (rng.normal(size=(b, t, h)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _state(seed, b, h, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, dh, dh)).astype(np.float32) * 0.3,
            rng.normal(size=(b, h, dh)).astype(np.float32) * 0.3,
            rng.normal(size=(b, h)).astype(np.float32))


@pytest.mark.parametrize("t,chunk,with_state", [
    (15, 8, False), (32, 8, False), (51, 16, True), (48, 16, True), (7, 64, False),
])
def test_mlstm_chunkwise_matches_reference_and_steps(t, chunk, with_state):
    b, h, dh = 2, 2, 8
    arrs = _gates(t, b, t, h, dh)
    st = _state(t + 1, b, h, dh) if with_state else None
    jout, jst = jx.mlstm_chunkwise(*map(jnp.asarray, arrs), chunk,
                                   None if st is None else jx.MLSTMState(*map(jnp.asarray, st)))
    tst0 = None if st is None else tx.MLSTMState(*map(torch.from_numpy, st))
    tout, tst = tx.mlstm_chunkwise(*map(torch.from_numpy, arrs), chunk, tst0)
    _close(tout, jout)
    for got, want in zip(tst, jst):
        _close(got, want)
    # decode steps from the same state: each against its JAX namesake, and
    # together against the chunkwise pass (the reference test's tolerance)
    s = tst0 if tst0 is not None else tx.init_mlstm_state_raw(b, h, dh, dh)
    js = jx.MLSTMState(*(jnp.asarray(a.numpy()) for a in s))
    outs = []
    for i in range(t):
        o, s = tx.mlstm_step(*(torch.from_numpy(a[:, i]) for a in arrs), s)
        jo, js = jx.mlstm_step(*(jnp.asarray(a[:, i]) for a in arrs), js)
        _close(o, jo)
        outs.append(o[:, None])
    for got, want in zip(s, js):
        _close(got, want)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), tout.numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(s.c.numpy(), tst.c.numpy(), atol=1e-4, rtol=1e-3)


def test_mlstm_state_only_and_combine():
    b, h, dh, t, chunk = 1, 2, 8, 48, 8
    q, k, v, ig, fg = _gates(7, b, t, h, dh)
    tk, tv, tig, tfg = map(torch.from_numpy, (k, v, ig, fg))
    js, jb = jx.mlstm_state_only(*map(jnp.asarray, (k, v, ig, fg)), chunk)
    ts, tb = tx.mlstm_state_only(tk, tv, tig, tfg, chunk)
    for got, want in zip(ts, js):
        _close(got, want)
    _close(tb, jb)
    # monoid: state(first half) o segment(second half) == state(full)
    _, full = tx.mlstm_chunkwise(*map(torch.from_numpy, (q, k, v, ig, fg)), chunk)
    half = t // 2
    s1, _ = tx.mlstm_state_only(tk[:, :half], tv[:, :half], tig[:, :half],
                                tfg[:, :half], chunk)
    s2, b2 = tx.mlstm_state_only(tk[:, half:], tv[:, half:], tig[:, half:],
                                 tfg[:, half:], chunk)
    comb = tx.mlstm_combine_states(s1, s2, b2)
    jcomb = jx.mlstm_combine_states(
        jx.MLSTMState(*(jnp.asarray(a.numpy()) for a in s1)),
        jx.MLSTMState(*(jnp.asarray(a.numpy()) for a in s2)), jnp.asarray(b2.numpy()))
    for got, want, ref in zip(comb, full, jcomb):
        _close(got, want, rtol=1e-3)
        _close(got, ref)
    # the identity state (m = -inf) combines without NaN
    ident = tx.init_mlstm_state_raw(b, h, dh, dh)
    again = tx.mlstm_combine_states(ident, s2, b2)
    assert all(torch.isfinite(a).all() for a in again)
    _close(again.c, s2.c)


@pytest.fixture(scope="module")
def cells():
    jcfg = reduced(REGISTRY["xlstm-350m"])
    tcfg = t_reduced(T_REGISTRY["xlstm-350m"])
    tree = jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tcfg, tree, device="cpu")
    lay, tlay = tree["layers"], tparams["layers"]
    mj = jax.tree.map(lambda a: jnp.asarray(a[0, 0]), lay["mlstm_layers"]["cell"])
    sj = jax.tree.map(lambda a: jnp.asarray(a[0]), lay["slstm"]["cell"])
    mt = {k: v[0, 0] for k, v in tlay["mlstm_layers"]["cell"].items()}
    st = {k: v[0] for k, v in tlay["slstm"]["cell"].items()}
    return jcfg, tcfg, mj, mt, sj, st


@pytest.mark.parametrize("t", [9, 37])
def test_blocks_match_reference(cells, t):
    """Both blocks over a prompt, then three steps from the carried state;
    the sLSTM scan against the port's own steps."""
    jcfg, tcfg, mj, mt, sj, st = cells
    b = 2
    x = (np.random.default_rng(t).normal(size=(b, t + 3, jcfg.d_model))
         * 0.3).astype(np.float32)
    for fwd, step, jp, tp in (
            ("mlstm_block_forward", "mlstm_block_step", mj, mt),
            ("slstm_block_forward", "slstm_block_step", sj, st)):
        jy, js = getattr(jx, fwd)(jp, jnp.asarray(x[:, :t]), jcfg, None)
        ty, ts = getattr(tx, fwd)(tp, torch.from_numpy(x[:, :t]), tcfg, None)
        _close(ty, jy)
        for got, want in zip(ts, js):
            _close(got, want)
        for i in range(t, t + 3):
            jy, js = getattr(jx, step)(jp, jnp.asarray(x[:, i:i + 1]), jcfg, js)
            ty, ts = getattr(tx, step)(tp, torch.from_numpy(x[:, i:i + 1]), tcfg, ts)
            _close(ty, jy)
            for got, want in zip(ts, js):
                _close(got, want)
    # sLSTM: stepping from the initial state reproduces the scan
    y_full, _ = tx.slstm_block_forward(st, torch.from_numpy(x[:, :t]), tcfg, None)
    s = tx.init_slstm_state(tcfg, b)
    ys = []
    for i in range(t):
        y, s = tx.slstm_block_step(st, torch.from_numpy(x[:, i:i + 1]), tcfg, s)
        ys.append(y)
    _close(torch.cat(ys, dim=1), y_full)


def test_xlstm_cache_layout_matches_reference():
    from repro.models.transformer import init_cache as j_init_cache

    jz = j_init_cache(reduced(REGISTRY["xlstm-350m"]), 2, 16)
    tz = init_cache(t_reduced(T_REGISTRY["xlstm-350m"]), 2, 16, device="cpu")
    assert jz.k is None and tz.k is None
    for jt, tt in zip(jz.ssm, tz.ssm):
        for a, b_ in zip(jt, tt):
            assert tuple(a.shape) == tuple(b_.shape)
            np.testing.assert_array_equal(np.asarray(a), b_.numpy())


# prompt lengths and arrivals: a 100-token prompt is a chunk multiple of
# neither the reduced chunk (32) nor a power of two; the later arrivals land
# while decode groups hold instances
LENS = [100, 33, 64, 17, 50]
ARRIVALS = [0.0, 0.0005, 0.001, 0.002, 0.003]
NEW_TOKENS = 4


def test_engine_matches_jax_engine_tokens():
    jcfg = reduced(REGISTRY["xlstm-350m"])
    tcfg = t_reduced(T_REGISTRY["xlstm-350m"])
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = t_build(tcfg, device="cpu")
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in LENS]
    tokens = {}
    for port in (True, False):
        if port:
            eng = LoongServeEngine(tcfg, 4, 1024, store_values=True,
                                   model=tmodel, params=tparams, device="cpu")
            mk = Request
        else:
            eng = JEngine(jcfg, 4, 1024, store_values=True, model=jmodel,
                          params=jparams)
            mk = JRequest
        reqs = [mk(input_len=len(p), max_new_tokens=NEW_TOKENS, arrival=t,
                   prompt=list(p)) for p, t in zip(prompts, ARRIVALS)]
        ops.reset_dispatch_counts()
        for r in reqs:
            eng.submit(r)
        m = eng.run()
        assert len(m.finished) == len(reqs)
        assert m.scaling_migration_bytes == 0
        tokens[port] = [r.output_tokens for r in reqs]
        if port:
            assert ops.dispatch_counts["prefill_serial_model"] == len(reqs)
            assert ops.dispatch_counts.get("attention", 0) == 0  # no K4
            assert ops.dispatch_counts.get("decode_partial", 0) == 0  # no K5
            assert eng._real_cache == {}  # every finished request's state released
    assert tokens[True] == tokens[False]
    for p, got in zip(prompts, tokens[True]):
        assert got == tref.serial_decode_oracle(tmodel, tparams, p, NEW_TOKENS - 1)
