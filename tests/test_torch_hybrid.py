"""The port's hybrid family (zamba2-2.7b, reduced) against the JAX reference.

  * The Mamba2 pieces on the same inputs: `ssd_chunk_scan` (with and
    without an initial state, a prompt that is not a chunk multiple),
    `ssd_state_only`, `mamba2_forward` and `mamba2_decode_step` — the cases
    of the reference's tests/test_recurrent.py.
  * Reduced zamba2 (2 superblocks of 2 Mamba2 layers + the shared attention
    block): `prefill` and decode logits and recurrent state.
  * The port's real-mode `LoongServeEngine` serves requests through the
    serial path with the recurrent state kept in ``engine._real_cache``:
    every request's greedy tokens equal the JAX `serial_decode_oracle`, and
    the state of every finished request is released.

Tolerance: 1e-4 atol on logits, hidden states and states (f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine.request import Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402

ATOL = 1e-4


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


@pytest.fixture(scope="module")
def mamba_pair():
    jcfg = reduced(REGISTRY["zamba2-2.7b"])
    tcfg = t_reduced(T_REGISTRY["zamba2-2.7b"])
    jp = jssm.init_mamba2(
        jax.random.PRNGKey(0), jcfg.d_model, expand=jcfg.ssm_expand,
        head_dim=jcfg.ssm_head_dim, state=jcfg.ssm_state,
        conv_width=jcfg.ssm_conv_width, dtype=jnp.float32,
    )
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("t,chunk,with_init", [(64, 16, False), (51, 16, True),
                                               (15, 8, True)])
def test_ssd_chunk_scan_and_state_only(t, chunk, with_init):
    b, nh, pdim, n = 2, 4, 8, 16
    rng = np.random.default_rng(t)
    x = rng.normal(size=(b, t, nh, pdim)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, nh)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(nh,)) * 0.3).astype(np.float32)
    bb = rng.normal(size=(b, t, n)).astype(np.float32)
    cc = rng.normal(size=(b, t, n)).astype(np.float32)
    h0 = rng.normal(size=(b, nh, pdim, n)).astype(np.float32) if with_init else None
    jy, jh = jssm.ssd_chunk_scan(*map(jnp.asarray, (x, dt, a, bb, cc)), chunk,
                                 None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_chunk_scan(*map(torch.from_numpy, (x, dt, a, bb, cc)),
                                 chunk, None if h0 is None else torch.from_numpy(h0))
    _close(ty, jy)
    _close(th, jh)
    jhs, jds = jssm.ssd_state_only(*map(jnp.asarray, (x, dt, a, bb)), chunk)
    ths, tds = tssm.ssd_state_only(*map(torch.from_numpy, (x, dt, a, bb)), chunk)
    _close(ths, jhs)
    _close(tds, jds, atol=1e-6)


def test_mamba2_forward_and_decode_match_reference(mamba_pair):
    """Full-sequence layer from zero and from a carried state, then
    token-by-token decode steps from the forward's final state."""
    jcfg, jp, tcfg, tp = mamba_pair
    b, t = 2, 37
    x = (np.random.default_rng(4).normal(size=(b, t + 3, jcfg.d_model))
         * 0.1).astype(np.float32)
    jy, jst = jssm.mamba2_forward(jp, jnp.asarray(x[:, :t]), jcfg, None)
    ty, tst = tssm.mamba2_forward(tp, torch.from_numpy(x[:, :t]), tcfg, None)
    _close(ty, jy)
    _close(tst.h, jst.h)
    _close(tst.conv, jst.conv)
    jy2, _ = jssm.mamba2_forward(jp, jnp.asarray(x[:, t:]), jcfg, jst)
    ty2, _ = tssm.mamba2_forward(tp, torch.from_numpy(x[:, t:]), tcfg, tst)
    _close(ty2, jy2)
    for i in range(t, t + 3):
        jy, jst = jssm.mamba2_decode_step(jp, jnp.asarray(x[:, i:i + 1]), jcfg,
                                          jst)
        ty, tst = tssm.mamba2_decode_step(tp, torch.from_numpy(x[:, i:i + 1]),
                                          tcfg, tst)
        _close(ty, jy)
        _close(tst.h, jst.h)
    jz = jssm.init_ssm_state(jcfg, b)
    tz = tssm.init_ssm_state(tcfg, b)
    assert tz.h.shape == jz.h.shape and tz.conv.shape == jz.conv.shape


def _pair():
    jcfg = reduced(REGISTRY["zamba2-2.7b"])
    tcfg = t_reduced(T_REGISTRY["zamba2-2.7b"])
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jmodel, jparams, t_build(tcfg, device="cpu"), tparams


def test_zamba2_logits_match_reference():
    """Prefill over a 70-token prompt (not a chunk multiple), then two
    decode steps carrying the recurrent state and the shared block's KV."""
    jmodel, jparams, tmodel, tparams = _pair()
    toks = np.random.default_rng(5).integers(0, 256, (1, 70))
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    _close(tc.k, jc.k)
    _close(tc.ssm.h, jc.ssm.h)
    _close(tc.ssm.conv, jc.ssm.conv)
    for tok in (5, 77):
        jl, jc, jkv = jmodel.decode(jparams, jnp.asarray([tok]), jc)
        tl, tc, tkv = tmodel.decode(tparams, torch.tensor([tok]), tc)
        _close(tl, jl)
        _close(tc.ssm.h, jc.ssm.h)
        jc = jc._replace(k=jnp.concatenate([jc.k, jkv[0]], axis=2),
                         v=jnp.concatenate([jc.v, jkv[1]], axis=2))
        tc = tc._replace(k=torch.cat([tc.k, tkv[0]], dim=2),
                         v=torch.cat([tc.v, tkv[1]], dim=2))
    # the preallocated cache has the reference's layout
    from repro.models.transformer import init_cache as j_init_cache

    jz = j_init_cache(jmodel.cfg, 2, 16)
    tz = init_cache(tmodel.cfg, 2, 16, device="cpu")
    assert tz.k.shape == jz.k.shape and tz.ssm.h.shape == jz.ssm.h.shape
    assert tz.ssm.conv.shape == jz.ssm.conv.shape


def test_engine_serial_path_matches_jax_oracle():
    jmodel, jparams, tmodel, tparams = _pair()
    tcfg = tmodel.cfg
    eng = LoongServeEngine(tcfg, 4, 512, store_values=True, model=tmodel,
                           params=tparams, device="cpu")
    rng = np.random.default_rng(6)
    new_tokens = 4
    reqs = [Request(input_len=n, max_new_tokens=new_tokens, arrival=t,
                    prompt=rng.integers(0, tcfg.vocab_size, n).tolist())
            for n, t in zip([100, 33, 64, 17], [0.0, 0.0005, 0.001, 0.002])]
    ops.reset_dispatch_counts()
    for r in reqs:
        eng.submit(r)
    m = eng.run()
    assert len(m.finished) == len(reqs)
    n_attn = tcfg.n_attention_applications
    assert ops.dispatch_counts["prefill_serial_model"] == len(reqs)
    assert ops.dispatch_counts["attention"] == len(reqs) * n_attn
    assert ops.dispatch_counts["decode_partial"] > 0
    assert ops.dispatch_counts.get("paged_decode_partial", 0) == 0
    assert eng._real_cache == {}  # every finished request's state released
    for r in reqs:
        want = jref.serial_decode_oracle(jmodel, jparams, r.prompt,
                                         new_tokens - 1)
        assert r.output_tokens == want, (r.rid, r.output_tokens, want)
