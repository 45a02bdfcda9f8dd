"""Every assigned architecture (reduced, f32) through the port's `build_model`
against the JAX reference, on the JAX `init(PRNGKey(0))` parameters
converted by `params_from_numpy` — the cases of the reference's
tests/test_arch_smoke.py.

  * `forward` logits (and the moe load-balance aux loss) equal the JAX
    `forward` within 1e-4 relative to max|logit|; `hidden` is the stack
    before the unembed.
  * The port's `prefill` + one `decode` over a padded cache give the port's
    own `forward` at the last position within the reference test's
    3e-3 x (max|logit| + 1).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ASSIGNED, REGISTRY, reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402

RTOL = 1e-4


@functools.lru_cache(maxsize=None)  # both tests of an arch share its init
def _pair(arch):
    jcfg = reduced(REGISTRY[arch])
    tcfg = t_reduced(T_REGISTRY[arch])
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, t_build(tcfg, device="cpu"), tparams


def _batch_for(cfg, b, t, seed):
    """(jax batch, torch batch, frontend tokens prepended): the reference
    test's batch, made from one numpy seed."""
    rng = np.random.default_rng(seed)
    arrs = {"tokens": rng.integers(0, cfg.vocab_size, (b, t))}
    extra = 0
    if cfg.frontend == "patch_stub":
        arrs["patch_embeds"] = (rng.normal(size=(b, cfg.n_frontend_tokens,
                                                 cfg.d_model)) * 0.05).astype(np.float32)
        extra = cfg.n_frontend_tokens
    if cfg.frontend == "audio_stub":
        arrs["frames"] = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
                          * 0.05).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()}, extra)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_forward_matches_reference(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    cfg = tmodel.cfg
    b, t = 2, 33
    jbatch, tbatch, extra = _batch_for(cfg, b, t, 1)
    jl, jaux = jmodel.forward(jparams, jbatch)
    tl, taux = tmodel.forward(tparams, tbatch)
    assert tl.shape == (b, t + extra, cfg.vocab_size)
    assert torch.isfinite(tl).all()
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=RTOL * float(np.abs(jl).max()))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL, atol=1e-6)
    x, _ = tmodel.hidden(tparams, tbatch)
    assert torch.equal(tmodel.unembed(tparams, x), tl)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_prefill_decode_matches_forward(arch):
    _, _, tmodel, tparams = _pair(arch)
    cfg = tmodel.cfg
    b, t = 2, 17
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, t + 1))
    _, batch, extra = _batch_for(cfg, b, t, 3)
    batch["tokens"] = torch.from_numpy(toks[:, :t])
    full = dict(batch, tokens=torch.from_numpy(toks))
    logits_full, _ = tmodel.forward(tparams, full)

    _, cache = tmodel.prefill(tparams, batch)
    if cache.k is not None:
        pad_to = t + extra + 4
        k_pad = cache.k.new_zeros((cache.k.shape[0], b, pad_to) + cache.k.shape[3:])
        v_pad = torch.zeros_like(k_pad)
        k_pad[:, :, :t + extra] = cache.k
        v_pad[:, :, :t + extra] = cache.v
        cache = cache._replace(k=k_pad, v=v_pad)
    logits_dec, new_cache, _ = tmodel.decode(tparams, torch.from_numpy(toks[:, t]),
                                             cache)
    assert (new_cache.length == t + extra + 1).all()
    scale = float(logits_full[:, -1].abs().max()) + 1.0
    err = float((logits_dec - logits_full[:, -1]).abs().max())
    assert err < 3e-3 * scale, (arch, err, scale)
