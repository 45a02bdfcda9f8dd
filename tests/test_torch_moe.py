"""The port's moe family (mixtral-8x7b, reduced) against the JAX reference.

  * `apply_moe` on the same tokens and parameters: a case where capacity
    drops assignments, and one with tied router scores (top-k keeps the
    lower expert index first, as ``lax.top_k`` does).
  * Reduced mixtral with 2 KV heads and a 32-token sliding window, so GQA
    and the window both bite at these prompt lengths: `prefill` and
    dense-cache `decode` logits, with one parameter set converted from the
    JAX `Model.init` pytree.
  * The port's real-mode `LoongServeEngine` (4 elastic instances) serves
    requests through the serial path (K4 per prefill layer, K5 per decode
    layer — their plain versions on CPU tensors): every request's greedy
    tokens equal the JAX `serial_decode_oracle` exactly.

Tolerances: 1e-4 atol on logits and hidden states, 2e-5 on expert outputs
(f32; the summation order differs between frameworks).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine.request import Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ATOL = 1e-4
OVER = dict(n_layers=2, n_kv_heads=2, sliding_window=32)


def _pair(**over):
    jcfg = reduced(REGISTRY["mixtral-8x7b"], **over)
    tcfg = t_reduced(T_REGISTRY["mixtral-8x7b"], **over)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jmodel, jparams, t_build(tcfg, device="cpu"), tparams


def _moe_params(seed, d, f, e):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in
            (("router", (d, e)), ("w_up", (e, d, f)), ("w_gate", (e, d, f)),
             ("w_down", (e, f, d)))}


@pytest.mark.parametrize("case", ["capacity_drops", "tied_scores"])
def test_apply_moe_matches_reference(case):
    t, d, f, e, k = 40, 32, 48, 4, 2
    p = _moe_params(0, d, f, e)
    x = np.random.default_rng(1).normal(size=(t, d)).astype(np.float32)
    factor = 0.5 if case == "capacity_drops" else 4.0
    if case == "tied_scores":
        # experts 1 and 2 get identical router columns: every token ties
        # between them, and the top-2 choice hinges on the tie-break
        p["router"][:, 2] = p["router"][:, 1]
    want = jmoe.apply_moe({n: jnp.asarray(a) for n, a in p.items()},
                          jnp.asarray(x), top_k=k, capacity_factor=factor,
                          ffn_kind="swiglu")
    got = tmoe.apply_moe({n: torch.from_numpy(a) for n, a in p.items()},
                         torch.from_numpy(x), top_k=k, capacity_factor=factor,
                         ffn_kind="swiglu")
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out), atol=2e-5)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               atol=1e-6)
    assert float(got.dropped_frac) == pytest.approx(float(want.dropped_frac))
    if case == "capacity_drops":
        assert float(got.dropped_frac) > 0.1
    assert tmoe.capacity(t, e, k, factor) == jmoe.capacity(t, e, k, factor)


def test_mixtral_logits_match_reference():
    """Prefill over a 70-token prompt (window 32 masks), then two dense-cache
    decode steps with the new token's KV appended."""
    jmodel, jparams, tmodel, tparams = _pair(**OVER)
    toks = np.random.default_rng(2).integers(0, 256, (1, 70))
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)
    for step, tok in enumerate((5, 77)):
        jl, jc, jkv = jmodel.decode(jparams, jnp.asarray([tok]), jc)
        tl, tc, tkv = tmodel.decode(tparams, torch.tensor([tok]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(tkv[0].numpy(), np.asarray(jkv[0]), atol=ATOL)
        jc = jc._replace(k=jnp.concatenate([jc.k, jkv[0]], axis=2),
                         v=jnp.concatenate([jc.v, jkv[1]], axis=2))
        tc = tc._replace(k=torch.cat([tc.k, tkv[0]], dim=2),
                         v=torch.cat([tc.v, tkv[1]], dim=2))


def test_engine_serial_path_matches_jax_oracle():
    jmodel, jparams, tmodel, tparams = _pair(**OVER)
    tcfg = tmodel.cfg
    eng = LoongServeEngine(tcfg, 4, 512, store_values=True, model=tmodel,
                           params=tparams, device="cpu")
    rng = np.random.default_rng(3)
    new_tokens = 4
    reqs = [Request(input_len=n, max_new_tokens=new_tokens, arrival=t,
                    prompt=rng.integers(0, tcfg.vocab_size, n).tolist())
            for n, t in zip([96, 20, 57, 41], [0.0, 0.0005, 0.001, 0.002])]
    ops.reset_dispatch_counts()
    for r in reqs:
        eng.submit(r)
    m = eng.run()
    assert len(m.finished) == len(reqs)
    assert ops.dispatch_counts["prefill_serial_model"] == len(reqs)
    assert ops.dispatch_counts["attention"] == len(reqs) * tcfg.n_layers
    assert ops.dispatch_counts["decode_partial"] > 0
    for name in ("prefill_packed", "prefill_ring_chunk", "paged_decode_partial"):
        assert ops.dispatch_counts.get(name, 0) == 0, name
    for r in reqs:
        want = jref.serial_decode_oracle(jmodel, jparams, r.prompt,
                                         new_tokens - 1)
        assert r.output_tokens == want, (r.rid, r.output_tokens, want)
