"""The port's layers, attention math and parameter converter against the JAX
reference, on the same seeded numpy inputs.

Attention outputs and partials: 2e-5 atol (DESIGN.md §5).  Layer outputs
in f32: 1e-5 atol (one reduction each).  The converter must hand the torch
model the JAX pytree bit for bit, keys and stacked layout included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ATOL = 2e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL):
    got, want = _np(got), _np(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol)


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    r = _rng(0)
    x = r.normal(size=(3, 5, 32)).astype(np.float32)
    p = {"scale": r.normal(size=32).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = r.normal(size=32).astype(np.float32)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), kind)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_pair_layout_matches_reference(fraction):
    """Half-split pair layout with a partial rotary fraction (glm4)."""
    r = _rng(1)
    d = 32
    d_rot = int(d * fraction) // 2 * 2
    x = r.normal(size=(2, 7, 4, d)).astype(np.float32)
    pos = np.array([0, 1, 2, 5, 9, 300, 4095])
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), d_rot, 1e6)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), d_rot, 1e6)
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)
    want = JL.apply_rope(jnp.asarray(x), jc, js, d_rot)
    got = TL.apply_rope(torch.from_numpy(x), tc, ts, d_rot)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_ffn_matches_reference(kind):
    r = _rng(2)
    x = r.normal(size=(2, 3, 16)).astype(np.float32)
    p = {"w_up": r.normal(size=(16, 24)).astype(np.float32) * 0.2,
         "w_down": r.normal(size=(24, 16)).astype(np.float32) * 0.2}
    if kind == "swiglu":
        p["w_gate"] = r.normal(size=(16, 24)).astype(np.float32) * 0.2
    want = JL.apply_ffn({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), kind)
    got = TL.apply_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), kind)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_head_is_f32(dtype):
    r = _rng(3)
    x = r.normal(size=(4, 32)).astype(np.float32)
    w = r.normal(size=(32, 50)).astype(np.float32)
    want = JL.lm_head_logits(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    got = TL.lm_head_logits(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32
    _close(got, np.asarray(want, np.float32), 1e-4)


# --------------------------------------------------------------- attention


@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_partial_attention_with_empty_rows(kvh, softcap):
    """Masked partial incl. fully-masked rows: m=-inf, l=0, o=0."""
    r = _rng(4)
    q = r.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k = r.normal(size=(2, 9, kvh, 16)).astype(np.float32)
    v = r.normal(size=(2, 9, kvh, 16)).astype(np.float32)
    mask = r.random((2, 6, 9)) < 0.5
    mask[0, 2] = False  # an empty row
    mask[1, :] = False  # an empty batch entry
    want = JA.partial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(mask), softcap=softcap)
    got = TA.partial_attention(*map(torch.from_numpy, (q, k, v, mask)),
                               softcap=softcap)
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    assert torch.isinf(got.m[0, 2]).all() and (got.l[0, 2] == 0).all()


def test_merge_and_finalize_match_reference():
    r = _rng(5)
    parts = []
    for i in range(3):
        o = r.normal(size=(2, 3, 4, 8)).astype(np.float32)
        m = r.normal(size=(2, 3, 4)).astype(np.float32)
        l = r.random((2, 3, 4)).astype(np.float32) + 0.1
        if i == 1:
            m[0] = -np.inf  # an empty shard for batch entry 0
            l[0] = 0.0
            o[0] = 0.0
        parts.append((o, m, l))
    jp, tp = JA.Partial(*map(jnp.asarray, parts[0])), TA.Partial(
        *map(torch.from_numpy, parts[0]))
    for p in parts[1:]:
        jp = JA.merge_partial(jp, tuple(map(jnp.asarray, p)))
        tp = TA.merge_partial(tp, tuple(map(torch.from_numpy, p)))
    for g_, w_ in zip(tp, jp):
        _close(g_, w_)
    _close(TA.finalize_partial(tp), JA.finalize_partial(jp))
    empty = TA.empty_partial(2, 3, 4, 8)
    _close(TA.finalize_partial(TA.merge_partial(tp, empty)),
           JA.finalize_partial(jp))


def test_masks_segments_and_gqa_match_reference():
    qp = np.array([[3, 4, 9], [0, 1, 2]])
    kp = np.array([[0, 3, 4, 8], [0, 1, 5, 6]])
    kv = np.array([[True, True, False, True], [True, True, True, False]])
    for causal, window in [(True, None), (True, 3), (False, 2)]:
        want = JA.mask_from_positions(jnp.asarray(qp), jnp.asarray(kp),
                                      causal=causal, window=window,
                                      k_valid=jnp.asarray(kv))
        got = TA.mask_from_positions(torch.from_numpy(qp), torch.from_numpy(kp),
                                     causal=causal, window=window,
                                     k_valid=torch.from_numpy(kv))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    off = np.array([0, 5, 5, 9, 12, 12], np.int32)
    np.testing.assert_array_equal(
        _np(TA.packed_segment_ids(off, 16)),
        np.asarray(JA.packed_segment_ids(jnp.asarray(off), 16)))
    x = _rng(6).normal(size=(2, 3, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(_np(TA.gqa_expand(torch.from_numpy(x), 3)),
                                  np.asarray(JA.gqa_expand(jnp.asarray(x), 3)))


@pytest.mark.parametrize("window", [None, 4])
def test_full_attention_matches_reference(window):
    r = _rng(7)
    q = r.normal(size=(1, 10, 4, 16)).astype(np.float32)
    k = r.normal(size=(1, 10, 2, 16)).astype(np.float32)
    v = r.normal(size=(1, 10, 2, 16)).astype(np.float32)
    want = JA.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=window, softcap=3.0)
    got = TA.full_attention(*map(torch.from_numpy, (q, k, v)), window=window,
                            softcap=3.0)
    _close(got, want)


# --------------------------------------------------------------- converter


@pytest.mark.parametrize("arch", ["lwm-7b", "qwen1.5-4b", "nemotron-4-15b"])
def test_params_from_numpy_is_exact(arch):
    """The JAX Model.init pytree lands in the torch tree bit for bit, keys
    and stacked [L, ...] layout kept; init_params draws the same tree."""
    jcfg = reduced(REGISTRY[arch], n_layers=2)
    tcfg = t_reduced(T_REGISTRY[arch], n_layers=2)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.params_from_numpy(tcfg, tree, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(tparams))
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    drawn = convert.init_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    for (path, leaf), t in zip(flat_j, jax.tree_util.tree_leaves(drawn)):
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32, path
    assert (drawn["final_norm"]["scale"] == 1).all()


def test_params_from_numpy_bf16_and_key_check():
    jcfg = reduced(REGISTRY["lwm-7b"], n_layers=1, dtype="bfloat16")
    tcfg = t_reduced(T_REGISTRY["lwm-7b"], n_layers=1, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(1)))
    tparams = convert.params_from_numpy(tcfg, tree, device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tparams["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))
    del tree["lm_head"]
    with pytest.raises(KeyError):
        convert.params_from_numpy(tcfg, tree, device="cpu")
