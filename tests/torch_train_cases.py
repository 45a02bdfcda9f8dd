"""Shared pieces of the port's training tests (`test_torch_train.py`,
`test_torch_train_steps.py`): seeded numpy batches, the reference / port
train-step pair on one converted parameter set, and `hold`, which holds one
step's outputs to the reference's (tolerances in `test_torch_train_steps`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import REGISTRY, reduced
from repro.launch import steps as jsteps
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as tsteps

LR = 3e-4
FAMILIES = ["lwm-7b", "glm4-9b", "mixtral-8x7b", "zamba2-2.7b", "xlstm-350m",
            "whisper-tiny", "pixtral-12b"]


def np_(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def batch_for(cfg, b=2, t=24, seed=3):
    """A numpy batch with ``-1`` labels on the image positions (vlm) and on
    one text position."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t))}
    extra = 0
    if cfg.frontend == "patch_stub":
        extra = cfg.n_frontend_tokens
        batch["patch_embeds"] = (rng.normal(size=(b, extra, cfg.d_model))
                                 * 0.05).astype(np.float32)
    if cfg.frontend == "audio_stub":
        batch["frames"] = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
                           * 0.05).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (b, t + extra))
    labels[:, :extra] = -1
    labels[0, -3] = -1
    batch["labels"] = labels
    return batch


def setup(arch, **kw):
    jcfg, tcfg = reduced(REGISTRY[arch]), t_reduced(T_REGISTRY[arch])
    jm, jstep = jsteps.make_train_step(jcfg, None, loss_chunk=16, **kw)
    _, tstep = tsteps.make_train_step(tcfg, None, loss_chunk=16, device="cpu", **kw)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    batch = batch_for(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return (jax.jit(jstep), jp, jsteps.init_opt_state(jp), jb), \
        (tstep, tp, tsteps.init_opt_state(tp), tb)


def direction(m, v, n_step):
    """AdamW's update direction ``m^ / (sqrt(v^) + eps)`` of given moments,
    in f64."""
    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
    return (m / (1 - 0.9 ** n_step)) / (np.sqrt(v / (1 - 0.95 ** n_step)) + 1e-8)


def hold(jout, tout, n_step, explained, int8=False):
    """Hold one step's outputs.  ``explained`` (by key, carried across
    steps) accumulates lr x |the difference of the two packages' AdamW
    directions| computed from their own moments: where the gradient sits
    within ~100 eps of zero, ``g / (|g| + eps)`` turns a gradient error of
    1e-9 into a parameter difference of up to 2 lr, and the parameters are
    held to 1e-6 beyond that.  Under int8 compression a gradient within
    rounding noise of a half-step may land one int8 level away: m may then
    differ by one level, 0.1 max|g| / 127."""
    (jp, jo, jmet), (tp, to, tmet) = jout, tout
    for key in ("loss", "aux", "grad_norm"):
        want = float(jmet[key])
        assert abs(float(tmet[key]) - want) <= 1e-4 * max(abs(want), 1e-6), (key, tmet[key], want)
    jm, tm = flat(jax.tree.map(np.asarray, jo["m"])), flat(to["m"])
    jv, tv = flat(jax.tree.map(np.asarray, jo["v"])), flat(to["v"])
    assert set(jm) == set(tm)
    jpf, tpf = flat(jax.tree.map(np.asarray, jp)), flat(tp)
    for key in jm:
        w = jm[key]
        level = np.abs(w).max() / 127 if int8 else 0.0
        np.testing.assert_allclose(np_(tm[key]), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + level,
                                   err_msg=f"m {key}")
        du = np.abs(direction(np_(tm[key]), np_(tv[key]), n_step)
                    - direction(w, jv[key], n_step))
        explained[key] = explained.get(key, 0.0) + LR * du
        assert (LR * du > 1e-6).mean() < 0.01, (key, (LR * du > 1e-6).mean())
        d = np.abs(np_(tpf[key]) - jpf[key].astype(np.float32))
        excess = d - explained[key]
        assert excess.max() <= 1e-6, (key, excess.max(), d.max())
    assert int(to["step"]) == int(jo["step"]) == n_step
