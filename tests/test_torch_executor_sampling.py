"""Greedy sampling and the value guard on the device (`greedy_ids`) against
the host's numpy semantics: a finite row's id is `np.argmax` (the first
maximal index), a row holding NaN or +-inf gets -1, and the executor
quarantines exactly the rows that are not finite and the poisoned rids.
On the CPU, and (marked ``gpu``) on the card at glm4-9b's width.  No
serving path hands the executor's `_to_host` a logits tensor.  No JAX
here, so the file runs where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -q tests/test_torch_executor_sampling.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import init_params  # noqa: E402
from repro_torch.engine.executor import LocalExecutor, greedy_ids  # noqa: E402
from repro_torch.engine.request import Phase, Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.manager.scheduler import ManagerConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def _want(x: np.ndarray) -> np.ndarray:
    """The host's semantics: np.argmax of a finite row, -1 otherwise."""
    return np.where(np.isfinite(x).all(-1), np.argmax(x, -1), -1)


def _hand_made(v: int = 9) -> np.ndarray:
    rows = np.random.default_rng(0).normal(size=(14, v)).astype(np.float32)
    rows[0, [0, 4]] = 5.0  # tie at index 0
    rows[1, [3, v - 1]] = 5.0  # tie at V-1 with an earlier index
    rows[2, [0, v - 1]] = 5.0  # tie at index 0 and at V-1
    rows[3, v - 1] = 5.0  # the maximum alone at V-1
    rows[4] = 1.5  # every entry tied
    rows[5, 2] = np.nan
    rows[6, 6] = np.inf
    rows[7, 1] = -np.inf
    rows[8] = np.nan  # all NaN
    rows[9, [0, 3]] = [np.inf, np.nan]
    rows[10] = -np.inf  # all -inf
    rows[11] = -3.0e38  # finite, near the bottom of f32
    rows[12, [v - 2, v - 1]] = 3.4e38  # finite, tie near the top
    return rows


def test_greedy_ids_match_numpy():
    x = _hand_made()
    got = greedy_ids(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (len(x),)
    want = _want(x)
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(want[:5]) == [0, 3, 0, 8, 0] and want[12] == 7
    assert (want[5:11] == -1).all()


def _engine(arch="lwm-7b", chunk=None):
    cfg = reduced(get_config(arch), n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return LoongServeEngine(cfg, 2, 512, store_values=True,
                            model=build_model(cfg, device="cpu"),
                            params=params, device="cpu",
                            mcfg=ManagerConfig(prefill_chunk_tokens=chunk))


def test_sample_rows_quarantine_the_rows_not_finite_and_the_poisoned():
    x = _hand_made()
    eng = _engine()
    ex = eng.executor
    reqs = [Request(input_len=4, max_new_tokens=4) for _ in x]
    poisoned = {reqs[1].rid, reqs[12].rid}
    outside = Request(input_len=4, max_new_tokens=4)  # poisoned, not here
    eng._logit_poison.update(poisoned | {outside.rid})
    ids = greedy_ids(torch.from_numpy(x)).numpy()
    n = ex._sample_rows(reqs, ids)
    bad = {reqs[b].rid for b in np.flatnonzero(~np.isfinite(x).all(-1))}
    assert eng._quarantine == bad | poisoned
    assert eng._logit_poison == {outside.rid}  # consumed only where seen
    want = _want(x)
    for b, r in enumerate(reqs):
        if r.rid in eng._quarantine:
            assert r.output_tokens == []
        else:
            assert r.output_tokens == [int(want[b])]
    assert n == len(reqs) - len(bad | poisoned)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the reduction runs on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_greedy_ids_on_card_at_glm4_width(cuda_device):
    """glm4-9b's vocabulary (151552) at the benchmark's decode batch (725
    rows), with the hand-made rows at the top of the batch."""
    b, v = 725, 151552
    x = torch.randn(b, v, generator=torch.Generator().manual_seed(1)).numpy()
    x[:14, :9] = _hand_made()
    x[:14, 9:] = -10.0  # the hand-made maxima stay the row maxima
    x[20, [17, v - 1]] = 100.0  # a tie far apart
    x[21, v - 1] = np.nan
    got = greedy_ids(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    np.testing.assert_array_equal(got, _want(x))


# ---------------------------------------------------- no logits to the host
@pytest.mark.parametrize("arch, chunk, path", [
    ("lwm-7b", None, "prefill_packed"),  # and the paged decode
    ("lwm-7b", 16, "unified_step"),
    ("mixtral-8x7b", None, "prefill_serial_model"),  # and the serial decode
])
def test_no_logits_tensor_reaches_the_host(monkeypatch, arch, chunk, path):
    """Every tensor handed to `_to_host` is ids or KV: none has the
    vocabulary as a dimension, and each row brings one int32 id."""
    eng = _engine(arch, chunk)
    ops.reset_dispatch_counts()
    cfg = eng.cfg
    shapes = []
    to_host = LocalExecutor._to_host

    def spy(*tensors):
        shapes.extend(tuple(t.shape) for t in tensors if t is not None)
        return to_host(*tensors)
    monkeypatch.setattr(LocalExecutor, "_to_host", staticmethod(spy))
    rng = np.random.default_rng(3)
    reqs = [Request(input_len=24, max_new_tokens=4,
                    prompt=rng.integers(0, cfg.vocab_size, 24).tolist())
            for _ in range(4)]
    for r in reqs:
        eng.submit(r, at=0.0)
    eng.run()
    assert all(r.phase is Phase.FINISHED and len(r.output_tokens) == 4
               for r in reqs)
    assert ops.dispatch_counts[path] > 0
    assert shapes and all(cfg.vocab_size not in s for s in shapes), shapes
    assert sum(np.prod(s) for s in shapes if len(s) == 1) >= 4 * 4
