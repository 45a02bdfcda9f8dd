"""One and two train steps of the port's `launch/steps.make_train_step`
against the reference's (``jax.jit``) on the same converted parameters and
batch, for one config per family (lwm-7b, glm4-9b, mixtral-8x7b,
zamba2-2.7b, xlstm-350m, whisper-tiny and pixtral-12b with ``-1`` image
labels), with ``microbatches=2`` and with int8 gradient compression.

Tolerances, f32 throughout: loss, aux and grad_norm within 1e-4 relative;
every leaf of the new first moment ``m`` (0.1 x the gradient after one
step) within 1e-4 x max|leaf|; new parameters within 1e-6 absolute beyond
lr x the difference between the AdamW directions ``m^ / (sqrt(v^) + eps)``
of the two packages' own moments (`torch_train_cases.hold`: where a
gradient sits within ~100 eps of zero, a gradient error of 1e-9 moves that
direction by up to 2; such elements must stay under 1 % of every leaf).
Under int8 compression m may also sit one int8 level apart.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_train_cases import FAMILIES, hold, setup  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The reduced configs gain nothing from intra-op threads, and under a
    multi-worker run they only contend (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    (js, jp, jo, jb), (ts, tp, to, tb) = setup(arch, remat=False)
    explained = {}
    for n in (1, 2):
        jp, jo, jmet = js(jp, jo, jb)
        tp, to, tmet = ts(tp, to, tb)
        hold((jp, jo, jmet), (tp, to, tmet), n, explained)


@pytest.mark.parametrize("arch", ["lwm-7b", "mixtral-8x7b"])
def test_train_step_microbatches_match_reference(arch):
    (js, jp, jo, jb), (ts, tp, to, tb) = setup(arch, remat=False,
                                                 microbatches=2)
    hold(js(jp, jo, jb), ts(tp, to, tb), 1, {})


def test_int8_train_step_matches_reference():
    (js, jp, jo, jb), (ts, tp, to, tb) = setup("lwm-7b", remat=False,
                                                 grad_compression="int8")
    hold(js(jp, jo, jb), ts(tp, to, tb), 1, {}, int8=True)
