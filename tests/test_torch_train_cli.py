"""The port's train CLI (`python -m repro_torch.launch.train`) in
subprocesses on the CPU: the loss falls with and without int8 gradient
compression, the default device is the card, and a checkpoint written by
the reference CLI resumes in the port and continues as the reference's own
resume does (losses within 1e-4: the same f32 steps in another framework).
"""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _run(mod, args, timeout=300):
    # one intra-op thread: the reduced config gains nothing from more, and
    # under a multi-worker test run they only contend
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", mod] + args, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _losses(stdout):
    return [float(x) for x in re.findall(r"^step \d+: loss=([0-9.]+)", stdout, re.M)]


@pytest.mark.parametrize("extra", [[], ["--grad-compression", "int8"]])
def test_port_train_cli_loss_falls(extra):
    out = _run("repro_torch.launch.train", ["--device", "cpu", "--arch", "lwm-7b",
                                            "--steps", "5", "--batch", "2",
                                            "--seq", "48"] + extra)
    assert out.returncode == 0, out.stdout + out.stderr  # rc != 0: loss rose
    losses = _losses(out.stdout)
    assert len(losses) == 5 and losses[-1] < losses[0], losses


def test_port_train_cli_needs_a_card_by_default():
    pytest.importorskip("jax")  # the file runs where the reference runs: no card
    out = _run("repro_torch.launch.train", ["--steps", "1", "--batch", "1",
                                            "--seq", "8"])
    assert out.returncode != 0 and "CUDA" in out.stderr, out.stderr


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference CLI trains 3 steps and checkpoints; the port resumes it
    for 3 more; the reference's own resume of the same checkpoint gives the
    same losses within 1e-4."""
    pytest.importorskip("jax")
    ckpt = tmp_path / "ref.pkl"
    common = ["--arch", "lwm-7b", "--batch", "2", "--seq", "32", "--steps", "3"]
    out = _run("repro.launch.train", common + ["--checkpoint", str(ckpt)])
    assert out.returncode == 0, out.stdout + out.stderr
    ref = _run("repro.launch.train", common + ["--resume", str(ckpt)])
    port = _run("repro_torch.launch.train",
                common + ["--resume", str(ckpt), "--device", "cpu",
                          "--checkpoint", str(tmp_path / "port.pkl")])
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert port.returncode == 0, port.stdout + port.stderr
    assert "resumed from" in port.stdout and "at step 3" in port.stdout
    want, got = _losses(ref.stdout), _losses(port.stdout)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 + 1e-9, (got, want)  # both printed to 4 places
    # the port's checkpoint keeps the reference's layout
    import pickle

    with open(tmp_path / "port.pkl", "rb") as f:
        saved = pickle.load(f)
    assert saved["step"] == 6 and int(saved["opt"]["step"]) == 6
    assert set(saved) == {"params", "opt", "step"}
    assert set(saved["opt"]) == {"m", "v", "step"}
