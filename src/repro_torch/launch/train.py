"""Training driver: real train steps of a reduced config through the port's
`launch/steps.make_train_step` (on the card every attention layer's forward
and backward runs K4), with checkpoint and resume.  The counterpart of
`repro/launch/train.py`: the same flags plus ``--device``, the same reduced
config, the same fixed batch from ``np.random.default_rng(seed)`` and the
same exit code (0 when the last step's loss is below the first's).

  PYTHONPATH=src python -m repro_torch.launch.train --arch lwm-7b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu ...

``--device`` is ``cuda`` by default (it raises without a CUDA device) and
``cpu`` where the caller names it.  The initial parameters come from
`convert.init_params` on a `torch.Generator` seeded with ``--seed``.
``--checkpoint`` / ``--resume`` use the reference's pickle layout,
``{"params", "opt": {"m", "v", "step"}, "step"}`` as nested dicts of numpy
arrays, so a checkpoint written by the reference CLI resumes here.
"""
from __future__ import annotations

import argparse
import pickle
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lwm-7b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", default=None, choices=[None, "int8"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.transformer import torch_dtype

    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    model, train_step = steps_lib.make_train_step(
        cfg, None, lr=args.lr, grad_compression=args.grad_compression,
        remat=False, loss_chunk=64, device=dev,
    )
    params = convert.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt = steps_lib.init_opt_state(params)
    start = 0
    if args.resume:
        with open(args.resume, "rb") as f:
            ckpt = pickle.load(f)
        params = convert.params_from_numpy(cfg, ckpt["params"], device=dev)
        opt = convert.opt_state_from_numpy(cfg, ckpt["opt"], device=dev)
        start = ckpt["step"]
        print(f"resumed from {args.resume} at step {start}")

    rng = np.random.default_rng(args.seed)
    b, s = args.batch, args.seq
    dt = torch_dtype(cfg.dtype)

    def make_batch():
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
        batch = {
            "tokens": torch.as_tensor(toks[:, :-1], device=dev),
            "labels": torch.as_tensor(toks[:, 1:], device=dev),
        }
        if cfg.frontend == "patch_stub":
            batch["patch_embeds"] = torch.as_tensor(
                rng.normal(size=(b, cfg.n_frontend_tokens, cfg.d_model)) * 0.05
            ).to(dev, dt)
            batch["labels"] = torch.as_tensor(
                np.concatenate(
                    [np.full((b, cfg.n_frontend_tokens), -1), toks[:, 1:]], axis=1
                ), device=dev)
        if cfg.frontend == "audio_stub":
            batch["frames"] = torch.as_tensor(
                rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)) * 0.05
            ).to(dev, dt)
        return batch

    # a FIXED batch, as the reference: fresh iid-uniform tokens every step
    # have no learnable structure, so "loss decreases" would be a coin flip
    batch = make_batch()
    t0 = time.time()
    losses = []
    for i in range(start, start + args.steps):
        params, opt, m = train_step(params, opt, batch)
        losses.append(float(m["loss"]))
        print(f"step {i}: loss={losses[-1]:.4f} gnorm={float(m['grad_norm']):.3f}")
    el = time.time() - t0
    print(f"{args.steps} steps in {el:.1f}s; loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    if args.checkpoint:
        with open(args.checkpoint, "wb") as f:
            pickle.dump(
                {
                    "params": convert.params_to_numpy(params),
                    "opt": convert.opt_state_to_numpy(opt),
                    "step": start + args.steps,
                },
                f,
            )
        print(f"checkpointed to {args.checkpoint}")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    sys.exit(main())
