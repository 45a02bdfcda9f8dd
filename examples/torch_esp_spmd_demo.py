"""ESP SPMD demo on the PyTorch port: the serving engine running through the
MESH EXECUTOR on a world of processes, one rank per elastic instance
coordinate (the counterpart of `examples/esp_spmd_demo.py`).

The DoP>1 packed ring prefill runs as one SPMD program (each instance owns
its KV stripe on its own rank, stripes rotating over `ops.ring_ppermute`,
double-buffered against the chunk folds), followed by batch-sharded SPMD
multi-master paged decode (each rank runs the non-attention stack for its
B/n batch slice, each layer's LSE-merge an all_gather(q) + pmax +
psum_scatter schedule) — validated token-for-token against the serial
dense oracle on every rank.

``--device cpu`` spawns a gloo world of CPU processes (8 by default: DoP 4
x "model" 2, as the reference's 8 host devices); ``--device cuda`` (the
default) spawns one NCCL rank per card (DoP = the number of cards, at most
4; a single card runs DoP 1, where the ring is one K1 launch).

  PYTHONPATH=src python examples/torch_esp_spmd_demo.py [--device cpu] [--world 8]
"""
import argparse
import os
import pathlib
import sys
import tempfile
import warnings

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import numpy as np

N_DECODE = 3
LENGTHS = [65, 17, 120, 48, 33, 80]


def rank_main(rank, world, device, init):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.convert import init_params
    from repro_torch.engine.request import Phase, Request
    from repro_torch.engine.server import LoongServeEngine
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import serial_decode_oracle
    from repro_torch.launch.mesh import init_process_group, make_test_mesh
    from repro_torch.launch.steps import tree_map
    from repro_torch.manager.scheduler import PrefillBatch
    from repro_torch.models import build_model

    # torch.distributed's deprecation notes on the collectives `ops` calls
    warnings.filterwarnings("ignore", category=FutureWarning)
    if device == "cpu":
        torch.set_num_threads(1)
    init_process_group(device, init_method=f"file://{init}",
                       world_size=world, rank=rank)
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device == "cuda" else torch.device("cpu")
        dop = min(4, world)
        cfg = reduced(REGISTRY["lwm-7b"])
        model = build_model(cfg, device=dev)
        # the same parameters on every rank: a seeded draw on the CPU, moved
        params = tree_map(lambda t: t.to(dev), init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        mesh = make_test_mesh(data=dop, model=world // dop, device=device)
        eng = LoongServeEngine(cfg, dop, 4000, store_values=True, model=model,
                               params=params, page_size=16, mesh=mesh,
                               device=dev)
        say = print if rank == 0 else (lambda *a, **k: None)
        say(f"executor: {type(eng.executor).__name__} on mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}; world "
            f"{world} ({dist.get_backend()})")

        # one DoP ESP prefill batch with scheduler-reserved striped placement
        rng = np.random.default_rng(23)
        reqs, placement = [], {}
        for j, ln in enumerate(LENGTHS):
            r = Request(input_len=ln, max_new_tokens=N_DECODE + 1,
                        prompt=rng.integers(0, cfg.vocab_size, ln).tolist())
            r.rid, r.phase = j, Phase.PREFILL
            eng._req_index[r.rid] = r
            plan = eng.pool.plan_placement(r.rid, list(range(ln)), range(dop))
            eng.pool.place(plan)  # reserve slots; the ring pass fills them
            placement[r.rid] = plan.assignment
            reqs.append(r)
        batch = PrefillBatch(reqs, list(range(dop)),
                             scale_down_to=list(range(dop)),
                             placement=placement)
        for pool in eng.pool.pools:  # pre-create mirrors to expose the invariant
            if pool.mirror_here:
                pool.device_kv()
                pool.mirror_uploaded_slots = 0

        ops.reset_dispatch_counts()
        eng._on_prefill_done(batch)  # SPMD ring prefill + decode transition
        d = dict(ops.dispatch_counts)
        assert d.get("prefill_serial_model", 0) == 0, d
        assert d.get("prefill_ring_replay", 0) == 0, d
        if dop > 1:
            assert d.get("prefill_ring_spmd", 0) >= 1, d
        legs = d.get("ring_ppermute", 0)
        say(f"ring prefill: {d.get('prefill_ring_chunk', 0)} chunk folds, "
            f"{legs} ppermute legs, "
            f"{ops.comm_bytes.get('ring_ppermute', 0) // max(legs, 1)} "
            "bytes/leg; zero serial + zero in-process replay")
        uploads = sum(p.mirror_uploaded_slots for p in eng.pool.pools)
        assert uploads == 0, uploads
        say("write-through: 0 mirror slots re-uploaded (KV landed on each "
            "instance's own rank during the ring pass)")

        ops.reset_dispatch_counts()
        eng._push(eng.clock, "join", 0)  # kick the scheduler; decode to finish
        m = eng.run()
        assert len(m.finished) == len(reqs)
        d = dict(ops.dispatch_counts)
        assert d.get("decode_merge_loop", 0) == 0, d  # no per-shard loop
        assert d.get("decode_iteration_spmd", 0) >= 1, d
        if dop > 1:
            assert d.get("paged_decode_sharded", 0) >= 1, d
            assert d.get("psum_scatter", 0) >= 1, d
        say(f"spmd decode: {d.get('paged_decode_sharded', 0)} batch-sharded "
            f"LSE-merges ({ops.comm_bytes.get('psum_scatter', 0)} "
            f"psum_scatter + {ops.comm_bytes.get('all_gather', 0)} "
            "all_gather bytes), zero per-shard loop merges")

        # token-exact vs the serial dense oracle (prefill + N_DECODE decodes)
        with torch.no_grad():
            for r in reqs:
                want = serial_decode_oracle(model, params, r.prompt, N_DECODE)
                assert want == list(r.output_tokens), (rank, r.rid, want,
                                                       r.output_tokens)
        say(f"token parity: {len(reqs)} requests x {N_DECODE + 1} tokens "
            f"== serial dense oracle on each of {world} ranks")
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda by default (NCCL, one rank per card; raises "
                         "without a card); cpu (gloo) must be named")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (cpu: 8; cuda: the number of cards)")
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    from repro_torch.device import resolve_device

    resolve_device(args.device)
    world = args.world or (8 if args.device == "cpu"
                           else torch.cuda.device_count())
    if args.device == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"--world {world} > {torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(world, args.device,
                                  os.path.join(tmp, "rendezvous")),
                 nprocs=world, join=True)
    print("OK")


if __name__ == "__main__":
    main()
