"""Training entry, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --reduced \
        --steps 20 --ckpt-dir /tmp/ck

    # n ranks, one card each (NCCL), or n CPU processes with --device cpu (gloo)
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node N \
        -m repro_torch.launch.train --arch stablelm-1.6b --reduced --steps 20 --ckpt-dir /tmp/ck

The port of ``repro.launch.train``, with its arguments and printed lines
and one more, ``--device`` (the card by default; ``cpu`` runs the same
path on the CPU).  The JAX entry trains on a ``(devices, 1)`` mesh of
axes ``("data", "model")`` by the ``BASELINE`` rules: its state stays
replicated, and only the batch (and the activations the rules constrain)
splits over ``data``.  Here each device is a rank of the default
``torch.distributed`` group: the group the process already has (a
caller's, never the fake backend's of a dry run), else one made here and
destroyed at the end (gloo on the CPU, NCCL on the card), of the ranks
``torch.distributed.run`` started (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), or of this one process.  Each rank takes card ``LOCAL_RANK``; a single card runs a
one-rank mesh.  The state is placed by ``train.steps.replicate_state``
and the step runs inside ``sharding.activate(mesh, BASELINE)``; every
rank draws the whole batch, ``TokenStream.batch_at``, and
``data.pipeline.place_batch`` keeps its block of rows.  Rank 0 prints the
JAX entry's lines and the others print nothing, since the ranks stand
for the JAX package's one process.

A deterministic, restartable data stream; checkpoints every
``--ckpt-every`` steps and at the end, in the JAX package's layout
(``convert.state_to_reference``), committed once by rank 0
(``Checkpointer``); ``--resume`` continues from the latest step on any
number of ranks.  The learning-rate schedule decays over ``max(--steps,
10)`` steps, so a resumed run passes the ``--steps`` of the run it
continues (or both stay at 10 or fewer) to repeat it exactly.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import TokenStream, place_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import reduced as reduce_cfg
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import BASELINE, MeshShape, activate, full
from repro_torch.train.steps import make_train_step, materialize_state, replicate_state, train_state_specs


def _ids_as_int64(batch: dict) -> dict:
    """A host batch as tensors: token ids as int64, embeddings as they are."""
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v) for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where training runs: the CUDA card by default; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    made_group = not dist.is_initialized()
    if not made_group and dist.get_backend() == "fake":
        raise RuntimeError("the process's default group is the fake backend's (a dry run's count made it): its "
                           "collectives move nothing, so the entry does not train on it")
    if made_group:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:  # torch.distributed.run's rendezvous
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        _train(args, dev)
    finally:
        if made_group:
            dist.destroy_process_group()


def _train(args, dev: torch.device) -> None:
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    n_dev = dist.get_world_size()
    mesh = make_device_mesh(MeshShape(("data", "model"), (n_dev, 1)), dev.type)
    rules = BASELINE
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)

    say(f"[train] {cfg.name}: {T.param_count(cfg) / 1e6:.2f}M params on {n_dev} device(s)")
    stream = TokenStream(
        vocab=cfg.vocab, global_batch=args.global_batch, seq_len=args.seq_len, seed=0,
        frontend_len=cfg.frontend_len if cfg.frontend != "none" else 0, d_model=cfg.d_model,
    )
    opt_cfg = AdamWConfig(lr=args.lr, warmup=5, decay_steps=max(args.steps, 10))

    with activate(mesh, rules):
        step_fn = make_train_step(cfg, opt_cfg, loss_chunk=min(512, args.seq_len), grad_accum=args.grad_accum)

        start = 0
        ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
        if ck and args.resume and ck.latest_step() is not None:
            start = ck.latest_step()
            state = convert.state_from_reference(cfg, ck.restore(train_state_specs(cfg)), dev)
            say(f"[train] resumed from step {start}")
        else:
            state = materialize_state(cfg, device=dev)
        state = replicate_state(cfg, state, mesh)

        def save(step: int, wait: bool = False) -> None:  # the state is rank 0's to copy
            ck.save(step, convert.state_to_reference(cfg, state) if ck.writer else None, wait=wait)

        t0 = time.time()
        for step in range(start, args.steps):
            batch = place_batch(_ids_as_int64(stream.batch_at(step)), mesh, rules)
            state, metrics = step_fn(state, batch)
            if step % 5 == 0 or step == args.steps - 1:
                loss, lr, gnorm = (float(full(metrics[k])) for k in ("loss", "lr", "grad_norm"))
                say(
                    f"[train] step {step:5d} loss {loss:.4f} "
                    f"lr {lr:.2e} gnorm {gnorm:.3f} "
                    f"({(time.time() - t0) / max(step - start + 1, 1):.2f}s/step)"
                )
            if ck and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
        if ck:
            save(args.steps, wait=True)
            say(f"[train] checkpoints: {ck.all_steps()}")


if __name__ == "__main__":
    main()
