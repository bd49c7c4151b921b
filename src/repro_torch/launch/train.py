"""Training entry, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --reduced \
        --steps 20 --ckpt-dir /tmp/ck

The port of ``repro.launch.train``, with its arguments and printed lines
and one more, ``--device`` (the card by default; ``cpu`` runs the same
path on the CPU).  One device, so no mesh and no sharding rules: this
process's ``TokenStream.host_batch_at`` is the whole batch.  A
deterministic, restartable data stream; checkpoints every
``--ckpt-every`` steps and at the end, in the JAX package's layout
(``convert.state_to_reference``); ``--resume`` continues from the latest
step.  The learning-rate schedule decays over ``max(--steps, 10)`` steps,
so a resumed run passes the ``--steps`` of the run it continues (or both
stay at 10 or fewer) to repeat it exactly.
"""

from __future__ import annotations

import argparse
import time

import torch

import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import reduced as reduce_cfg
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import make_train_step, materialize_state, train_state_specs


def _on(batch: dict, device: torch.device) -> dict:
    """A host batch on ``device``: token ids as int64, embeddings as they are."""
    return {k: (torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)).to(device)
            for k, v in batch.items()}


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
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)

    print(f"[train] {cfg.name}: {T.param_count(cfg) / 1e6:.2f}M params on 1 device(s)")
    stream = TokenStream(
        vocab=cfg.vocab, global_batch=args.global_batch, seq_len=args.seq_len, seed=0,
        frontend_len=cfg.frontend_len if cfg.frontend != "none" else 0, d_model=cfg.d_model,
    )
    opt_cfg = AdamWConfig(lr=args.lr, warmup=5, decay_steps=max(args.steps, 10))
    step_fn = make_train_step(cfg, opt_cfg, loss_chunk=min(512, args.seq_len), grad_accum=args.grad_accum)

    start = 0
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and args.resume and ck.latest_step() is not None:
        start = ck.latest_step()
        state = convert.state_from_reference(cfg, ck.restore(train_state_specs(cfg)), dev)
        print(f"[train] resumed from step {start}")
    else:
        state = materialize_state(cfg, device=dev)

    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, _on(stream.host_batch_at(step), dev))
        if step % 5 == 0 or step == args.steps - 1:
            print(
                f"[train] step {step:5d} loss {float(metrics['loss']):.4f} "
                f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.3f} "
                f"({(time.time() - t0) / max(step - start + 1, 1):.2f}s/step)"
            )
        if ck and (step + 1) % args.ckpt_every == 0:
            ck.save(step + 1, convert.state_to_reference(cfg, state))
    if ck:
        ck.save(args.steps, convert.state_to_reference(cfg, state), wait=True)
        print(f"[train] checkpoints: {ck.all_steps()}")


if __name__ == "__main__":
    main()
