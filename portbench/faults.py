"""Faults planted under an entry's timed path, to show that the comparison
that decides ``correct`` catches them.  Each takes a set-up-ready entry
(before ``setup``) and wraps what its calls produce:

  unchanged   a step returns its state unchanged (train: the parameters
              and moments put back after each step)
  half        half of the batch left out: the first half of the rows run,
              the mean taken over them; the other rows' outputs are zeros
  altered     an answer altered where it is produced (train: each step's
              loss reported 1% high; scoring: row 0 answered with row 1's
              output)

One chip has no exchange between chips to leave out.  Used by the CPU
tests and by ``calibrate.py`` for the readings on the card.
"""

from __future__ import annotations

import torch

NAMES = ("unchanged", "half", "altered")


def plant(entry, fault: str) -> None:
    kind = type(entry).__module__.rsplit(".", 1)[-1]
    getattr(_Planted, f"{kind}_{fault}")(entry)


def _half_batch(batch: dict) -> dict:
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def _zero_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, *t.shape[1:]), dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


class _Planted:
    # ---- train ------------------------------------------------------------
    @staticmethod
    def train_unchanged(entry):
        real = entry.call

        def call():
            params = dict(entry.state["params"].named_parameters())
            keep = {n: p.detach().clone() for n, p in params.items()}
            opt = entry.state["opt"]
            before = {"step": opt["step"].clone(),
                      **{k: {n: t.clone() for n, t in opt[k].items()} for k in ("m", "v")}}
            met = real()
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(keep[n])
            entry.state["opt"] = before
            return met

        entry.call = call

    @staticmethod
    def train_half(entry):
        from portbench import lm

        def call():
            batch = lm.on_device(_half_batch(entry.stream.batch_at(entry.calls)), entry.device)
            entry.calls += 1
            entry.state, met = entry.step(entry.state, batch)
            return met

        entry.call = call

    @staticmethod
    def train_altered(entry):
        real_call = entry.call

        def call():
            met = real_call()
            return {**met, "loss": met["loss"] * 1.01}

        entry.call = call

    # ---- score ------------------------------------------------------------
    @staticmethod
    def score_half(entry):
        real_setup = entry.setup

        def setup():
            real_setup()
            real = entry.score

            def score(batch):
                n = batch["tokens"].shape[0]
                hidden, ce = real(_half_batch(batch))
                return _zero_rows(hidden, n), ce

            entry.score = score

        entry.setup = setup

    @staticmethod
    def score_altered(entry):
        real_setup = entry.setup

        def setup():
            real_setup()
            real = entry.score

            def score(batch):
                hidden, ce = real(batch)
                hidden = hidden.clone()
                hidden[0] = hidden[1]
                return hidden, ce

            entry.score = score

        entry.setup = setup
