"""A closed loop of the program's scoring: ``forward_train(...,
return_hidden=True)`` under ``torch.inference_mode()``, then
``chunked_softmax_ce``, as the program's scoring runs it; every call a
fresh batch from the seed.

The mix's ``judge`` calls, drawn from the seed over all the calls of the
window (``traffic.Reservoir``), keep their outputs (the last hidden
states and the mean loss); once the window has closed the reference
scores the same batches: ``hidden``, the worst row's relative error of the
hidden states, and ``ce``, the widest gap of a batch's mean loss (nats).
"""

from __future__ import annotations

import torch

from portbench import lm, roofline, traffic, weights
from portbench.manifest import reference_module


class Entry:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.m = cell.config["model"]
        self.ref = reference_module(cell.config["reference"])
        self.shapes = self.ref.param_shapes(self.m)
        self.stream = traffic.stream(cell.config, cell.mix, seed)
        b, s = int(cell.mix["batch"]), int(cell.mix["seq_len"])
        self.tokens_per_call = b * s
        self.flops_per_call = roofline.score_flops(self.m, b, s)
        self.judged = traffic.Reservoir(seed, int(cell.mix["judge"]))
        self.calls = 0
        self.kept: dict[int, tuple] = {}

    def setup(self) -> None:
        from repro_torch.models import transformer as T
        from repro_torch.train.losses import chunked_softmax_ce

        cfg = lm.model_config(self.cell.config, self.cell.mix.get("flags"))
        model = lm.load_model(cfg, weights.make(self.shapes, self.seed, self.device), self.device)

        def score(batch):
            with torch.inference_mode():
                hidden, _ = T.forward_train(cfg, model, batch["tokens"], return_hidden=True)
                ce, _ = chunked_softmax_ce(cfg, model, hidden, batch["labels"])
            return hidden, ce

        self.score = score
        for i in range(int(self.cell.mix.get("warmup_calls", 1))):
            score(lm.on_device(self.stream.batch_at(2**40 + i), self.device))

    def call(self) -> None:
        i = self.calls
        self.calls += 1
        out = self.score(lm.on_device(self.stream.batch_at(i), self.device))
        if self.judged.offer(i):
            self.kept = {j: self.kept.get(j, out) for j in self.judged.indices}

    def judge_without_calls(self, calls: int) -> None:
        """Draw the judged calls as a window of ``calls`` calls would, none
        made: the control judges the batches that the program would."""
        for i in range(calls):
            self.judged.offer(i)

    def close(self) -> None:
        self.score = None

    def program(self) -> list:
        return [self.kept.get(i) for i in self.judged.indices]

    def reference(self, precision: str) -> list:
        from portbench.reference import precision as prec

        prec.no_tf32()
        w = weights.make(self.shapes, self.seed, self.device)
        mm = prec.matmul(precision)
        out = []
        for i in self.judged.indices:
            batch = lm.on_device(self.stream.batch_at(i), self.device)
            out.append(self.ref.score(self.m, w, batch["tokens"], batch["labels"], mm))
        del w
        return out

    @staticmethod
    def numbers(a: list, b: list) -> dict[str, float]:
        hidden, ce = [], []
        for got, want in zip(a, b):
            if got is None:
                return {"hidden": float("inf"), "ce": float("inf")}
            hidden.append(lm.rows_rel(got[0].float(), want[0]))
            ce.append(abs(float(got[1]) - float(want[1])))
        return {"hidden": lm.worst(hidden), "ce": lm.worst(ce)}
