"""The port's checkpointer and training entry against the JAX package's,
on the CPU.

Mirrors ``tests/test_checkpoint.py`` (roundtrip, atomicity, async,
retention, the restart loop, this time bit for bit), then holds the layout
on disk to the JAX package's: the same files and manifest keys for one
state, and a step directory written by either package restored by the
other, whose training goes on from it.  The two packages' train steps
agree only within float32 rounding, so a run resumed across packages is
held to the other package's unbroken run by ``tests/test_torch_train.py``'s
band rule for parameters (1e-4 of the leaf's largest magnitude plus 1% of
Σlr; 2·Σlr more where a step's gradient was non-zero but within 2e-4 of
zero, fewer than 1 in 1,000 elements needing it) and AdamW's moments
normwise within 1e-4 a leaf.  A run resumed within the port equals its
unbroken run byte for byte, through ``launch.train`` too.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adamw as JA
from repro.train import steps as JS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import train
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as TA
from repro_torch.train import steps as TS
from torch_process_state import leaked_state

TOL = 1e-4
FIELDS = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, vocab=64, dtype="float32",
              remat="none")
CFG, JCFG = ModelConfig(**FIELDS), JModelConfig(**FIELDS)
OPT = TA.AdamWConfig(lr=1e-3, warmup=0)


def state_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g), "b": torch.zeros((16,))},
        "opt": {"step": torch.tensor(7, dtype=torch.int32), "m": {"w": torch.ones((8, 16))}},
    }


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [np.asarray(tree)]


def assert_same_bits(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


class TestRoundtrip:
    def test_save_restore_exact(self, tmp_path):
        ck = Checkpointer(tmp_path, async_mode=False)
        st = state_tree()
        ck.save(3, st)
        assert_same_bits(ck.restore(st), st)

    def test_latest_step_selection(self, tmp_path):
        ck = Checkpointer(tmp_path, async_mode=False)
        st = state_tree()
        for s in (1, 5, 9):
            ck.save(s, st)
        assert ck.latest_step() == 9
        assert ck.all_steps() == [1, 5, 9]

    def test_restore_specific_step(self, tmp_path):
        ck = Checkpointer(tmp_path, async_mode=False, keep=10)
        st1 = state_tree(0)
        st2 = state_tree(1)
        ck.save(1, st1)
        ck.save(2, st2)
        got = ck.restore(st1, step=1)
        np.testing.assert_array_equal(got["params"]["w"], st1["params"]["w"].numpy())


class TestAtomicity:
    def test_tmp_dirs_never_visible(self, tmp_path):
        ck = Checkpointer(tmp_path, async_mode=False)
        ck.save(1, state_tree())
        assert not list(tmp_path.glob("*.tmp"))

    def test_shape_mismatch_rejected(self, tmp_path):
        ck = Checkpointer(tmp_path, async_mode=False)
        st = state_tree()
        ck.save(1, st)
        bad = {"params": {"w": torch.zeros((4, 4)), "b": torch.zeros((16,))}, "opt": st["opt"]}
        with pytest.raises(ValueError, match="shape mismatch"):
            ck.restore(bad)

    def test_same_step_resave_keeps_the_committed_copy(self, tmp_path):
        ck = Checkpointer(tmp_path, async_mode=False)
        ck.save(2, state_tree(0))
        ck.save(2, state_tree(1))
        np.testing.assert_array_equal(ck.restore(state_tree())["params"]["w"], state_tree(0)["params"]["w"].numpy())
        assert not list(tmp_path.glob("*.tmp"))


class TestAsyncAndRetention:
    def test_async_save_then_restore(self, tmp_path):
        ck = Checkpointer(tmp_path, async_mode=True)
        st = state_tree()
        ck.save(4, st)
        ck.wait()
        got = ck.restore(st)
        np.testing.assert_array_equal(got["opt"]["step"], 7)

    def test_async_save_copies_before_returning(self, tmp_path):
        """The host copy is taken inside ``save``: an in-place update of the
        state right after it does not reach the file."""
        ck = Checkpointer(tmp_path, async_mode=True)
        st = state_tree()
        want = st["params"]["w"].clone()
        ck.save(1, st)
        st["params"]["w"].add_(1.0)
        np.testing.assert_array_equal(ck.restore(st)["params"]["w"], want.numpy())

    def test_async_error_surfaces_on_the_next_call(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck", async_mode=True)
        (tmp_path / "ck").rmdir()
        (tmp_path / "ck").write_text("not a directory")
        ck.save(1, state_tree())
        ck.wait()
        with pytest.raises(RuntimeError, match="async checkpoint write failed"):
            ck.check()
        ck.check()  # raised once

    def test_retention_keeps_newest_k(self, tmp_path):
        ck = Checkpointer(tmp_path, async_mode=False, keep=2)
        st = state_tree()
        for s in range(5):
            ck.save(s, st)
        assert ck.all_steps() == [3, 4]

    def test_restart_resumes_training(self, tmp_path):
        """Train, checkpoint, 'crash', restore, continue: the stream is pure
        in (seed, step), so the resumed run's state equals the unbroken
        run's bit for bit."""
        stream = TokenStream(vocab=CFG.vocab, global_batch=2, seq_len=16, seed=1)
        step_fn = TS.make_train_step(CFG, OPT, loss_chunk=16)

        def run(n0, n1, state):
            for s in range(n0, n1):
                state, _ = step_fn(state, {k: torch.from_numpy(v).long() for k, v in stream.batch_at(s).items()})
            return state

        ref = run(0, 6, TS.materialize_state(CFG, device="cpu"))
        ck = Checkpointer(tmp_path, async_mode=False)
        st = run(0, 3, TS.materialize_state(CFG, device="cpu"))
        ck.save(3, convert.state_to_reference(CFG, st))
        del st  # "crash"
        restored = convert.state_from_reference(CFG, ck.restore(TS.train_state_specs(CFG)), "cpu")
        out = run(3, 6, restored)
        assert_same_bits(convert.state_to_reference(CFG, out), convert.state_to_reference(CFG, ref))


def near_zero(grads: dict) -> dict:
    return {k: (g.abs() <= 2 * TOL * g.abs().max()) & (g != 0) for k, g in grads.items()}


def hold(got: dict, want: dict, band: dict, lr_sum: float) -> None:
    """Parameters by the band rule, the moments normwise (JAX-layout numpy
    trees of train states)."""
    used = n = 0
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(want["params"])[0],
                               jax.tree.leaves(got["params"]), jax.tree.leaves(band)):
        w = np.asarray(w)
        strict = TOL * float(np.abs(w).max()) + 1e-2 * lr_sum
        err = np.abs(g - w)
        np.testing.assert_array_less(err, np.where(b, strict + 2 * lr_sum, strict) * (1 + 1e-6) + 1e-30,
                                     err_msg=jax.tree_util.keystr(path))
        used, n = used + int((b & (err > strict)).sum()), n + w.size
    assert used * 1000 < n, (used, n)
    for k in ("m", "v"):
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want["opt"][k])[0],
                                jax.tree.leaves(got["opt"][k])):
            w = np.asarray(w)
            assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w), (k, jax.tree_util.keystr(path))
    assert int(np.asarray(got["opt"]["step"])) == int(np.asarray(want["opt"]["step"]))


class TestInterchange:
    STEPS, CUT = 6, 3

    def test_either_package_resumes_the_others_checkpoint(self, tmp_path, monkeypatch):
        """From one state (the JAX package's draw): the JAX package trains 3
        steps and saves, the port restores and trains 3 more, held to the
        JAX package's unbroken 6 steps; and the reverse, held to the port's
        unbroken 6."""
        stream = TokenStream(vocab=CFG.vocab, global_batch=2, seq_len=16, seed=1)
        jstep = jax.jit(JS.make_train_step(JCFG, JA.AdamWConfig(**OPT._asdict()), loss_chunk=16))
        tstep = TS.make_train_step(CFG, OPT, loss_chunk=16)
        band, real, lrs = {}, TS.adamw_update, []

        def grab(cfg, g, st, p):  # the union of the port's near-zero gradients
            for k, m in near_zero(g).items():
                band[k] = band[k] | m if k in band else m
            return real(cfg, g, st, p)

        monkeypatch.setattr(TS, "adamw_update", grab)

        def jrun(n0, n1, state):
            for s in range(n0, n1):
                state, met = jstep(state, {k: jnp.asarray(v) for k, v in stream.batch_at(s).items()})
                lrs.append(float(met["lr"]))
            return state

        def trun(n0, n1, state):
            for s in range(n0, n1):
                state, _ = tstep(state, {k: torch.from_numpy(v).long() for k, v in stream.batch_at(s).items()})
            return state

        j0 = JS.materialize_state(JCFG, jax.random.PRNGKey(0))
        host0 = jax.tree.map(np.asarray, j0)
        jref = jax.tree.map(np.asarray, jrun(0, self.STEPS, j0))
        tref = convert.state_to_reference(CFG, trun(0, self.STEPS, convert.state_from_reference(CFG, host0, "cpu")))
        lr_sum = sum(lrs)

        # the JAX package writes, the port resumes
        jck = JCheckpointer(tmp_path / "jax", async_mode=False)
        jck.save(self.CUT, jrun(0, self.CUT, jax.tree.map(jnp.asarray, host0)))
        ck = Checkpointer(tmp_path / "jax", async_mode=False)
        assert ck.latest_step() == self.CUT
        resumed = trun(self.CUT, self.STEPS,
                       convert.state_from_reference(CFG, ck.restore(TS.train_state_specs(CFG)), "cpu"))
        banded = convert.params_to_reference(CFG, band)
        hold(convert.state_to_reference(CFG, resumed), jref, banded, lr_sum)

        # the port writes, the JAX package resumes
        tck = Checkpointer(tmp_path / "torch", async_mode=True)
        tck.save(self.CUT, convert.state_to_reference(CFG, trun(0, self.CUT,
                                                                convert.state_from_reference(CFG, host0, "cpu"))),
                 wait=True)
        jck = JCheckpointer(tmp_path / "torch", async_mode=False)
        like = JS.materialize_state(JCFG, jax.random.PRNGKey(42))
        out = jax.tree.map(np.asarray, jrun(self.CUT, self.STEPS, jax.tree.map(jnp.asarray, jck.restore(like))))
        hold(out, tref, convert.params_to_reference(CFG, band), lr_sum)

    @pytest.mark.parametrize("kind", ["train", "gridlocal"])
    def test_both_packages_write_the_same_files(self, tmp_path, kind):
        """One state saved by each package: the same file names, manifest
        keys (with dtypes and shapes, in the same order) and file bytes."""
        cfg, jcfg = TC.reduced(TC.get("zamba2-1.2b")), JC.reduced(JC.get("zamba2-1.2b"))
        if kind == "train":
            jstate = JS.materialize_state(jcfg, jax.random.PRNGKey(1))
        else:
            jstate = JS.gridlocal_init(jcfg, jax.random.PRNGKey(1), 2)
        JCheckpointer(tmp_path / "jax", async_mode=False).save(5, jstate)
        tstate = convert.state_from_reference(cfg, jax.tree.map(np.asarray, jstate), "cpu")
        Checkpointer(tmp_path / "torch", async_mode=False).save(5, convert.state_to_reference(cfg, tstate))
        dirs = [tmp_path / side / "step_0000000005" for side in ("jax", "torch")]
        keys = [json.loads((d / "manifest.json").read_text())["keys"] for d in dirs]
        assert keys[0] == keys[1] and len(keys[0]) == len(jax.tree.leaves(jstate))
        files = [sorted(p.name for p in (d / "proc_00000").iterdir()) for d in dirs]
        assert files[0] == files[1]
        for name in files[0]:
            assert (dirs[0] / "proc_00000" / name).read_bytes() == (dirs[1] / "proc_00000" / name).read_bytes(), name
        specs = TS.train_state_specs(cfg, n_pods=2 if kind == "gridlocal" else 0)
        back = convert.state_from_reference(cfg, Checkpointer(tmp_path / "jax").restore(specs), "cpu")
        assert_same_bits(convert.state_to_reference(cfg, back), jax.tree.map(np.asarray, jstate))


class TestTrainEntry:
    ARGS = ["--reduced", "--device", "cpu", "--seq-len", "16", "--ckpt-every", "3"]

    @pytest.fixture(autouse=True)
    def clean_process(self):
        """The entry trains on the default group it finds and prints its
        size: state an earlier test left in this process fails here, by
        name, rather than as a wrong line or file below."""
        found = leaked_state()
        assert not found, f"an earlier test left process state behind: {'; '.join(found)}"

    def test_resumed_equals_unbroken(self, tmp_path, capsys):
        """``--steps 6`` unbroken against ``--steps 3`` then ``--steps 6
        --resume``: the two ``step_0000000006`` directories hold the same
        ``.npy`` files byte for byte, and the printed lines say what the
        JAX package's entry says."""
        train.main([*self.ARGS, "--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
        unbroken = capsys.readouterr().out
        train.main([*self.ARGS, "--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
        train.main([*self.ARGS, "--steps", "6", "--ckpt-dir", str(tmp_path / "b"), "--resume"])
        resumed = capsys.readouterr().out
        assert "[train] resumed from step 3" in resumed
        assert unbroken.count("[train] checkpoints: [3, 6]") == 1 and "[train] checkpoints: [3]" in resumed
        a, b = (tmp_path / d / "step_0000000006" / "proc_00000" for d in ("a", "b"))
        names = sorted(p.name for p in a.iterdir())
        assert names == sorted(p.name for p in b.iterdir()) and len(names) > 10
        assert all((a / n).read_bytes() == (b / n).read_bytes() for n in names)

    def test_printed_lines(self, tmp_path, capsys):
        """The lines ``repro.launch.train`` prints, in its formats (the JAX
        entry itself cannot run on this host's jax: its sharded gather
        raises jax's ShardingTypeError, as the seed's dry run does)."""
        train.main(["--reduced", "--device", "cpu", "--seq-len", "16", "--steps", "2", "--ckpt-every", "1",
                    "--ckpt-dir", str(tmp_path)])
        lines = capsys.readouterr().out.splitlines()
        step = r"\[train\] step +{} loss \d+\.\d{{4}} lr \d\.\d\de[-+]\d\d gnorm \d+\.\d{{3}} \(\d+\.\d\ds/step\)"
        want = [r"\[train\] stablelm-1\.6b-reduced: 0\.15M params on 1 device\(s\)", step.format(0), step.format(1),
                r"\[train\] checkpoints: \[1, 2\]"]
        assert len(lines) == len(want) and all(re.fullmatch(w, line) for w, line in zip(want, lines)), lines
