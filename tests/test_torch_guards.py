"""Guards on the port: what it imports, where its entry points run, and
the CUDA kernels themselves where a card exists.

This file imports torch and the port only (no jax), so it also runs on a
machine with a card: ``python -m pytest -q -m cuda tests/test_torch_guards.py``
runs the kernel checks there, which skip on a host without CUDA.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.runtime import GridRuntime

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

IMPORT_EVERYTHING = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), "modules;", "leaked:", bad)
assert not bad, bad
for name in ("repro_torch.models.attention", "repro_torch.train.losses", "repro_torch.configs.gemma2",
             "repro_torch.configs.phi3_mini", "repro_torch.configs.stablelm", "repro_torch.configs.granite",
             "repro_torch.launch.serve", "repro_torch.runtime.cache", "repro_torch.workflow.requests",
             "repro_torch.compat", "repro_torch.launch.mesh", "repro_torch.runtime.backends",
             "repro_torch.runtime.conformance"):
    assert name in names, name
"""


def test_port_imports_neither_jax_nor_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(SRC)
    p = subprocess.run(
        [sys.executable, "-c", IMPORT_EVERYTHING], capture_output=True, text=True, env=env, timeout=300
    )
    assert p.returncode == 0, p.stdout + p.stderr
    assert "leaked: []" in p.stdout


def test_runtime_defaults_to_the_card():
    if torch.cuda.is_available():
        assert GridRuntime().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            GridRuntime()


def test_conformance_child_defaults_to_the_card(monkeypatch):
    """With no card and no ``--device cpu`` the multi-host conformance
    child fails before it joins any process group."""
    import torch.distributed as dist

    from repro_torch.runtime.conformance import child_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        child_main(["--pid", "0", "--nprocs", "2", "--port", "1", "--sites", "3"])
    assert not dist.is_initialized()


def test_from_dense_defaults_to_the_card():
    from repro_torch.core.apriori import TransactionDB

    dense = np.eye(3, dtype=bool)
    if torch.cuda.is_available():
        assert TransactionDB.from_dense(dense).packed.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TransactionDB.from_dense(dense)


def test_kernels_build_inside_the_checkout(monkeypatch, tmp_path):
    """nvcc's output goes under the checkout's build/, or where the
    environment says; an installed copy with no checkout refuses to guess."""
    import importlib.util
    import shutil

    from repro_torch.kernels import _build

    root = os.path.abspath(os.path.join(SRC, ".."))
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    assert str(_build.build_dir()) == os.path.join(root, "build", "repro_torch_kernels")
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "k"))
    assert _build.build_dir() == tmp_path / "k"

    installed = tmp_path / "site-packages" / "repro_torch" / "kernels"
    installed.mkdir(parents=True)
    shutil.copy(_build.__file__, installed / "_build.py")
    spec = importlib.util.spec_from_file_location("_installed_build", installed / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.delenv(_build.BUILD_DIR_ENV)
    with pytest.raises(RuntimeError, match=_build.BUILD_DIR_ENV):
        mod.build_dir()


def test_kernel_target_hashes_the_headers_a_source_includes(monkeypatch, tmp_path):
    """The library's name carries a hash of its source and of every csrc
    header it includes: editing slstm_scan.cuh renames both sLSTM libraries;
    editing an unrelated source renames neither."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "out"))
    assert [p.name for p in _build._sources("slstm_scan_timed")] == ["slstm_scan_timed.cu", "slstm_scan.cuh"]
    names = ("slstm_scan", "slstm_scan_timed", "kmeans_assign")
    before = {n: _build._target(n).name for n in names}
    assert before["slstm_scan"] != before["slstm_scan_timed"]

    (csrc / "kmeans_assign.cu").write_text((csrc / "kmeans_assign.cu").read_text() + "\n// edited\n")
    after = {n: _build._target(n).name for n in names}
    assert after["slstm_scan"] == before["slstm_scan"] and after["slstm_scan_timed"] == before["slstm_scan_timed"]
    assert after["kmeans_assign"] != before["kmeans_assign"]

    (csrc / "slstm_scan.cuh").write_text((csrc / "slstm_scan.cuh").read_text() + "\n// edited\n")
    edited = {n: _build._target(n).name for n in names}
    assert edited["slstm_scan"] != before["slstm_scan"]
    assert edited["slstm_scan_timed"] != before["slstm_scan_timed"]
    assert edited["kmeans_assign"] == after["kmeans_assign"]


def test_flash_timed_build_comes_from_the_kernels_header(monkeypatch, tmp_path):
    """The float32 flash kernel's path build and its timed build both come
    from csrc/flash_attention.cuh (editing it renames both libraries), and
    only the timed source turns the phase timers on."""
    import re
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "out"))
    for name in ("flash_attention", "flash_attention_timed"):
        assert "flash_attention.cuh" in [p.name for p in _build._sources(name)]
    sets_timers = re.compile(r"^\s*#\s*define\s+FLASH_PHASE_TIMERS\b", re.MULTILINE)
    setters = sorted(p.name for p in csrc.glob("*.cu") if sets_timers.search(p.read_text()))
    assert setters == ["flash_attention_timed.cu"]
    before = {n: _build._target(n).name for n in ("flash_attention", "flash_attention_timed", "kmeans_assign")}
    assert before["flash_attention"] != before["flash_attention_timed"]
    (csrc / "flash_attention.cuh").write_text((csrc / "flash_attention.cuh").read_text() + "\n// edited\n")
    after = {n: _build._target(n).name for n in before}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["flash_attention_timed"] != before["flash_attention_timed"]
    assert after["kmeans_assign"] == before["kmeans_assign"]


def test_kmeans_floors_build_from_the_kernels_header(monkeypatch, tmp_path):
    """The floors library and the kernel's share csrc/kmeans_assign.cuh:
    editing it renames both libraries, so a measured floor is always the
    floor of the kernel beside it."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "out"))
    for name in ("kmeans_assign", "kmeans_assign_floors"):
        assert [p.name for p in _build._sources(name)] == [f"{name}.cu", "kmeans_assign.cuh"]
    before = {n: _build._target(n).name for n in ("kmeans_assign", "kmeans_assign_floors", "support_count")}
    (csrc / "kmeans_assign.cuh").write_text((csrc / "kmeans_assign.cuh").read_text() + "\n// edited\n")
    after = {n: _build._target(n).name for n in before}
    assert after["kmeans_assign"] != before["kmeans_assign"]
    assert after["kmeans_assign_floors"] != before["kmeans_assign_floors"]
    assert after["support_count"] == before["support_count"]


def test_measurement_wrappers_refuse_what_they_cannot_time():
    """The floors time the CUDA kernel only; the count stage checks vt's
    shape against the masks on every device."""
    xs, cs = torch.zeros((2, 10, 8)), torch.zeros((2, 3, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.kmeans_assign_floor(xs, cs, "load_only")
    tx = torch.zeros((2, 40, 3), dtype=torch.int32)
    masks = torch.zeros((2, 5, 3), dtype=torch.int32)
    vt = ops.vertical_bitmap(tx)
    assert tuple(vt.shape) == (2, 96, 2)
    with pytest.raises(ValueError, match="vt int32 of shape"):
        ops.support_count_vertical_sites(vt, masks, 70)
    with pytest.raises(ValueError, match="vt int32 of shape"):
        ops.support_count_vertical_sites(vt, masks[:, :, :2].contiguous(), 40)
    counts, flags = ops.support_count_vertical_sites(vt, masks, 40)
    assert flags is None and bool((counts == 40).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _rand_words(gen, shape, device):
    x = torch.randint(-(2**31), 2**31, shape, generator=gen, dtype=torch.int64)
    return (x | torch.randint(-(2**31), 2**31, shape, generator=gen, dtype=torch.int64)).to(
        torch.int32
    ).to(device)


def _sparse_masks(gen, s, c, w, device, items=2):
    """Masks of up to ``items`` random items (repeats merge), the first two
    all zero; with 40 items and W >= 3 some masks span many words."""
    masks = torch.zeros((s, c, w), dtype=torch.int64)
    bits = torch.randint(0, 32 * w, (s, c, items), generator=gen)
    for k in range(items):
        word, bit = bits[..., k] // 32, bits[..., k] % 32
        masks.scatter_(2, word[..., None], masks.gather(2, word[..., None]) | (1 << bit[..., None]))
    masks[:, :2] = 0  # all-zero masks count every row
    return masks.to(torch.int32).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,n,c,w,items",
    [(1, 700, 37, 1, 2), (4, 700, 37, 32, 2), (3, 513, 129, 5, 2), (2, 5000, 150, 8, 2), (2, 3000, 260, 16, 2),
     (4, 2000, 300, 32, 2), (2, 1, 9, 3, 2), (3, 33, 40, 32, 2), (2, 33, 40, 3, 40), (2, 700, 64, 32, 40),
     (3, 25_000, 18, 32, 3), (4, 25_000, 10_883, 32, 4)],
)
def test_cuda_kernels_match_plain_versions(cuda_device, s, n, c, w, items):
    """Every wrapper against the plain version, exactly: N = 1 and 33 (one
    row, and one past a 32-row word), dense masks of up to 40 items, the GFM
    recount's S 3 x C 18 (too few warps to fill the card, so the words are
    shared out and the counts added atomically) and level 4's size."""
    gen = torch.Generator().manual_seed(s * n + c + w)
    tx = _rand_words(gen, (s, n, w), cuda_device)
    masks = _sparse_masks(gen, s, c, w, cuda_device, items)
    mc = torch.tensor([1 + 97 * i for i in range(s)], dtype=torch.int32, device=cuda_device)
    ops.reset_launches()
    counts = ops.support_count_sites(tx, masks)
    pc, pf = ops.support_count_prune_sites(tx, masks, mc)
    one = ops.support_count(tx[0], masks[0])
    oc, of = ops.support_count_prune(tx[0], masks[0], 50)
    torch.cuda.synchronize()
    want = ref.support_count_sites_ref(tx, masks)
    assert torch.equal(counts, want) and torch.equal(pc, want)
    assert torch.equal(pf, want >= mc[:, None])
    assert torch.equal(one, want[0]) and torch.equal(oc, want[0]) and torch.equal(of, want[0] >= 50)
    support = ("support_count", "support_count_prune", "support_count_sites", "support_count_prune_sites")
    assert all(ops.LAUNCHES[name] == 1 for name in support)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,w", [(1, 1, 1), (2, 31, 3), (2, 32, 32), (3, 33, 5), (1, 700, 32), (4, 25_000, 32)])
def test_cuda_vertical_stages_match_plain_versions(cuda_device, s, n, w):
    """The count's two stages alone: the transpose equals
    ref.vertical_bitmap_ref bit for bit (zero past N), and the count from it
    equals the plain versions, thresholds included."""
    gen = torch.Generator().manual_seed(s + n + w)
    tx = _rand_words(gen, (s, n, w), cuda_device)
    tx[:, n - min(n, 2) :] = 0  # zero pad rows
    masks = _sparse_masks(gen, s, 50, w, cuda_device, items=3)
    mc = torch.tensor([1 + n // 3 * i for i in range(s)], dtype=torch.int32, device=cuda_device)
    ops.reset_launches()
    vt = ops.vertical_bitmap(tx)
    counts, flags = ops.support_count_vertical_sites(vt, masks, n, mc)
    torch.cuda.synchronize()
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert torch.equal(vt, ref.vertical_bitmap_ref(tx))
    want = ref.support_count_sites_ref(tx, masks)
    assert torch.equal(counts, want) and torch.equal(flags, want >= mc[:, None])


@pytest.mark.cuda
def test_cuda_zero_sizes_launch_nothing(cuda_device):
    ops.reset_launches()
    z = torch.zeros((0, 2), dtype=torch.int32, device=cuda_device)
    m = torch.zeros((3, 2), dtype=torch.int32, device=cuda_device)
    assert torch.equal(ops.support_count(z, m).cpu(), torch.zeros(3, dtype=torch.int32))
    assert ops.support_count_prune(m, z, 1)[0].numel() == 0
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_kmeans_kernel_limits_raise():
    """Past the CUDA kernel's K, D and S limits the wrapper raises before
    any launch (the check runs on every device's shapes)."""
    ops.check_kmeans_kernel_limits(200, 20, 8)
    ops.check_kmeans_kernel_limits(ops.KMEANS_MAX_S, ops.KMEANS_MAX_K, ops.KMEANS_MAX_D)
    with pytest.raises(ValueError, match="D <= 128"):
        ops.check_kmeans_kernel_limits(1, 20, ops.KMEANS_MAX_D + 1)
    with pytest.raises(ValueError, match="K <= 65536"):
        ops.check_kmeans_kernel_limits(1, ops.KMEANS_MAX_K + 1, 8)
    with pytest.raises(ValueError, match="S <= 65535"):
        ops.check_kmeans_kernel_limits(ops.KMEANS_MAX_S + 1, 20, 8)


def test_kmeans_assign_rejects_mixed_devices_and_shapes():
    x = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.kmeans_assign_sites(x[None], torch.zeros((1, 2, 3), device="meta"))
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.kmeans_assign(x, torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="K >= 1"):
        ops.kmeans_assign(x, torch.zeros((0, 3)))
    with pytest.raises(TypeError, match="floating point"):
        ops.kmeans_assign(x.int(), torch.zeros((2, 3), dtype=torch.int32))


def test_vclustering_runtime_defaults_to_the_card():
    xs = np.zeros((2, 10, 3), dtype=np.float32)
    if torch.cuda.is_available():
        assert GridRuntime().use_kernel and GridRuntime().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            GridRuntime().run("vclustering", xs, {"k_local": 2, "iters": 1})


def _kmeans_case(gen, s, n, k, d, device, dup=False, on_center=False):
    xs = torch.randn((s, n, d), generator=gen) * 5
    cs = torch.randn((s, k, d), generator=gen) * 5
    if dup and k > 1:
        cs[:, k - 1] = cs[:, 0]  # ties go to the lowest index
    if on_center and n > 0:
        xs[:, : min(n, k)] = cs[:, : min(n, k)]  # the clamp at 0
    return xs.to(device), cs.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,n,k,d,dup,on_center",
    [(1, 1000, 20, 8, False, False), (4, 777, 1, 1, False, False), (3, 301, 600, 8, True, True),
     (2, 257, 70, 100, True, True), (200, 513, 20, 8, False, True), (2, 129, 5, 3, True, False),
     (200, 1000, 20, 8, False, True), (3, 1027, 20, 8, True, False), (2, 4099, 7, 3, False, True),
     (2, 2051, 9, 16, True, True)],
)
def test_cuda_kmeans_assign_matches_plain_version(cuda_device, s, n, k, d, dup, on_center):
    """The kernel sums in the plain version's order: bit-identical outputs,
    including across K and D that span several shared-memory tiles, and N
    that leaves a ragged last block (S 200 x 1,000 points, 1,027, 4,099)."""
    gen = torch.Generator().manual_seed(s * n + k + d)
    xs, cs = _kmeans_case(gen, s, n, k, d, cuda_device, dup, on_center)
    ops.reset_launches()
    a, m = ops.kmeans_assign_sites(xs, cs)
    a1, m1 = ops.kmeans_assign(xs[0], cs[0])
    torch.cuda.synchronize()
    ra, rm = ref.kmeans_assign_sites_ref(xs, cs)
    assert torch.equal(a, ra) and torch.equal(m, rm)
    assert torch.equal(a1, ra[0]) and torch.equal(m1, rm[0])
    assert ops.LAUNCHES["kmeans_assign_sites"] == 1 and ops.LAUNCHES["kmeans_assign"] == 1


@pytest.mark.cuda
def test_cuda_kmeans_floors_build_and_run(cuda_device):
    """The floors library builds and both variants run at a ragged size,
    outside LAUNCHES: load_only writes each row's bits, arith_only a finite
    assignment of points made from their index."""
    gen = torch.Generator().manual_seed(3)
    xs, cs = _kmeans_case(gen, 3, 1027, 20, 8, cuda_device)
    ops.reset_launches()
    la, lm = ops.kmeans_assign_floor(xs, cs, "load_only")
    aa, am = ops.kmeans_assign_floor(xs, cs, "arith_only")
    torch.cuda.synchronize()
    assert all(v == 0 for v in ops.LAUNCHES.values())
    bits = xs.contiguous().view(torch.int32)
    want = bits[..., 0]
    for d in range(1, 8):
        want = want ^ bits[..., d]
    assert torch.equal(la, want) and torch.equal(lm, xs[..., 0])
    assert bool(((aa >= 0) & (aa < 20)).all()) and bool(torch.isfinite(am).all()) and bool((am >= 0).all())
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.kmeans_assign_floor(xs.cpu(), cs.cpu(), "load_only")


@pytest.mark.cuda
def test_cuda_kmeans_assign_edges(cuda_device):
    ops.reset_launches()
    a, m = ops.kmeans_assign(torch.zeros((0, 4), device=cuda_device), torch.ones((3, 4), device=cuda_device))
    assert a.shape == (0,) and m.shape == (0,)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(ValueError, match="D <= 128"):
        ops.kmeans_assign(torch.zeros((5, 129), device=cuda_device), torch.zeros((2, 129), device=cuda_device))
    with pytest.raises(ValueError, match="K <= 65536"):
        ops.kmeans_assign(torch.zeros((5, 1), device=cuda_device), torch.zeros((65537, 1), device=cuda_device))
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.kmeans_assign(torch.zeros((5, 2)), torch.zeros((2, 2), device=cuda_device))
    # an unaligned view goes through an aligned copy
    buf = torch.randn(4 * 100 * 8 + 1, device=cuda_device)
    xs = buf[1:].view(4, 100, 8)
    cs = torch.randn((4, 20, 8), device=cuda_device)
    a, m = ops.kmeans_assign_sites(xs, cs)
    ra, rm = ref.kmeans_assign_sites_ref(xs, cs)
    assert torch.equal(a, ra) and torch.equal(m, rm)


def test_model_and_serve_cache_default_to_the_card():
    from repro_torch.configs import get, reduced
    from repro_torch.models import transformer as T

    cfg = reduced(get("xlstm-1.3b"))
    if torch.cuda.is_available():
        assert T.Model(cfg).device.type == "cuda"
        assert T.init_cache(cfg, 1, 4)[0]["h"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            T.Model(cfg)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            T.init_cache(cfg, 1, 4)


def _slstm_inputs(gen, b, s, h, p, dtype, device):
    wx = (torch.randn((b, s, h, 4 * p), generator=gen) * 0.5).to(dtype)
    r = torch.randn((h, p, 4 * p), generator=gen) / p**0.5
    bias = torch.randn((h, 4 * p), generator=gen) * 0.1
    c0 = torch.randn((b, h, p), generator=gen).to(dtype)
    n0 = (torch.rand((b, h, p), generator=gen) + 0.5).to(dtype)
    h0 = (torch.randn((b, h, p), generator=gen) * 0.5).to(dtype)
    return [t.to(device) for t in (wx, r, bias, c0, n0, h0)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,h,p,dtype",
    [(2, 16, 2, 16, torch.float32), (3, 37, 4, 16, torch.bfloat16), (5, 19, 1, 48, torch.float32),
     (8, 64, 4, 512, torch.bfloat16)],
)
def test_cuda_slstm_scan_matches_plain_version(cuda_device, b, s, h, p, dtype):
    """The kernel against the plain version on the card: float32 outputs to
    a few float32 roundings (the gate sums run in another order), bfloat16
    outputs to one bf16 ulp (2^-7 relative) of the value."""
    gen = torch.Generator().manual_seed(b * s + h + p)
    wx, r, bias, c0, n0, h0 = _slstm_inputs(gen, b, s, h, p, dtype, cuda_device)
    ops.reset_launches()
    hids, state = ops.slstm_scan(wx, r, bias, (c0, n0, h0))
    again, _ = ops.slstm_scan(wx, r, bias, (c0, n0, h0))
    torch.cuda.synchronize()
    rh, rstate = ref.slstm_scan_ref(wx, r, bias, (c0, n0, h0))
    assert ops.LAUNCHES["slstm_scan"] == 2
    assert torch.equal(hids, again)  # a fixed summation order
    rtol, atol = (2.0**-7, 1e-5) if dtype == torch.bfloat16 else (1e-4, 1e-5)
    for got, want in [(hids, rh), *zip(state, rstate)]:
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_slstm_scan_edges(cuda_device):
    gen = torch.Generator().manual_seed(0)
    wx, r, bias, c0, n0, h0 = _slstm_inputs(gen, 2, 0, 1, 16, torch.float32, cuda_device)
    ops.reset_launches()
    hids, (c, _, _) = ops.slstm_scan(wx, r, bias, (c0, n0, h0))
    assert hids.shape == (2, 0, 1, 16) and torch.equal(c, c0) and ops.LAUNCHES["slstm_scan"] == 0
    wx, r, bias, c0, n0, h0 = _slstm_inputs(gen, 2, 3, 1, 24, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.slstm_scan(wx, r, bias, (c0, n0, h0))
    wx, r, bias, c0, n0, h0 = _slstm_inputs(gen, 2, 3, 1, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.slstm_scan(wx.transpose(0, 1).contiguous().transpose(0, 1), r, bias, (c0, n0, h0))


@pytest.mark.cuda
def test_cuda_slstm_scan_ignores_tags_left_in_reused_memory(cuda_device):
    """An exchange buffer reused from an earlier launch holds tagged h words
    whose tags equal those the next launch awaits (tag t + 1 at parity t & 1
    whatever S is).  The wrapper zeroes it on every call, so a second launch
    on that memory, on other inputs and an S of the other parity, still
    matches the plain version and a launch on fresh memory; so does one on
    a buffer filled with every tag it will await and NaN values."""
    from repro_torch.kernels.ops import _slstm_run

    gen = torch.Generator().manual_seed(11)
    first = _slstm_inputs(gen, 8, 6, 4, 512, torch.float32, cuda_device)
    second = _slstm_inputs(gen, 8, 7, 4, 512, torch.float32, cuda_device)
    buf = torch.empty(ops.slstm_scratch_shapes(8, 4, 512)["exchange"], dtype=torch.int64, device=cuda_device)
    _slstm_run(first[0], first[1], first[2], tuple(first[3:]), "slstm_scan", exchange=buf)
    torch.cuda.synchronize()
    # S = 6 leaves h_4 (tag 5) at parity 0 and h_3 (tag 4) at parity 1: S = 7 awaits both, at steps 5 and 4
    assert int((buf[0] >> 32).max()) == 5 and int((buf[1] >> 32).max()) == 4
    fresh, fresh_state = ops.slstm_scan(second[0], second[1], second[2], tuple(second[3:]))
    rh, rstate = ref.slstm_scan_ref(second[0], second[1], second[2], tuple(second[3:]))
    nan_bits = int(np.array(np.nan, np.float32).view(np.uint32))
    for label in ("left by the first launch", "the first awaited tags, NaN values"):
        if label.startswith("the first"):  # step 1 awaits tag 1 at parity 0, step 2 tag 2 at parity 1
            buf[0] = (1 << 32) | nan_bits
            buf[1] = (2 << 32) | nan_bits
        hids, state, _ = _slstm_run(second[0], second[1], second[2], tuple(second[3:]), "slstm_scan", exchange=buf)
        torch.cuda.synchronize()
        assert torch.equal(hids, fresh), label
        assert all(torch.equal(a, c) for a, c in zip(state, fresh_state)), label
        for got, want in [(hids, rh), *zip(state, rstate)]:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_slstm_scan_three_launches_bit_identical(cuda_device):
    """xlstm-1.3b's prefill launch shape (B 8, H 4, P 512, bf16) at a short
    S: the fixed summation order gives the same bits whatever order the h
    words arrive in."""
    gen = torch.Generator().manual_seed(5)
    wx, r, bias, c0, n0, h0 = _slstm_inputs(gen, 8, 200, 4, 512, torch.bfloat16, cuda_device)
    runs = [ops.slstm_scan(wx, r, bias, (c0, n0, h0)) for _ in range(3)]
    torch.cuda.synchronize()
    for hids, state in runs[1:]:
        assert torch.equal(hids, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(state, runs[0][1]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,dtype", [(8, 64, 4, 512, torch.bfloat16), (3, 37, 2, 48, torch.float32)])
def test_cuda_slstm_timed_build_gives_the_same_bits(cuda_device, b, s, h, p, dtype):
    """The phase timers change no result, count every phase of every CTA,
    and count no launch in LAUNCHES."""
    gen = torch.Generator().manual_seed(b + s)
    wx, r, bias, c0, n0, h0 = _slstm_inputs(gen, b, s, h, p, dtype, cuda_device)
    hids, state = ops.slstm_scan(wx, r, bias, (c0, n0, h0))
    ops.reset_launches()
    t_hids, t_state, cycles = ops.slstm_scan_phase_cycles(wx, r, bias, (c0, n0, h0))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["slstm_scan"] == 0
    assert torch.equal(t_hids, hids) and all(torch.equal(a, c) for a, c in zip(t_state, state))
    assert cycles.shape == (h * p // 16, len(ops.SLSTM_PHASES)) and cycles.dtype == torch.int64
    assert bool((cycles > 0).all()), cycles.min(0).values.tolist()


def test_gemma2_config_has_the_published_widths():
    from repro_torch.configs import get
    from repro_torch.models import transformer as T

    cfg = get("gemma2-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab) == \
        (26, 2304, 8, 4, 256, 9216, 256_000)
    assert cfg.blocks() == ["swa", "full"] * 13 and cfg.window == 4096
    assert (cfg.attn_softcap, cfg.final_softcap, cfg.act, cfg.norm) == (50.0, 30.0, "geglu", "rmsnorm")
    assert cfg.post_norm and cfg.embed_scale and cfg.tie_embeddings
    assert T.param_count(cfg) == 2_614_341_888


@pytest.mark.parametrize("arch,slice_", [
    ("phi-3-vision-4.2b", "patch frontend"), ("zamba2-1.2b", "Mamba-2"), ("mixtral-8x22b", "MoE"),
    ("deepseek-moe-16b", "MoE"), ("seamless-m4t-large-v2", "encoder-decoder"),
])
def test_queued_archs_raise_naming_their_slice(arch, slice_):
    from repro_torch.configs import get

    with pytest.raises(NotImplementedError, match=slice_):
        get(arch)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    """Checked on every device, before any launch."""
    q, k = torch.zeros((1, 4, 4, 16)), torch.zeros((1, 4, 2, 16))
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        ops.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="multiple of Kv"):
        ops.flash_attention(torch.zeros((1, 4, 3, 16)), k, k)
    with pytest.raises(ValueError, match="at most 256"):
        ops.flash_attention(torch.zeros((1, 4, 4, 264)), torch.zeros((1, 4, 2, 264)), torch.zeros((1, 4, 2, 264)))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(torch.zeros((1, 4, 4, 12)), torch.zeros((1, 4, 2, 12)), torch.zeros((1, 4, 2, 12)))
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.flash_attention(q, torch.zeros((2, 4, 2, 16)), torch.zeros((2, 4, 2, 16)))


def test_flash_phase_cycles_refuses_what_it_cannot_time():
    """The phase timers exist only in the float32 CUDA kernel: CPU tensors
    and bfloat16 raise.  The split turns cycles into shares and ms."""
    q, k = torch.zeros((1, 4, 4, 16)), torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention_phase_cycles(q, k, k)
    with pytest.raises(TypeError, match="float32"):
        ops.flash_attention_phase_cycles(q.bfloat16(), k.bfloat16(), k.bfloat16())
    split = ops.flash_phase_split(torch.tensor([[3, 1, 0, 4, 0], [1, 1, 2, 0, 0]]), 6.0)
    assert split["ctas"] == 2 and split["share"]["copy"] == 4 / 12
    assert split["phase_ms"]["pv"] == 4 / 12 * 6.0 and abs(sum(split["phase_ms"].values()) - 6.0) < 1e-12


def test_dense_model_and_kv_cache_default_to_the_card():
    from repro_torch.configs import get, reduced
    from repro_torch.models import transformer as T

    cfg = reduced(get("gemma2-2b")).scaled(flash_kernel=True)
    if torch.cuda.is_available():
        assert T.Model(cfg).device.type == "cuda"
        assert T.init_cache(cfg, 1, 4)[0]["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            T.Model(cfg)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            T.init_cache(cfg, 1, 4)


def _flash_inputs(gen, b, sq, skv, h, kvh, dh, dtype, device):
    return [torch.randn((b, s, n, dh), generator=gen).to(dtype).to(device)
            for s, n in ((sq, h), (skv, kvh), (skv, kvh))]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,h,kvh,dh,causal,window,cap,dtype",
    [(1, 1, 8, 4, 256, True, 0, 50.0, torch.float32), (2, 37, 4, 1, 64, True, 16, 0.0, torch.bfloat16),
     (1, 300, 8, 4, 256, True, 16, 50.0, torch.bfloat16), (2, 130, 4, 4, 96, False, 0, 30.0, torch.float32),
     (1, 200, 32, 32, 128, True, 4096, 0.0, torch.float32), (1, 100, 4, 2, 16, False, 16, 0.0, torch.bfloat16)],
)
def test_cuda_flash_attention_matches_plain_version(cuda_device, b, s, h, kvh, dh, causal, window, cap, dtype):
    """The kernel against the plain version on the card (the same key
    tiles): float32 within 1e-5 relative plus 1e-6 (the dot products sum
    in another order); bfloat16 within one bf16 ulp (2^-7) of the value plus
    one of the |v|-weighted mean, since p rounds to bf16 for PV and the two
    may round a p to neighbouring values.  Two launches are bit-identical."""
    gen = torch.Generator().manual_seed(b * s + h + dh)
    q, k, v = _flash_inputs(gen, b, s, s, h, kvh, dh, dtype, cuda_device)
    _hold_flash(q, k, v, causal, window, cap)


def _hold_flash(q, k, v, causal, window, cap):
    """Two launches: bit-identical, both on the tensor-core kernel in
    bfloat16 and neither in float32, within the bound of the plain version."""
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    again = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 2 and torch.equal(out, again)
    assert ops.LAUNCHES["flash_attention_wgmma"] == (2 if q.dtype == torch.bfloat16 else 0)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap)
    err = (out.double() - want.double()).abs()
    if q.dtype == torch.float32:
        bound = 1e-5 * want.double().abs() + 1e-6
    else:
        spread = ref.flash_attention_ref(q, k, v.abs(), causal=causal, window=window, cap=cap).double()
        bound = 2.0**-7 * (want.double().abs() + spread) + 1e-6
    assert out.dtype == q.dtype and bool((err <= bound).all())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,skv,h,kvh,dh,causal,window,cap",
    [(2, 130, 130, 4, 2, 24, True, 0, 50.0), (2, 100, 100, 4, 4, 40, True, 16, 0.0),
     (1, 300, 300, 8, 4, 96, True, 0, 30.0), (2, 1031, 1031, 8, 4, 256, True, 4096, 50.0),
     (2, 40, 200, 4, 2, 64, False, 0, 50.0), (1, 300, 77, 8, 4, 256, False, 0, 0.0),
     (2, 72, 32, 4, 4, 16, False, 16, 0.0), (1, 400, 64, 4, 1, 128, False, 100, 50.0),
     (1, 256, 256, 48, 1, 128, True, 0, 50.0), (1, 257, 257, 48, 1, 64, True, 64, 0.0)],
)
def test_cuda_flash_attention_wgmma_edges(cuda_device, b, sq, skv, h, kvh, dh, causal, window, cap):
    """The bf16 tensor-core kernel at its own edges: a depth padded with
    zeros (Dh 24, 40, 96), Sq != Skv without the causal mask, rows that see
    no key (a window shorter than their distance to every key: exactly 0),
    and granite-20b's 48 query heads on one KV head."""
    gen = torch.Generator().manual_seed(b * sq + skv + h + dh)
    q, k, v = _flash_inputs(gen, b, sq, skv, h, kvh, dh, torch.bfloat16, cuda_device)
    out = _hold_flash(q, k, v, causal, window, cap)
    if not causal and window and sq > window + skv - 1:  # rows window + skv - 1.. see no key
        assert bool((out[:, window + skv - 1 :] == 0).all())
        assert bool((out[:, : window + skv - 1].abs().amax(dim=-1) > 0).all())


@pytest.mark.cuda
def test_cuda_flash_attention_edges(cuda_device):
    gen = torch.Generator().manual_seed(0)
    ops.reset_launches()
    q, k, v = _flash_inputs(gen, 2, 0, 5, 4, 2, 16, torch.float32, cuda_device)
    assert ops.flash_attention(q, k, v).shape == (2, 0, 4, 16)
    q, k, v = _flash_inputs(gen, 2, 5, 0, 4, 2, 16, torch.float32, cuda_device)
    assert torch.equal(ops.flash_attention(q, k, v), torch.zeros_like(q))
    assert ops.LAUNCHES["flash_attention"] == 0
    q, k, v = _flash_inputs(gen, 2, 8, 8, 4, 2, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention(q.cpu(), k, v)


_FLASH_EDGES = [  # (B, Sq, Skv, H, Kv, Dh, causal, window, cap): the bf16 kernel's edges
    (2, 130, 130, 4, 2, 24, True, 0, 50.0), (2, 100, 100, 4, 4, 40, True, 16, 0.0),
    (1, 300, 300, 8, 4, 96, True, 0, 30.0), (2, 1031, 1031, 8, 4, 256, True, 4096, 50.0),
    (2, 40, 200, 4, 2, 64, False, 0, 50.0), (1, 300, 77, 8, 4, 256, False, 0, 0.0),
    (2, 72, 32, 4, 4, 16, False, 16, 0.0), (1, 400, 64, 4, 1, 128, False, 100, 50.0),
    (1, 256, 256, 48, 1, 128, True, 0, 50.0), (1, 257, 257, 48, 1, 64, True, 64, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kvh,dh,causal,window,cap", _FLASH_EDGES)
def test_cuda_flash_attention_f32_edges(cuda_device, b, sq, skv, h, kvh, dh, causal, window, cap):
    """The float32 kernel at the bf16 kernel's edges, within 1e-5 relative
    plus 1e-6 of the plain version: depths that are not a multiple of the
    32-column K slice (Dh 24, 40, 96), Sq != Skv without the causal mask,
    rows that see no key (exactly 0), 48 query heads on one KV head."""
    gen = torch.Generator().manual_seed(b * sq + skv + h + dh)
    q, k, v = _flash_inputs(gen, b, sq, skv, h, kvh, dh, torch.float32, cuda_device)
    out = _hold_flash(q, k, v, causal, window, cap)
    if not causal and window and sq > window + skv - 1:  # rows window + skv - 1.. see no key
        assert bool((out[:, window + skv - 1 :] == 0).all())
        assert bool((out[:, : window + skv - 1].abs().amax(dim=-1) > 0).all())


@pytest.mark.cuda
def test_cuda_flash_attention_f32_three_launches_bit_identical(cuda_device):
    """gemma2-2b's float32 launch shape (H 8, Kv 4, Dh 256, causal, cap 50)
    at a shorter S, full and window layer: no atomics, a fixed sum order."""
    gen = torch.Generator().manual_seed(7)
    q, k, v = _flash_inputs(gen, 1, 1100, 1100, 8, 4, 256, torch.float32, cuda_device)
    for window in (0, 512):
        runs = [ops.flash_attention(q, k, v, causal=True, window=window, cap=50.0) for _ in range(3)]
        torch.cuda.synchronize()
        assert torch.equal(runs[1], runs[0]) and torch.equal(runs[2], runs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kvh,dh,causal,window,cap",
                         [(1, 700, 700, 8, 4, 256, True, 0, 50.0), (2, 300, 77, 4, 2, 40, False, 16, 0.0)])
def test_cuda_flash_timed_build_gives_the_same_bits(cuda_device, b, sq, skv, h, kvh, dh, causal, window, cap):
    """The phase timers change no result, count cycles in every CTA, and
    count no launch in LAUNCHES."""
    gen = torch.Generator().manual_seed(sq + dh)
    q, k, v = _flash_inputs(gen, b, sq, skv, h, kvh, dh, torch.float32, cuda_device)
    out = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    ops.reset_launches()
    t_out, cycles = ops.flash_attention_phase_cycles(q, k, v, causal=causal, window=window, cap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 0 and torch.equal(t_out, out)
    assert cycles.shape == (ops.flash_ctas(b, sq, h), len(ops.FLASH_PHASES)) and cycles.dtype == torch.int64
    assert bool((cycles.sum(1) > 0).all())


def test_delta_apriori_defaults_to_the_card():
    from repro_torch.core.apriori import DeltaApriori

    if torch.cuda.is_available():
        assert DeltaApriori(4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            DeltaApriori(4)
    assert DeltaApriori(4, device="cpu").device.type == "cpu"


def test_run_many_rejects_unknown_apps():
    with pytest.raises(ValueError, match="unknown app"):
        GridRuntime(device="cpu").run_many("word2vec", [[]], [{}])
    with pytest.raises(ValueError, match="'local' workload"):
        GridRuntime(device="cpu").run_many("topk", [[]], [{}])


def test_registry_runs_the_ported_apps_on_the_grid():
    """The apps themselves and validate_registry() are held in
    test_torch_gfm.py::test_registry_is_fully_specified; the local ones
    (served in-process by the mining service) in test_torch_registry.py."""
    from repro_torch.workflow.registry import app_names, get_workload

    runners = {a: get_workload(a).runner for a in app_names()}
    assert runners == {"apriori": "local", "gfm": "grid", "fdm": "grid", "cd_apriori": "grid",
                       "topk": "local", "kmeans": "local", "vclustering": "grid"}
    mine = {a: [p.name for p in get_workload(a).params] for a in ("gfm", "fdm", "cd_apriori")}
    split = ["n_sites", "split_seed"]
    assert mine == {"gfm": ["k", "minsup", "local_minsup"] + split, "fdm": ["k", "minsup"] + split,
                    "cd_apriori": ["k", "minsup"] + split}


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(100_000, 2_000), (25_000, 6_000)])
def test_cuda_single_db_kernels_at_the_delta_shapes(cuda_device, n, c):
    """The single-DB wrappers at the delta path's launch shapes: S = 1 over
    a 100,000-row stream, and thousands of cached masks against one
    25,000-row batch; exact against the plain versions."""
    gen = torch.Generator().manual_seed(n + c)
    tx = _rand_words(gen, (1, n, 32), cuda_device)[0]
    masks = _sparse_masks(gen, 1, c, 32, cuda_device, items=3)[0]
    ops.reset_launches()
    counts = ops.support_count(tx, masks)
    pc, pf = ops.support_count_prune(tx, masks, n // 5)
    torch.cuda.synchronize()
    want = ref.support_count_ref(tx, masks)
    assert torch.equal(counts, want) and torch.equal(pc, want) and torch.equal(pf, want >= n // 5)
    assert ops.LAUNCHES["support_count"] == 1 and ops.LAUNCHES["support_count_prune"] == 1


@pytest.mark.cuda
def test_cuda_fused_wave_with_member_ragged_candidates(cuda_device):
    """A fused wave as run_many makes it: members with different row and
    candidate counts, padded to one shape (all-zero rows, all-zero masks
    whose counts are sliced away); each member's counts and flags equal
    the plain path's, in one launch of each site form."""
    from repro_torch.core.apriori import TransactionDB, fused_count_sites, fused_prune_sites

    rng = np.random.default_rng(4)
    dbs = [TransactionDB.from_dense(rng.random((n, 300)) < 0.2, device=cuda_device) for n in (900, 1000, 900, 1000)]
    lists = []
    for c in (700, 40, 0, 1300):
        its = {tuple(sorted(rng.choice(300, size=int(rng.integers(1, 4)), replace=False).tolist())) for _ in range(c)}
        lists.append(sorted(its))
    mins = [150, 20, 5, 90]
    ops.reset_launches()
    got = fused_count_sites(dbs, lists, backend="kernel")
    got_p = fused_prune_sites(dbs, lists, mins, backend="kernel")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["support_count_sites"] == 1 and ops.LAUNCHES["support_count_prune_sites"] == 1
    want = fused_count_sites(dbs, lists, backend="torch")
    want_p = fused_prune_sites(dbs, lists, mins, backend="torch")
    for g, w, (gc, gf), (wc, wf), lst in zip(got, want, got_p, want_p, lists):
        assert len(g) == len(lst) and np.array_equal(g, w)
        assert np.array_equal(gc, wc) and np.array_equal(gf, wf)


def test_mining_service_defaults_to_the_card():
    from repro_torch.launch.serve import MiningService

    if torch.cuda.is_available():
        assert MiningService().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            MiningService()


@pytest.mark.cuda
def test_cuda_mining_service_reaches_the_kernels(cuda_device):
    """A tiny service on the card: one fused gfm pair goes through the
    site-form support counts in one dispatch, and an apriori query through
    the single-DB ones; both equal the same service on the plain path."""
    from repro_torch.data.synthetic import ibm_transactions
    from repro_torch.launch.serve import MiningService
    from repro_torch.workflow.registry import get_workload

    def run(count_backend, device):
        svc = MiningService(device=device, n_sites=2, count_backend=count_backend)
        svc.register_dataset("tx", "transactions", n_items=40)
        svc.append_transactions("tx", ibm_transactions(0, 600, 40))
        rids = [svc.submit("a", "gfm", "tx", {"k": 3, "minsup": 0.05}),
                svc.submit("b", "gfm", "tx", {"k": 3, "minsup": 0.08})]
        svc.step()
        svc.append_transactions("tx", ibm_transactions(1, 300, 40))
        rids.append(svc.submit("a", "apriori", "tx", {"k": 3, "minsup": 0.05}))
        svc.step()
        assert all(svc.poll(r) == "done" for r in rids), [svc.request(r).error for r in rids]
        return svc, rids

    ops.reset_launches()
    svc, rids = run("kernel", cuda_device)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    assert svc.device_dispatches == 2 and svc.fused_requests == 2
    assert launches["support_count_prune_sites"] > 0 and launches["support_count_sites"] > 0
    assert launches["support_count"] + launches["support_count_prune"] > 0
    plain, prids = run("torch", "cpu")
    for r, p in zip(rids, prids):
        app = svc.request(r).app
        assert get_workload(app).digest(svc.result(r)) == get_workload(app).digest(plain.result(p))
