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


def _sparse_masks(gen, s, c, w, device):
    masks = torch.zeros((s, c, w), dtype=torch.int64)
    bits = torch.randint(0, 32 * w, (s, c, 2), generator=gen)
    for k in range(2):
        word, bit = bits[..., k] // 32, bits[..., k] % 32
        masks.scatter_(2, word[..., None], masks.gather(2, word[..., None]) | (1 << bit[..., None]))
    masks[:, :2] = 0  # all-zero masks count every row
    return masks.to(torch.int32).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,n,c,w",
    [(1, 700, 37, 1), (4, 700, 37, 32), (3, 513, 129, 5), (2, 5000, 150, 8), (2, 3000, 260, 16),
     (4, 2000, 300, 32)],
)
def test_cuda_kernels_match_plain_versions(cuda_device, s, n, c, w):
    gen = torch.Generator().manual_seed(s * n + c + w)
    tx = _rand_words(gen, (s, n, w), cuda_device)
    masks = _sparse_masks(gen, s, c, w, cuda_device)
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
     (2, 257, 70, 100, True, True), (200, 513, 20, 8, False, True), (2, 129, 5, 3, True, False)],
)
def test_cuda_kmeans_assign_matches_plain_version(cuda_device, s, n, k, d, dup, on_center):
    """The kernel sums in the plain version's order: bit-identical outputs,
    including across K and D that span several shared-memory tiles."""
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
