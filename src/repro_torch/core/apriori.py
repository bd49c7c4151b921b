"""Apriori substrate: packed-bitmap transaction DBs + candidate machinery.

Transactions are bitmaps over a fixed item universe, packed 32 items/word.
On the device the words are int32 bit views of the uint32 bitmaps.
Support counting — the compute hot-spot — is served either by the plain
PyTorch path (``backend="torch"``) or by the hand-written CUDA kernels
behind ``repro_torch.kernels.ops`` (``backend="kernel"``; on a CPU tensor
those wrappers run the plain version).

Candidate *generation* (level-wise join + prune) is classic set algebra
with data-dependent sizes; it stays on host exactly as in the paper, where
the protocol is orchestrated at the grid-job level anyway.
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence
from dataclasses import dataclass
from itertools import combinations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

Itemset = tuple[int, ...]  # always sorted

BACKENDS = ("kernel", "torch")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown count backend {backend!r}; expected one of {BACKENDS}")


# ---------------------------------------------------------------------------
# Packed-bitmap DB
# ---------------------------------------------------------------------------


def n_words(n_items: int) -> int:
    return (n_items + 31) // 32


def pack_bool_matrix(dense: np.ndarray) -> np.ndarray:
    """(N, n_items) bool -> (N, W) uint32, bit i of word w = item 32*w+i."""
    n, m = dense.shape
    w = n_words(m)
    padded = np.zeros((n, w * 32), dtype=bool)
    padded[:, :m] = dense
    bits = padded.reshape(n, w, 32)
    weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
    words = (bits.astype(np.uint64) * weights[None, None, :]).sum(axis=-1)
    return words.astype(np.uint32)


def pack_itemsets(itemsets: Sequence[Itemset], n_items: int) -> np.ndarray:
    """List of itemsets -> (C, W) uint32 masks."""
    w = n_words(n_items)
    out = np.zeros((max(len(itemsets), 1), w), dtype=np.uint32)
    for c, its in enumerate(itemsets):
        for item in its:
            out[c, item // 32] |= np.uint32(1) << np.uint32(item % 32)
    return out


def _to_device_words(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 words -> their int32 bit view on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)).to(device)


@dataclass(frozen=True)
class TransactionDB:
    """One site's transaction database."""

    packed: torch.Tensor  # (n_tx, W) int32 bit view of the uint32 words
    n_items: int
    n_tx: int

    @staticmethod
    def from_dense(dense: np.ndarray, device: str | torch.device | None = None) -> "TransactionDB":
        return TransactionDB(
            packed=_to_device_words(pack_bool_matrix(dense), resolve_device(device)),
            n_items=dense.shape[1],
            n_tx=dense.shape[0],
        )

    def to(self, device: str | torch.device) -> "TransactionDB":
        """This DB with its words on ``device`` (itself when already there)."""
        packed = self.packed.to(device)
        if packed is self.packed:
            return self
        return TransactionDB(packed=packed, n_items=self.n_items, n_tx=self.n_tx)


# ---------------------------------------------------------------------------
# Support counting (plain path; kernel behind the same signature)
# ---------------------------------------------------------------------------


def count_supports(
    db: TransactionDB,
    itemsets: Sequence[Itemset],
    backend: str = "torch",
) -> np.ndarray:
    """Support counts for ``itemsets`` on one site's DB.  Returns (C,) int64."""
    _check_backend(backend)
    if not itemsets:
        return np.zeros((0,), dtype=np.int64)
    masks = _to_device_words(pack_itemsets(itemsets, db.n_items), db.packed.device)
    if backend == "kernel":
        out = ops.support_count(db.packed, masks)
    else:
        out = ref.support_count_ref(db.packed, masks)
    return out.cpu().numpy().astype(np.int64)


def count_supports_prune(
    db: TransactionDB,
    itemsets: Sequence[Itemset],
    min_count: int,
    backend: str = "torch",
) -> tuple[np.ndarray, np.ndarray]:
    """Counts AND the ``>= min_count`` frequent mask for one site's level
    in a single pass — ``(counts (C,) int64, frequent (C,) bool)`` with
    ``frequent == counts >= min_count`` exactly.  On the kernel backend
    the threshold is fused into the device pass
    (``ops.support_count_prune``); the plain path thresholds on host
    behind the identical signature."""
    _check_backend(backend)
    if not itemsets:
        return np.zeros((0,), dtype=np.int64), np.zeros((0,), dtype=bool)
    if backend == "kernel":
        masks = _to_device_words(pack_itemsets(itemsets, db.n_items), db.packed.device)
        cnt, freq = ops.support_count_prune(db.packed, masks, int(min_count))
        return cnt.cpu().numpy().astype(np.int64), freq.cpu().numpy()
    sup = count_supports(db, itemsets, backend=backend)
    return sup, sup >= int(min_count)


def _stack_sites(
    dbs: Sequence[TransactionDB], lists: list[list[Itemset]], live: list[int], w: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The live sites padded to one shape on their device: transactions to
    the max ``n_tx`` with all-zero rows (which match no non-empty mask, so
    they add no support) and candidates to the max count with all-zero
    masks (whose counts are sliced away by the caller)."""
    device = dbs[live[0]].packed.device
    n_max = max(dbs[i].n_tx for i in live)
    c_max = max(len(lists[i]) for i in live)
    tx_s = torch.zeros((len(live), n_max, w), dtype=torch.int32, device=device)
    masks_np = np.zeros((len(live), c_max, w), dtype=np.uint32)
    for row, i in enumerate(live):
        tx_s[row, : dbs[i].n_tx] = dbs[i].packed
        masks_np[row, : len(lists[i])] = pack_itemsets(lists[i], dbs[i].n_items)
    return tx_s, _to_device_words(masks_np, device)


def fused_count_sites(
    dbs: Sequence[TransactionDB],
    itemset_lists: Sequence[Sequence[Itemset]],
    backend: str = "torch",
) -> list[np.ndarray]:
    """Count each site's OWN candidate list with ONE device dispatch
    across the site axis — the fused form of per-site ``count_supports``
    loops that the batched execution backend uses for the ``apriori_i``
    / ``recount_i`` fan-outs.  Returns one (C_i,) int64 array per site,
    exactly equal to ``count_supports(dbs[i], itemset_lists[i])``.

    Falls back to the per-site loop when the sites disagree on the item
    universe (no common mask width).  The "site" axis is purely
    positional: nothing here assumes the lists share a threshold or a
    candidate pool — each position is counted against its own list only.
    """
    _check_backend(backend)
    lists = [list(lst) for lst in itemset_lists]
    if len(dbs) != len(lists):
        raise ValueError(f"{len(dbs)} sites but {len(lists)} candidate lists")
    empty = np.zeros((0,), dtype=np.int64)
    live = [i for i, lst in enumerate(lists) if lst]
    out: list[np.ndarray] = [empty] * len(lists)
    if not live:
        return out
    widths = {n_words(dbs[i].n_items) for i in live}
    if len(widths) != 1:
        # heterogeneous item universes cannot share one mask layout
        for i in live:
            out[i] = count_supports(dbs[i], lists[i], backend=backend)
        return out
    tx_s, masks_s = _stack_sites(dbs, lists, live, widths.pop())
    if backend == "kernel":
        counts = ops.support_count_sites(tx_s, masks_s)
    else:
        counts = ref.support_count_sites_ref(tx_s, masks_s)
    counts = counts.cpu().numpy()
    for row, i in enumerate(live):
        out[i] = counts[row, : len(lists[i])].astype(np.int64)
    return out


def fused_prune_sites(
    dbs: Sequence[TransactionDB],
    itemset_lists: Sequence[Sequence[Itemset]],
    min_counts: Sequence[int],
    backend: str = "torch",
) -> list[tuple[np.ndarray, np.ndarray]]:
    """The prune-fused form of :func:`fused_count_sites`: one device
    dispatch counts every site's own candidate list AND thresholds it
    against that site's ``min_counts[i]``.  Returns one ``(counts (C_i,)
    int64, frequent (C_i,) bool)`` pair per site, with ``frequent ==
    counts >= min_counts[i]``.  Same padding rules, heterogeneous-universe
    fallback and positional-axis contract as the count-only form."""
    _check_backend(backend)
    lists = [list(lst) for lst in itemset_lists]
    if len(dbs) != len(lists):
        raise ValueError(f"{len(dbs)} sites but {len(lists)} candidate lists")
    if len(dbs) != len(min_counts):
        raise ValueError(f"{len(dbs)} sites but {len(min_counts)} thresholds")
    empty = (np.zeros((0,), dtype=np.int64), np.zeros((0,), dtype=bool))
    live = [i for i, lst in enumerate(lists) if lst]
    out: list[tuple[np.ndarray, np.ndarray]] = [empty] * len(lists)
    if not live:
        return out
    widths = {n_words(dbs[i].n_items) for i in live}
    if len(widths) != 1:
        for i in live:
            out[i] = count_supports_prune(dbs[i], lists[i], min_counts[i], backend=backend)
        return out
    tx_s, masks_s = _stack_sites(dbs, lists, live, widths.pop())
    mc = torch.tensor([int(min_counts[i]) for i in live], dtype=torch.int32, device=tx_s.device)
    if backend == "kernel":
        counts, freq = ops.support_count_prune_sites(tx_s, masks_s, mc)
    else:
        counts, freq = ref.support_count_prune_sites_ref(tx_s, masks_s, mc)
    counts, freq = counts.cpu().numpy(), freq.cpu().numpy()
    for row, i in enumerate(live):
        c_i = len(lists[i])
        out[i] = (counts[row, :c_i].astype(np.int64), freq[row, :c_i])
    return out


def item_supports(db: TransactionDB) -> np.ndarray:
    """Singleton supports (L1 seed) via bit-unpack + column sum on the
    DB's device.  Bit 31 makes a word negative and torch shifts int32
    arithmetically, so the bit is masked AFTER the shift."""
    words = db.packed  # (N, W) int32
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1  # (N, W, 32)
    cols = bits.reshape(words.shape[0], -1)[:, : db.n_items]
    return cols.sum(dim=0, dtype=torch.int64).cpu().numpy()


# ---------------------------------------------------------------------------
# Candidate generation (host-side set algebra)
# ---------------------------------------------------------------------------


def apriori_join(prev_frequent: Iterable[Itemset]) -> list[Itemset]:
    """F(k-1) x F(k-1) prefix join + downward-closure prune."""
    prev = sorted(set(prev_frequent))
    prev_set = set(prev)
    if not prev:
        return []
    k_1 = len(prev[0])
    out = []
    for a_i in range(len(prev)):
        a = prev[a_i]
        for b_i in range(a_i + 1, len(prev)):
            b = prev[b_i]
            if a[:-1] != b[:-1]:
                break  # sorted ⇒ shared prefix block is contiguous
            cand = a + (b[-1],)
            # prune: every (k)-subset must be in prev_set
            if all(tuple(sub) in prev_set for sub in combinations(cand, k_1)):
                out.append(cand)
    return out


def subsets_of(itemset: Itemset) -> list[Itemset]:
    """Immediate (size-1 smaller) subsets."""
    return [tuple(s) for s in combinations(itemset, len(itemset) - 1)]


# ---------------------------------------------------------------------------
# Site-local Apriori (paper Alg 2 line 2: apriori_gen(X_i, k))
# ---------------------------------------------------------------------------


@dataclass
class LocalMineResult:
    """All itemsets COUNTED locally, with counts; `frequent[k]` lists the
    locally frequent ones per level.  Counts are cached so the global phase
    never re-counts something this site already measured."""

    counts: dict[Itemset, int]
    frequent: dict[int, list[Itemset]]
    count_calls: int  # logical per-site count rounds (for perf accounting)
    candidates_counted: int


def local_apriori(
    db: TransactionDB,
    k_max: int,
    min_count: int,
    backend: str = "torch",
) -> LocalMineResult:
    """Level-wise Apriori with LOCAL pruning only (GFM phase 1)."""
    counts: dict[Itemset, int] = {}
    frequent: dict[int, list[Itemset]] = {}
    calls = 0
    n_cand = 0

    sup1 = item_supports(db)
    for item, c in enumerate(sup1):
        counts[(int(item),)] = int(c)
    frequent[1] = [(int(i),) for i in np.nonzero(sup1 >= min_count)[0]]
    calls += 1
    n_cand += db.n_items

    level = 1
    while level < k_max and frequent.get(level):
        cands = apriori_join(frequent[level])
        level += 1
        if not cands:
            frequent[level] = []
            break
        sup, freq = count_supports_prune(db, cands, min_count, backend=backend)
        calls += 1
        n_cand += len(cands)
        for its, c in zip(cands, sup):
            counts[its] = int(c)
        frequent[level] = [its for its, f in zip(cands, freq) if f]
    for lv in range(1, k_max + 1):
        frequent.setdefault(lv, [])
    return LocalMineResult(counts=counts, frequent=frequent, count_calls=calls, candidates_counted=n_cand)


def batched_local_apriori(
    dbs: Sequence[TransactionDB],
    k_max: int,
    min_counts: Sequence[int],
    backend: str = "torch",
) -> list[LocalMineResult]:
    """Phase-1 local Apriori for ALL sites in lockstep: per level, every
    site generates its candidates on host, then ONE fused device
    dispatch (``fused_prune_sites``) counts and thresholds every site's
    candidates across the site axis.  Result-identical to per-site
    ``local_apriori`` calls — same candidates, same exact integer counts,
    same ``count_calls`` ledger (which counts the protocol's logical
    per-site count rounds, not device dispatches).

    ``min_counts`` is per position: sites exhaust (leave ``active``)
    independently, and a position that stops generating candidates at
    level l must not drag its wave-mates down with it.
    """
    if len(dbs) != len(min_counts):
        raise ValueError(f"{len(dbs)} sites but {len(min_counts)} thresholds")
    res: list[LocalMineResult] = []
    for db, min_count in zip(dbs, min_counts):
        counts: dict[Itemset, int] = {}
        sup1 = item_supports(db)
        for item, c in enumerate(sup1):
            counts[(int(item),)] = int(c)
        res.append(
            LocalMineResult(
                counts=counts,
                frequent={1: [(int(i),) for i in np.nonzero(sup1 >= min_count)[0]]},
                count_calls=1,
                candidates_counted=db.n_items,
            )
        )
    level = 1
    active = set(range(len(dbs)))
    while level < k_max and active:
        cands_by: list[list[Itemset]] = [[] for _ in dbs]
        for i in list(active):
            if not res[i].frequent.get(level):
                active.discard(i)  # this site's search is exhausted
                continue
            cands_by[i] = apriori_join(res[i].frequent[level])
        level += 1
        sups = fused_prune_sites(dbs, cands_by, min_counts, backend=backend)
        for i in list(active):
            cands = cands_by[i]
            if not cands:
                res[i].frequent[level] = []
                active.discard(i)
                continue
            res[i].count_calls += 1
            res[i].candidates_counted += len(cands)
            cnt_i, freq_i = sups[i]
            for its, c in zip(cands, cnt_i):
                res[i].counts[its] = int(c)
            res[i].frequent[level] = [its for its, f in zip(cands, freq_i) if f]
    for lm in res:
        for lv in range(1, k_max + 1):
            lm.frequent.setdefault(lv, [])
    return res
