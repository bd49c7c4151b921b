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


# ---------------------------------------------------------------------------
# Delta (incremental) Apriori — the serving layer's hot repeated query
# ---------------------------------------------------------------------------


def concat_dbs(dbs: Sequence[TransactionDB]) -> TransactionDB:
    """Concatenate same-universe TransactionDBs along the transaction
    axis (the from-scratch view of an appended stream), on their one
    device."""
    if not dbs:
        raise ValueError("concat_dbs needs at least one TransactionDB")
    universes = {db.n_items for db in dbs}
    if len(universes) != 1:
        raise ValueError(f"cannot concat DBs over different item universes: {sorted(universes)}")
    devices = {db.packed.device for db in dbs}
    if len(devices) != 1:
        raise ValueError(f"cannot concat DBs on different devices: {sorted(map(str, devices))}")
    return TransactionDB(
        packed=torch.cat([db.packed for db in dbs], dim=0),
        n_items=dbs[0].n_items,
        n_tx=sum(db.n_tx for db in dbs),
    )


class DeltaApriori:
    """Incremental frequent-itemset state over an append-only transaction
    stream — the delta-maintenance entry point the continuous mining
    service queries repeatedly.

    Support counts are ADDITIVE over transactions, which is the whole
    trick (the FUP family of incremental Apriori algorithms): every
    itemset this state has ever counted keeps an exact cumulative count,
    and :meth:`append` extends each of them with one support-count pass
    over the NEW batch only — O(|delta|) device work instead of
    O(|stream|).  A :meth:`query` then replays the level-wise Apriori
    loop, serving candidates from the cumulative cache for free and
    counting only candidates it has never seen — over the full
    concatenated stream, so their counts are exact too.

    Correctness contract: ``query(k_max, min_count)`` is BIT-IDENTICAL —
    same per-level frequent itemsets, same exact integer counts for every
    generated candidate — to ``local_apriori(concat_dbs(batches), k_max,
    min_count)`` run from scratch, for every append history and every
    threshold.  Only the ``count_calls`` ledger differs: it counts the
    DEVICE passes this instance actually ran, which is the saving being
    bought.

    The batches live on ``device`` (None: the CUDA card; a host without
    one raises unless asked for ``"cpu"``).  ``version`` increments per
    append — the cache key a serving layer uses to guarantee a result is
    never served across a data change.
    """

    def __init__(self, n_items: int, backend: str = "torch", device: str | torch.device | None = None):
        _check_backend(backend)
        self.n_items = int(n_items)
        self.backend = backend
        self.device = resolve_device(device)
        self.version = 0  # bumped per append — the dataset_version key
        self._batches: list[TransactionDB] = []
        self._full: TransactionDB | None = None  # lazy concat of batches
        # cumulative exact counts over ALL appended transactions, for
        # every itemset ever counted (singletons always included)
        self._counts: dict[Itemset, int] = {(i,): 0 for i in range(self.n_items)}
        self.count_calls = 0  # lifetime device count passes (the ledger)

    @classmethod
    def from_db(cls, db: TransactionDB, backend: str = "torch") -> "DeltaApriori":
        """Seed incremental state from an already-packed DB, on its device
        (one singleton pass, no dense round-trip) — how a grid site wraps
        its local shard so per-level candidate counts serve from the
        cumulative cache."""
        st = cls(db.n_items, backend=backend, device=db.packed.device)
        sup1 = item_supports(db)
        st.count_calls += 1
        for item, c in enumerate(sup1):
            st._counts[(int(item),)] += int(c)
        st._batches.append(db)
        st._full = db
        st.version = 1
        return st

    @property
    def n_tx(self) -> int:
        return sum(db.n_tx for db in self._batches)

    def stream(self) -> TransactionDB:
        """The full appended stream as one DB (lazy concat, cached)."""
        if not self._batches:
            raise RuntimeError("DeltaApriori.stream before any append")
        if self._full is None:
            self._full = concat_dbs(self._batches)
        return self._full

    def uncached(self, itemsets: Iterable[Itemset]) -> list[Itemset]:
        """The subset of ``itemsets`` this state has never counted."""
        return [its for its in itemsets if its not in self._counts]

    def fold_exact(self, itemsets: Sequence[Itemset], counts) -> None:
        """Install exact full-stream counts computed EXTERNALLY (e.g. by a
        fused site-axis dispatch).  Caller contract: ``counts[i]`` is the
        support of ``itemsets[i]`` over the whole appended stream.
        Ledgers one device pass when non-empty."""
        if not itemsets:
            return
        self.count_calls += 1
        for its, c in zip(itemsets, counts):
            self._counts[its] = int(c)

    def counts_for(self, itemsets: Sequence[Itemset]) -> dict[Itemset, int]:
        """Exact cumulative counts for arbitrary itemsets, counting only
        the never-seen ones (at most one device pass); cached itemsets are
        served for free — the local-pass entry point for workloads that
        bring their own candidate lists (count-distribution Apriori)."""
        self._count_new(self.uncached(itemsets))
        return {its: self._counts[its] for its in itemsets}

    def append(self, dense_batch: np.ndarray) -> int:
        """Fold one appended transaction batch into the cumulative counts
        (one singleton pass + one cached-itemset count pass over the new
        batch only, packed onto this state's device) and bump ``version``.
        Returns the new version."""
        if dense_batch.shape[1] != self.n_items:
            raise ValueError(
                f"batch has {dense_batch.shape[1]} items, state tracks {self.n_items}"
            )
        db = TransactionDB.from_dense(np.asarray(dense_batch, dtype=bool), device=self.device)
        sup1 = item_supports(db)
        self.count_calls += 1
        for item, c in enumerate(sup1):
            self._counts[(int(item),)] += int(c)
        cached = [its for its in self._counts if len(its) > 1]
        if cached:
            sup = count_supports(db, cached, backend=self.backend)
            self.count_calls += 1
            for its, c in zip(cached, sup):
                self._counts[its] += int(c)
        self._batches.append(db)
        self._full = None
        self.version += 1
        return self.version

    def _count_new(self, cands: list[Itemset]) -> None:
        """Count never-seen candidates over the full stream (exact, so the
        cumulative-cache invariant extends to them)."""
        if not cands:
            return
        if self._full is None:
            self._full = concat_dbs(self._batches)
        sup = count_supports(self._full, cands, backend=self.backend)
        self.count_calls += 1
        for its, c in zip(cands, sup):
            self._counts[its] = int(c)

    def query(self, k_max: int, min_count: int) -> LocalMineResult:
        """Level-wise Apriori over everything appended so far, serving
        counts from the cumulative cache.  Returns a ``LocalMineResult``
        bit-identical (counts + frequents) to a from-scratch
        ``local_apriori`` over the concatenated stream; its
        ``count_calls`` field reports the device passes THIS query cost
        (0 when every candidate was already cached)."""
        if not self._batches:
            raise RuntimeError("DeltaApriori.query before any append")
        calls0 = self.count_calls
        counts: dict[Itemset, int] = {}
        frequent: dict[int, list[Itemset]] = {}
        n_cand = self.n_items
        for i in range(self.n_items):
            counts[(i,)] = self._counts[(i,)]
        frequent[1] = [(i,) for i in range(self.n_items) if counts[(i,)] >= min_count]
        level = 1
        while level < k_max and frequent.get(level):
            cands = apriori_join(frequent[level])
            level += 1
            if not cands:
                frequent[level] = []
                break
            fresh = [its for its in cands if its not in self._counts]
            n_cand += len(cands)
            if fresh and len(fresh) == len(cands):
                # cold level (every candidate is new — the first query on
                # freshly appended data): one fused count+threshold pass
                # serves counts AND frequents
                cnt, freq = count_supports_prune(
                    self.stream(), cands, min_count, backend=self.backend
                )
                self.count_calls += 1
                for its, c in zip(cands, cnt):
                    self._counts[its] = int(c)
                    counts[its] = int(c)
                frequent[level] = [its for its, f in zip(cands, freq) if f]
                continue
            self._count_new(fresh)
            for its in cands:
                counts[its] = self._counts[its]
            frequent[level] = [its for its in cands if counts[its] >= min_count]
        for lv in range(1, k_max + 1):
            frequent.setdefault(lv, [])
        return LocalMineResult(
            counts=counts,
            frequent=frequent,
            count_calls=self.count_calls - calls0,
            candidates_counted=n_cand,
        )


# ---------------------------------------------------------------------------
# Streaming top-k frequent itemsets (served via the delta path)
# ---------------------------------------------------------------------------


@dataclass
class TopKResult:
    """The ``top`` highest-support itemsets of sizes 1..k_max over the
    appended stream, with the support threshold the search settled at."""

    items: list[tuple[Itemset, int]]  # (itemset, exact count), best first
    threshold: int  # smallest min_count tried (all items have count >= it)
    k_max: int
    count_calls: int  # device passes THIS query cost (0 when fully cached)


def topk_itemsets(delta: DeltaApriori, k_max: int, top: int, floor: int = 1) -> TopKResult:
    """Top-``top`` frequent itemsets by support over a DeltaApriori
    stream, without the caller naming a support threshold.

    Threshold search by halving: start at the stream length and halve
    until at least ``top`` itemsets are frequent or the ``floor`` is
    reached.  Each probe is a ``DeltaApriori.query``, so repeated probes
    serve counts from the cumulative cache.  Deterministic: ties break by
    (higher count, smaller itemset, lexicographic items)."""
    if top < 1:
        raise ValueError(f"top must be >= 1, got {top}")
    if floor < 1:
        raise ValueError(f"floor must be >= 1, got {floor}")
    calls0 = delta.count_calls
    t = max(int(delta.n_tx), floor)
    while True:
        res = delta.query(k_max, t)
        found = [(its, res.counts[its]) for lv in sorted(res.frequent) for its in res.frequent[lv]]
        if len(found) >= top or t <= floor:
            break
        t = max(floor, t // 2)
    found.sort(key=lambda ic: (-ic[1], len(ic[0]), ic[0]))
    return TopKResult(items=found[:top], threshold=t, k_max=k_max, count_calls=delta.count_calls - calls0)


# ---------------------------------------------------------------------------
# Brute-force oracle (tests)
# ---------------------------------------------------------------------------


def bruteforce_frequent(dense_pooled: np.ndarray, k_max: int, min_count: int) -> dict[Itemset, int]:
    """Exhaustive frequent itemsets of sizes 1..k_max over a pooled dense
    DB, in numpy alone (no torch, no kernel).  Exponential — tests only.
    Uses downward closure for pruning."""
    n, m = dense_pooled.shape
    cols = dense_pooled.astype(bool)
    out: dict[Itemset, int] = {}
    level: list[tuple[Itemset, np.ndarray]] = []
    for i in range(m):
        c = int(cols[:, i].sum())
        if c >= min_count:
            out[(i,)] = c
            level.append(((i,), cols[:, i]))
    for _ in range(2, k_max + 1):
        nxt = []
        for cand in apriori_join([its for its, _ in level]):
            mask = np.ones(n, dtype=bool)
            for item in cand:
                mask &= cols[:, item]
            c = int(mask.sum())
            if c >= min_count:
                out[cand] = c
                nxt.append((cand, mask))
        level = nxt
        if not level:
            break
    return out
