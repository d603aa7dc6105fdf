"""K-mer prefilter: double-diagonal match + ungapped rescore.

Faithful re-implementation of the reference's prefiltering engine
(lib/mmseqs/src/prefiltering/) in vectorized numpy (host side; the hot
loops move to device kernels in ops/ as the data scales):

  * spaced 6-mers, pattern {1,1,0,1,0,1,0,0,1,1} (Sequence.h:24), over a
    20-letter alphabet (X excluded; Prefiltering.cpp:530-533)
  * targets are tantan-masked (IndexBuilder.cpp:131) and only k-mers with
    self-score >= kmerThr on the VTML80 8-bit-scaled seed matrix are
    indexed (IndexTable.h:144-152); postings carry (seqId, windowPos)
  * per query window: composition bias (float32 chain, VTML80 scale)
    shifts the k-mer threshold (QueryMatcher.cpp:230-236); similar k-mers
    enumerated via sorted 3-mer product tables with threshold pruning
    (KmerGenerator.cpp:104-230)
  * double-diagonal detection: an arrival-ordered hit is "double" when
    the previous hit of the same target had the same u8 diagonal —
    including the zero-init quirk where a first hit on diagonal 0 counts
    (CacheFriendlyOperations.cpp:193-208)
  * surviving (target, diagonal) pairs are rescored by an ungapped
    Kadane scan of the blosum62 2-bit profile (+bias/4) along the
    diagonal, clamped at 255 (UngappedAlignment.cpp:30-43,385-414)
  * per-target max score, histogram-capped at --max-seqs with
    min-ungapped-score 15 floor (QueryMatcher.h:206-216)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..constants import X_INDEX
from ..db.setdb import SetDB
from ..native import tantan_mask
from ..stats.submat import (SubstitutionMatrix, load_pinned_matrix,
                            load_substitution_matrix, local_aa_bias_correction)

SPACED_PATTERN_6 = np.array([0, 1, 3, 5, 8, 9], dtype=np.int32)
SPAN_6 = 10
KMER_SIZE = 6
SEED_ALPHA = 20          # X excluded from seeding
PART_POW = SEED_ALPHA ** 3

# spaced seed patterns per k (Sequence.h:24-33 spaced_seed_k)
KMER_PATTERNS = {
    6: SPACED_PATTERN_6,
    7: np.array([0, 1, 3, 5, 6, 9, 10], dtype=np.int32),
}
KMER_SPANS = {6: 10, 7: 11}


def kmer_pattern(kmer_size: int, spaced: bool = True) -> np.ndarray:
    """Seed pattern for one k: the spaced pattern (Sequence.h:24-33,
    --spaced-kmer-mode 1, the default) or the consecutive window
    (--spaced-kmer-mode 0, Sequence.cpp spacedKmer=false)."""
    if spaced:
        return KMER_PATTERNS[kmer_size]
    return np.arange(kmer_size, dtype=np.int32)


# IndexTable::computeKmerSize boundary (IndexTable.h:439-441); module
# constant so tests can scale it down and exercise the size-triggered
# k=7 path end-to-end without a 3.35 G-residue database
K7_THRESHOLD_RESIDUES = 3350000000


def compute_kmer_size(total_residues: int) -> int:
    """IndexTable::computeKmerSize (IndexTable.h:439-441): k=6 below
    ~3.35 G residues, k=7 above."""
    return 6 if total_residues < K7_THRESHOLD_RESIDUES else 7


def kmer_score_threshold(sensitivity: float, kmer_size: int = 6,
                         profile: bool = False) -> int:
    """Prefiltering::getKmerThreshold tables (Prefiltering.cpp:1020-1065);
    profile values are the no-context-pseudocount table."""
    if profile:
        table = {5: (108.8, 4.7), 6: (134.35, 6.15), 7: (149.15, 6.85)}
    else:
        table = {5: (160.75, 12.75), 6: (163.2, 8.917), 7: (186.15, 11.22)}
    base, per_step = table[kmer_size]
    return int(np.float32(base) - np.float32(sensitivity) * np.float32(per_step))


_SORT20_NETWORK: list[tuple[int, int]] = [
    # Util::rankedDescSort20's fixed sorting network (Util.cpp:88-114);
    # ties resolve exactly as the swap sequence dictates.
    (0, 16), (1, 17), (2, 18), (3, 19), (4, 12), (5, 13), (6, 14), (7, 15),
    (0, 8), (1, 9), (2, 10), (3, 11),
    (8, 16), (9, 17), (10, 18), (11, 19), (0, 4), (1, 5), (2, 6), (3, 7),
    (8, 12), (9, 13), (10, 14), (11, 15), (4, 16), (5, 17), (6, 18), (7, 19),
    (0, 2), (1, 3),
    (4, 8), (5, 9), (6, 10), (7, 11), (12, 16), (13, 17), (14, 18), (15, 19),
    (0, 1),
    (4, 6), (5, 7), (8, 10), (9, 11), (12, 14), (13, 15), (16, 18), (17, 19),
    (2, 16), (3, 17), (6, 12), (7, 13), (18, 19),
    (2, 8), (3, 9), (10, 16), (11, 17),
    (2, 4), (3, 5), (6, 8), (7, 9), (10, 12), (11, 13), (14, 16), (15, 17),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (12, 13), (14, 15), (16, 17),
    (1, 16), (3, 18), (5, 12), (7, 14),
    (1, 8), (3, 10), (9, 16), (11, 18),
    (1, 4), (3, 6), (5, 8), (7, 10), (9, 12), (11, 14), (13, 16), (15, 18),
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
    (17, 18),
]


def ranked_desc_sort20(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Network-sort each row of (L, 20) descending; returns (scores, idx)."""
    v = vals.astype(np.int16).copy()
    idx = np.tile(np.arange(SEED_ALPHA, dtype=np.int32), (v.shape[0], 1))
    for x, y in _SORT20_NETWORK:
        swap = v[:, x] < v[:, y]
        vx, vy = v[swap, x].copy(), v[swap, y].copy()
        v[swap, x], v[swap, y] = vy, vx
        ix, iy = idx[swap, x].copy(), idx[swap, y].copy()
        idx[swap, x], idx[swap, y] = iy, ix
    return v, idx


_ROW_BIG = np.int64(1) << 20


@dataclass
class SeedTables:
    """Sorted part-k-mer score tables (ExtendedSubstitutionMatrix
    equivalent): (R, R) with R = 20^part_size (8000 for 3-mers, 400 for
    the 2-mer tables of odd k)."""
    scores: np.ndarray   # (R, R) int16, per row sorted desc
    idx: np.ndarray      # (R, R) int16, part-k-mer indices per sorted row
    neg_flat: np.ndarray = None  # (-scores + row*2^20).ravel(), lazy (host engine only)

    @property
    def rowsize(self) -> int:
        return self.scores.shape[1]

    def _neg_flat(self) -> np.ndarray:
        if self.neg_flat is None:
            self.neg_flat = (
                -np.asarray(self.scores).astype(np.int64)
                + np.arange(self.rowsize,
                            dtype=np.int64)[:, None] * _ROW_BIG).ravel()
        return self.neg_flat

    def count_ge(self, rows: np.ndarray, cutoffs: np.ndarray) -> np.ndarray:
        """Per (row, cutoff) pair: how many entries of scores[row] are >= cutoff."""
        keys = rows.astype(np.int64) * _ROW_BIG + (-cutoffs.astype(np.int64))
        pos = np.searchsorted(self._neg_flat(), keys, side="right")
        return (pos - rows.astype(np.int64) * self.rowsize).astype(np.int64)


@lru_cache(maxsize=8)
def _build_part_tables(matrix_name: str, part: int) -> SeedTables:
    """Sorted part-k-mer product tables for part in {2, 3}
    (ExtendedSubstitutionMatrix two/three)."""
    from ..utils.cache import artifact_path, unique_tmp
    sc_path = artifact_path(f"seed{part}_{matrix_name}_scores.npy")
    id_path = artifact_path(f"seed{part}_{matrix_name}_idx.npy")
    if sc_path.exists() and id_path.exists():
        sorted_scores = np.load(sc_path, mmap_mode="r")
        order = np.load(id_path, mmap_mode="r")
    else:
        m = load_pinned_matrix(matrix_name)
        sub = m.sub_int[:SEED_ALPHA, :SEED_ALPHA].astype(np.int32)
        # scores[(x0..xp),(y0..yp)] = sum_i sub[xi, yi] with index packing
        # idx = sum_i xi * 20^i (Indexer.h:21-35)
        one = np.ones((SEED_ALPHA, SEED_ALPHA), dtype=np.int32)
        scores = np.zeros((SEED_ALPHA ** part,) * 2, dtype=np.int32)
        for i in range(part):
            # digit i (fastest = 0) varies with the i-th innermost factor
            t = sub
            for _ in range(i):
                t = np.kron(t, one)
            for _ in range(part - 1 - i):
                t = np.kron(one, t)
            scores = scores + t
        # tie order: the reference stable-sorts in cartesian-product order,
        # i.e. lexicographic in (x0..xp) — the digit-REVERSED packing
        # (ExtendedSubstitutionMatrix.cpp:38-56). rev is a bijection, so
        # the composite (-score, rev) key is unique and a plain unstable
        # argsort reproduces lexsort((rev, -score)) exactly.
        R = SEED_ALPHA ** part
        j = np.arange(R, dtype=np.int32)
        rev = np.zeros(R, dtype=np.int32)
        tmp = j.copy()
        for _ in range(part):
            rev = rev * SEED_ALPHA + tmp % SEED_ALPHA
            tmp = tmp // SEED_ALPHA
        key = (-scores << 13) + rev[None, :]
        order = np.argsort(key, axis=1, kind="quicksort").astype(np.int16)
        sorted_scores = np.take_along_axis(
            scores.astype(np.int16), order.astype(np.int64), axis=1)
        tmp_sc, tmp_id = unique_tmp(sc_path), unique_tmp(id_path)
        np.save(tmp_sc, sorted_scores)
        np.save(tmp_id, order)
        os.replace(tmp_sc, sc_path)
        os.replace(tmp_id, id_path)
        sorted_scores = np.load(sc_path, mmap_mode="r")
        order = np.load(id_path, mmap_mode="r")
    return SeedTables(scores=sorted_scores, idx=order)


def build_seed_tables(matrix_name: str = "vtml80_bf8_bias") -> SeedTables:
    return _build_part_tables(matrix_name, 3)


def build_seed_tables2(matrix_name: str = "vtml80_bf8_bias") -> SeedTables:
    return _build_part_tables(matrix_name, 2)


def kmer_parts(kmer_size: int) -> list[int]:
    """KmerGenerator::setDivideStrategy's reversed part sizes
    (KmerGenerator.cpp:41-88): k=6 -> [3,3]; k=7 (k%3==1) -> [2,2,3];
    k=8 (k%3==2) -> [2,3,3]."""
    n3 = kmer_size // 3
    if kmer_size % 3 == 0:
        parts = [3] * n3
    elif kmer_size % 3 == 1:
        parts = [3] * (n3 - 1) + [2, 2]
    else:
        parts = [3] * n3 + [2]
    return parts[::-1]


def spaced_kmers(seq: np.ndarray, kmer_size: int = 6,
                 pattern: np.ndarray | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """All spaced k-mer windows: returns (window_starts, kmer_residues (N,k))."""
    if pattern is None:
        pattern = KMER_PATTERNS[kmer_size]
    span = int(pattern[-1]) + 1
    L = len(seq)
    n = L - span + 1
    if n <= 0:
        return np.empty(0, np.int32), np.empty((0, kmer_size), np.uint8)
    starts = np.arange(n, dtype=np.int32)
    cols = starts[:, None] + pattern[None, :]
    return starts, seq[cols]


def pack_kmers(kmers: np.ndarray) -> np.ndarray:
    """Indexer::int2index packing: idx = sum kmer[i] * 20^i (Indexer.h:21-90)."""
    powers = SEED_ALPHA ** np.arange(kmers.shape[1], dtype=np.int64)
    return (kmers.astype(np.int64) * powers[None, :]).sum(axis=1)


def mask_sequences(db: SetDB, seed_matrix: SubstitutionMatrix) -> list[np.ndarray]:
    """tantan-masked copies of all sequences (Masker semantics)."""
    ratio = seed_matrix.prob / (seed_matrix.p_back[:, None]
                                * seed_matrix.p_back[None, :])
    return [tantan_mask(db.sequence(k), ratio, X_INDEX)
            for k in range(db.size)]


class KmerIndex:
    """Dense sorted k-mer posting index over the (masked) target DB."""

    def __init__(self, target_db: SetDB, kmer_thr: int,
                 seed_matrix: SubstitutionMatrix | None = None,
                 mask: bool = True, kmer_size: int = 6,
                 pattern: np.ndarray | None = None):
        self.tdb = target_db
        self.seed = seed_matrix or load_pinned_matrix("vtml80_bf8_bias")
        self.kmer_thr = kmer_thr
        self.kmer_size = kmer_size
        self.pattern = (pattern if pattern is not None
                        else KMER_PATTERNS[kmer_size])
        self.masked = (mask_sequences(target_db, self.seed) if mask
                       else [target_db.sequence(k) for k in range(target_db.size)])

        # concatenated masked target residues for vectorized rescore
        lens = np.array([len(s) for s in self.masked], dtype=np.int64)
        self.t_offsets = np.concatenate(([0], np.cumsum(lens)))[:-1]
        self.t_data = (np.concatenate(self.masked) if self.masked
                       else np.empty(0, np.uint8))
        # native parallel build (IndexBuilder::fillDatabase analog);
        # emits postings in (kmer, seq, pos) order — the numpy build
        # (_build_postings, kept for the parity test) costs ~10 s on
        # genome-scale DBs.  The posting-range structure is a compact
        # hash + occupancy bitmap, NOT a dense 20^6 offset table: two
        # 256 MB fresh tables per process cost seconds of first-touch
        # page faults on the target host.
        from ..native import build_kmer_index
        km, sid, pos = build_kmer_index(
            self.t_data, self.t_offsets, lens.astype(np.int32),
            np.diagonal(self.seed.sub_int).astype(np.int32),
            X_INDEX, self.kmer_thr, kmer_size=self.kmer_size,
            pattern=self.pattern)
        self.kmers = km.astype(np.int64)
        self.seq_ids = sid
        self.positions = pos
        self._finish_hash()

    def _build_postings(self, lens: np.ndarray) -> None:
        """All-sequences-at-once window extraction over the concatenated
        token array (the per-sequence loop is the build bottleneck on
        genome-scale DBs)."""
        diag_score = np.diagonal(self.seed.sub_int).astype(np.int32)
        empty = (np.empty(0, np.int64), np.empty(0, np.int32),
                 np.empty(0, np.int32))
        data = self.t_data
        L = len(data)
        n_seq = len(lens)
        pattern = self.pattern
        span = int(pattern[-1]) + 1
        if L < span or n_seq == 0:
            self.kmers, self.seq_ids, self.positions = empty
            return
        seq_of = np.repeat(np.arange(n_seq, dtype=np.int32), lens)
        starts = np.arange(L - span + 1, dtype=np.int64)
        # windows must not straddle a sequence boundary
        ok = seq_of[starts] == seq_of[starts + span - 1]
        kmers6 = data[starts[:, None] + pattern[None, :].astype(np.int64)]
        ok &= ~(kmers6 == X_INDEX).any(axis=1)
        if self.kmer_thr > 0:
            # only k-mers with self-score >= threshold are indexed
            # (IndexTable.h:144-152)
            self_scores = diag_score[kmers6.astype(np.int64)].sum(axis=1)
            ok &= self_scores >= self.kmer_thr
        starts = starts[ok]
        if len(starts) == 0:
            self.kmers, self.seq_ids, self.positions = empty
            return
        packed = pack_kmers(kmers6[ok])
        sid = seq_of[starts]
        pos = (starts - self.t_offsets[sid]).astype(np.int32)
        # only the FIRST occurrence of a k-mer per sequence is indexed
        # (IndexTable::addSequence dedups on kmerIdx != prevKmer after
        # a (kmer, pos) sort; IndexTable.h:332-345); the final posting
        # order is (kmer, seq, pos)
        order = np.lexsort((pos, sid, packed))
        packed = packed[order]
        sid = sid[order]
        pos = pos[order]
        first = np.concatenate(
            ([True], (packed[1:] != packed[:-1]) | (sid[1:] != sid[:-1])))
        self.kmers = packed[first]
        self.seq_ids = sid[first]
        self.positions = pos[first]

    def _finish_hash(self) -> None:
        # compact posting-range hash + occupancy bitmap for the native
        # match engine (the python paths binary-search the sorted
        # posting column directly)
        from ..native import build_kmer_hash
        self.hkeys, self.hoff, self.hcnt, self.occupied = build_kmer_hash(
            self.kmers.astype(np.int32), SEED_ALPHA ** self.kmer_size)

    def lookup_ranges(self, query_kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        lo = np.searchsorted(self.kmers, query_kmers, side="left")
        hi = np.searchsorted(self.kmers, query_kmers, side="right")
        return lo, hi

    # -- persistence (the PrefilteringIndexReader analog,
    #    lib/mmseqs/src/prefiltering/PrefilteringIndexReader.cpp): the
    #    sorted postings + masked tokens are saved; the dense offset
    #    table is rebuilt on load (the native fill takes ~0.15 s, far
    #    cheaper than persisting 256 MB). The cache key carries the
    #    build settings + DB shape.
    FORMAT_VERSION = 2

    def save(self, path: str | Path) -> None:
        from ..utils.cache import unique_tmp
        path = Path(path)
        tmp = unique_tmp(path)
        np.savez(tmp, version=self.FORMAT_VERSION, kmer_thr=self.kmer_thr,
                 kmer_size=self.kmer_size,
                 n_seqs=self.tdb.size, total_res=self.tdb.total_residues,
                 kmers=self.kmers.astype(np.int32),
                 seq_ids=self.seq_ids, positions=self.positions,
                 t_data=self.t_data, t_offsets=self.t_offsets)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str | Path, target_db: SetDB, kmer_thr: int,
             seed_matrix: SubstitutionMatrix | None = None,
             kmer_size: int = 6,
             pattern: np.ndarray | None = None) -> "KmerIndex | None":
        try:
            z = np.load(path)
        except (OSError, ValueError):
            return None
        if (int(z["version"]) != cls.FORMAT_VERSION
                or int(z["kmer_thr"]) != kmer_thr
                or int(z.get("kmer_size", 6)) != kmer_size
                or int(z["n_seqs"]) != target_db.size
                or int(z["total_res"]) != target_db.total_residues):
            return None
        self = cls.__new__(cls)
        self.tdb = target_db
        self.seed = seed_matrix or load_pinned_matrix("vtml80_bf8_bias")
        self.kmer_thr = kmer_thr
        self.kmer_size = kmer_size
        self.pattern = (pattern if pattern is not None
                        else KMER_PATTERNS[kmer_size])
        self.t_data = z["t_data"]
        self.t_offsets = z["t_offsets"]
        bounds = np.concatenate((self.t_offsets, [len(self.t_data)]))
        self.masked = [self.t_data[bounds[i]:bounds[i + 1]]
                       for i in range(target_db.size)]
        self.kmers = z["kmers"].astype(np.int64)
        self.seq_ids = z["seq_ids"]
        self.positions = z["positions"]
        self._finish_hash()
        return self


@dataclass
class PrefilterHit:
    seq_id: int
    score: int
    diagonal: int  # u16 semantics (i - j wrapped)


class PrefilterEngine:
    def __init__(self, query_db: SetDB, target_db: SetDB,
                 sensitivity: float = 5.7,
                 max_seqs: int = 300,
                 min_diag_score: int = 15,
                 same_qt_db: bool | None = None,
                 comp_bias_correction: bool = True,
                 mask: bool = True,
                 cov_thr: float = 0.0,
                 cov_mode: int = 0,
                 query_profiles: dict[int, np.ndarray] | None = None,
                 index: "KmerIndex | None" = None,
                 seed_matrix_name: str = "vtml80_bf8_bias",
                 ungapped_matrix_name: str = "blosum62_bf2_bias",
                 kmer_thr: int | None = None,
                 kmer_size: int | None = None,
                 spaced_kmer_mode: int = 1):
        """`query_profiles` maps query keys to (L, 20) int16 PSSM scores
        (the 8-bit-scaled profile_score rows, Sequence.cpp:241-264); such
        queries use per-position k-mer generation, the profile k-mer
        threshold table, and no composition bias. An existing `index` can
        be shared across engines (iterative search reuses the target index)."""
        self.qdb = query_db
        self.tdb = target_db
        self.query_profiles = query_profiles or {}
        # the prefilter builds matrices with scoreBias=-0.2 (Prefiltering.cpp:992)
        self.seed = load_pinned_matrix(seed_matrix_name)
        self.ungapped = load_pinned_matrix(ungapped_matrix_name)
        # k auto-raises to 7 on >3.35 G-residue DBs
        # (IndexTable::computeKmerSize, IndexTable.h:439-441)
        self.kmer_size = (kmer_size if kmer_size is not None
                          else compute_kmer_size(target_db.total_residues))
        self.spaced_kmer_mode = spaced_kmer_mode
        self.pattern = kmer_pattern(self.kmer_size, spaced_kmer_mode != 0)
        self.kmer_thr = (kmer_thr if kmer_thr is not None
                         else kmer_score_threshold(
                             sensitivity, self.kmer_size,
                             profile=bool(self.query_profiles)))
        self.max_seqs = max_seqs
        self.min_diag_score = min_diag_score
        self.comp_bias = comp_bias_correction
        self.cov_thr = cov_thr
        self.cov_mode = cov_mode
        self.same_qt_db = (same_qt_db if same_qt_db is not None
                           else query_db is target_db)
        self.tables = build_seed_tables(seed_matrix_name)
        self.tables2 = (build_seed_tables2(seed_matrix_name)
                        if self.kmer_size % 3 != 0 else None)
        # NB the index seeding threshold uses the SEQUENCE k-mer threshold
        # even for profile queries (localKmerThr logic, Prefiltering.cpp:525-528
        # keeps kmerThr; with profile queries localKmerThr becomes 0)
        index_thr = 0 if self.query_profiles else self.kmer_thr
        if index is not None:
            self.index = index
        else:
            self.index = None
            cache = None
            if getattr(target_db, "path", None):
                from pathlib import Path as _P
                import hashlib as _h
                # cheap content fingerprint: first/last residue bytes +
                # offsets, so a same-shaped DB with different contents
                # cannot load a stale index (ADVICE r2)
                sd = target_db.seq_data
                fp = _h.sha1(sd[:4096].tobytes() + sd[-4096:].tobytes()
                             + target_db.offsets.tobytes()).hexdigest()[:10]
                sp = ("" if spaced_kmer_mode != 0
                      else f"_sp{spaced_kmer_mode}")
                cache = (_P(target_db.path)
                         / f"kmeridx_k{self.kmer_size}_t{index_thr}"
                           f"_m{int(mask)}_{seed_matrix_name}{sp}_{fp}.npz")
                if cache.exists():
                    self.index = KmerIndex.load(cache, target_db, index_thr,
                                                self.seed,
                                                kmer_size=self.kmer_size,
                                                pattern=self.pattern)
            if self.index is None:
                self.index = KmerIndex(target_db, index_thr, self.seed,
                                       mask=mask, kmer_size=self.kmer_size,
                                       pattern=self.pattern)
                if cache is not None:
                    try:
                        self.index.save(cache)
                    except OSError:
                        pass
        self._bin_count = compute_bin_count(target_db.size)
        # target residue data (masked) padded into one array for rescore
        self._tseqs = self.index.masked
        self._tlens = target_db.lengths

    # ------------------------------------------------------------------
    def _expand_kmers(self, kmers: np.ndarray, thr: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
        """generateKmerList over all windows at once: every k-mer with
        score >= thr[w], in exact generation order (part 0 major, each
        level's entries by score desc; KmerGenerator.cpp:104-230 with
        the reversed divide strategy).  Returns (window_idx, kmer)."""
        parts = kmer_parts(self.kmer_size)
        tables = [self.tables if p == 3 else self.tables2 for p in parts]
        W = len(kmers)
        k64 = kmers.astype(np.int64)
        rows, mults = [], []
        col = 0
        for p in parts:
            r = np.zeros(W, dtype=np.int64)
            for i in range(p):
                r += k64[:, col + i] * (SEED_ALPHA ** i)
            rows.append(r)
            mults.append(SEED_ALPHA ** col)
            col += p
        best = [tables[i].scores[rows[i], 0].astype(np.int64)
                for i in range(len(parts))]
        # rest[l][w] = max attainable score from levels > l
        rest = [np.zeros(W, dtype=np.int64)]
        for b in best[:0:-1]:
            rest.insert(0, rest[0] + b)

        w_idx = np.arange(W, dtype=np.int64)
        score = np.zeros(W, dtype=np.int64)
        kmer = np.zeros(W, dtype=np.int64)
        for lvl, tab in enumerate(tables):
            row = rows[lvl][w_idx]
            cut = thr[w_idx] - score - rest[lvl][w_idx]
            n = tab.count_ge(row, cut)
            if n.sum() == 0:
                return np.empty(0, np.int64), np.empty(0, np.int64)
            rep = np.repeat(np.arange(len(w_idx)), n)
            j = _ragged_arange(n)
            score = score[rep] + tab.scores[row[rep], j].astype(np.int64)
            kmer = kmer[rep] + (tab.idx[row[rep], j].astype(np.int64)
                                * mults[lvl])
            w_idx = w_idx[rep]
        return w_idx, kmer

    # ------------------------------------------------------------------
    def _raw_hits(self, qkey: int, bias_f32: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
        """All posting hits (seq, diag-u16) in exact arrival order:
        windows ascending, similar k-mers in generation order, postings in
        index order — fully vectorized."""
        qseq = self.qdb.sequence(qkey)
        starts, kmers = spaced_kmers(qseq, self.kmer_size,
                                     pattern=self.pattern)
        valid = ~(kmers == X_INDEX).any(axis=1)
        starts = starts[valid]
        kmers = kmers[valid]
        W = len(starts)
        empty = (np.empty(0, np.int32), np.empty(0, np.uint16))
        if W == 0:
            return empty

        # f32 sequential bias sum over the k pattern positions, then the
        # C double +/-0.5 truncation (QueryMatcher.cpp:230-236)
        b = np.zeros(W, dtype=np.float32)
        for p in self.pattern:
            b = (b + bias_f32[starts + p]).astype(np.float32)
        bd = b.astype(np.float64)
        biasv = np.where(bd < 0.0, bd - 0.5, bd + 0.5).astype(np.int16)
        thr = np.maximum(self.kmer_thr - biasv.astype(np.int64), 0)

        w_all, kmers_all = self._expand_kmers(kmers, thr)
        if len(kmers_all) == 0:
            return empty

        lo, hi = self.index.lookup_ranges(kmers_all)
        cnt = hi - lo
        if cnt.sum() == 0:
            return empty
        k_rep = np.repeat(np.arange(len(kmers_all)), cnt)
        off = _ragged_arange(cnt)
        take = lo[k_rep] + off
        seqs = self.index.seq_ids[take]
        diags = ((starts[w_all[k_rep]] - self.index.positions[take])
                 & 0xFFFF).astype(np.uint16)
        return seqs, diags

    def _raw_hits_profile(self, qkey: int) -> tuple[np.ndarray, np.ndarray]:
        """Profile-query hit events: per-position k-mer product generation
        (KmerGenerator with per-position ScoreMatrix rows,
        Sequence::nextProfileKmer + KmerGenerator.cpp:30-38,104-167)."""
        qseq = self.qdb.sequence(qkey)
        pssm = self.query_profiles[qkey]          # (L, 20) int16
        sc_sorted, idx_sorted = ranked_desc_sort20(pssm)
        starts, kmers = spaced_kmers(qseq)
        empty = (np.empty(0, np.int32), np.empty(0, np.uint16))
        if len(starts) == 0:
            return empty
        valid = ~(kmers == X_INDEX).any(axis=1)
        powers = SEED_ALPHA ** np.arange(KMER_SIZE, dtype=np.int64)

        hit_seqs, hit_diags = [], []
        for w in starts[valid]:
            pos = w + SPACED_PATTERN_6
            rows_s = sc_sorted[pos].astype(np.int64)   # (6, 20) desc
            rows_i = idx_sorted[pos].astype(np.int64)
            best = rows_s[:, 0]
            rest = np.concatenate((np.cumsum(best[::-1])[::-1][1:], [0]))
            # nested product with per-level threshold pruning
            part_scores = np.zeros(1, dtype=np.int64)
            part_kmers = np.zeros(1, dtype=np.int64)
            dead = False
            for p in range(KMER_SIZE):
                cut = self.kmer_thr - part_scores - rest[p]
                n_p = np.searchsorted(-rows_s[p], -cut, side="right")
                total = int(n_p.sum())
                if total == 0:
                    dead = True
                    break
                rep = np.repeat(np.arange(len(part_scores)), n_p)
                j = _ragged_arange(n_p)
                part_scores = part_scores[rep] + rows_s[p][j]
                part_kmers = part_kmers[rep] + rows_i[p][j] * powers[p]
            if dead:
                continue
            lo, hi = self.index.lookup_ranges(part_kmers)
            cnt = hi - lo
            if cnt.sum() == 0:
                continue
            k_rep = np.repeat(np.arange(len(part_kmers)), cnt)
            off = _ragged_arange(cnt)
            take = lo[k_rep] + off
            hit_seqs.append(self.index.seq_ids[take])
            hit_diags.append(((w - self.index.positions[take])
                              & 0xFFFF).astype(np.uint16))
        if not hit_seqs:
            return empty
        return np.concatenate(hit_seqs), np.concatenate(hit_diags)

    def match_all(self, qkeys: list[int] | None = None
                  ) -> dict[int, list[PrefilterHit]]:
        """Batch prefilter over many queries via the native OpenMP engine
        (native/prefilter_engine.cpp) — semantics identical to
        match_query (tested by tests/test_prefilter_native.py).  Profile
        queries run through the native per-position-beam matcher
        (prefilter_match_profile_batch; the reference runs profiles in
        the same hot loop, QueryMatcher.cpp:249-253)."""
        if qkeys is None:
            qkeys = list(range(self.qdb.size))
        seq_keys = [qk for qk in qkeys if qk not in self.query_profiles]
        prof_keys = [qk for qk in qkeys if qk in self.query_profiles]
        out: dict[int, list[PrefilterHit]] = {}
        if prof_keys:
            out.update(self._match_profiles_native(prof_keys))
        if not seq_keys:
            return out
        # identity semantics need batch row -> target key mapping, which
        # the native engine supports for contiguous ranges
        contiguous = (seq_keys ==
                      list(range(seq_keys[0], seq_keys[0] + len(seq_keys))))
        if not contiguous and self.same_qt_db:
            for qk in seq_keys:
                out[qk] = self.match_query(qk)
            return out
        if contiguous:
            out.update(self.match_range(seq_keys[0],
                                        seq_keys[0] + len(seq_keys)))
            return out
        seqs = [self.qdb.sequence(qk) for qk in seq_keys]
        qdata = (np.concatenate(seqs).astype(np.uint8) if seqs
                 else np.empty(0, np.uint8))
        qlens = np.array([len(s) for s in seqs], dtype=np.int32)
        qoffs = np.concatenate(([0], np.cumsum(qlens, dtype=np.int64)))[:-1]
        out.update(dict(zip(seq_keys,
                            self._match_native(qdata, qoffs, qlens, -1))))
        return out

    def _match_profiles_native(self, pkeys: list[int]
                               ) -> dict[int, list[PrefilterHit]]:
        """Profile queries through the native batch engine (VERDICT r3
        missing #4): ranked PSSM rows + the per-position product beam,
        pssm/4 rescore, identity slot by explicit per-row key."""
        from ..native import prefilter_match_profile_batch
        pssms = [np.ascontiguousarray(self.query_profiles[qk],
                                      dtype=np.int16) for qk in pkeys]
        lens = np.array([p.shape[0] for p in pssms], dtype=np.int32)
        qoffs = np.concatenate(
            ([0], np.cumsum(lens, dtype=np.int64)))
        cat = (np.concatenate(pssms) if pssms
               else np.empty((0, 20), np.int16))
        rs, ri = ranked_desc_sort20(cat)
        qseq = (np.concatenate([self.qdb.sequence(qk) for qk in pkeys])
                if pkeys else np.empty(0, np.uint8))
        identity = (np.array(pkeys, dtype=np.int32) if self.same_qt_db
                    else None)
        idx = self.index
        o_seq, o_score, o_diag, o_cnt, _raw = prefilter_match_profile_batch(
            np.ascontiguousarray(rs, dtype=np.int16),
            np.ascontiguousarray(ri.astype(np.uint8)),
            np.ascontiguousarray(cat, dtype=np.int16),
            np.ascontiguousarray(qseq, dtype=np.uint8), X_INDEX,
            qoffs, lens,
            idx.hkeys, idx.hoff, idx.hcnt, idx.occupied,
            np.ascontiguousarray(idx.seq_ids, dtype=np.int32),
            np.ascontiguousarray(idx.positions, dtype=np.int32),
            np.ascontiguousarray(idx.t_data, dtype=np.uint8),
            np.ascontiguousarray(idx.t_offsets, dtype=np.int64),
            np.ascontiguousarray(self._tlens, dtype=np.int32),
            21, self.kmer_thr, self.max_seqs, self.min_diag_score,
            self._bin_count, identity, self.cov_thr, self.cov_mode,
            kmer_size=self.kmer_size)
        out: dict[int, list[PrefilterHit]] = {}
        for bi, qk in enumerate(pkeys):
            n = int(o_cnt[bi])
            base = bi * self.max_seqs
            out[qk] = [PrefilterHit(seq_id=int(o_seq[base + i]),
                                    score=int(o_score[base + i]),
                                    diagonal=int(o_diag[base + i]))
                       for i in range(n)]
        return out

    def match_range(self, start: int, end: int
                    ) -> dict[int, list[PrefilterHit]]:
        """Prefilter a contiguous query-key range (the streaming driver's
        unit of work; identity semantics preserved via identity_base)."""
        qdb = self.qdb
        qoffs_all = qdb.offsets
        qdata = np.ascontiguousarray(
            qdb.seq_data[qoffs_all[start]:qoffs_all[end]], dtype=np.uint8)
        qoffs = np.ascontiguousarray(
            qoffs_all[start:end] - qoffs_all[start], dtype=np.int64)
        qlens = np.ascontiguousarray(qdb.lengths[start:end], dtype=np.int32)
        base = start if self.same_qt_db else -1
        hits = self._match_native(qdata, qoffs, qlens, base)
        return {start + i: h for i, h in enumerate(hits)}

    def _match_native(self, qdata, qoffs, qlens, identity_base
                      ) -> list[list[PrefilterHit]]:
        from ..native import prefilter_match_batch
        idx = self.index
        o_seq, o_score, o_diag, o_cnt, _raw = prefilter_match_batch(
            qdata, qoffs, qlens,
            np.ascontiguousarray(self.seed.sub_int, dtype=np.int32),
            np.ascontiguousarray(self.seed.p_back, dtype=np.float64),
            self.comp_bias,
            np.ascontiguousarray(self.tables.scores, dtype=np.int16),
            np.ascontiguousarray(self.tables.idx, dtype=np.int16),
            idx.hkeys, idx.hoff, idx.hcnt, idx.occupied,
            np.ascontiguousarray(idx.seq_ids, dtype=np.int32),
            np.ascontiguousarray(idx.positions, dtype=np.int32),
            np.ascontiguousarray(idx.t_data, dtype=np.uint8),
            np.ascontiguousarray(idx.t_offsets, dtype=np.int64),
            np.ascontiguousarray(self._tlens, dtype=np.int32),
            np.ascontiguousarray(self.ungapped.sub_int, dtype=np.int32),
            X_INDEX, self.kmer_thr, self.max_seqs, self.min_diag_score,
            self._bin_count, identity_base, self.cov_thr, self.cov_mode,
            kmer_size=self.kmer_size, pattern=self.pattern,
            sc2=(np.ascontiguousarray(self.tables2.scores, dtype=np.int16)
                 if self.tables2 is not None else None),
            id2=(np.ascontiguousarray(self.tables2.idx, dtype=np.int16)
                 if self.tables2 is not None else None))
        n_q = len(qlens)
        out = []
        for bi in range(n_q):
            n = int(o_cnt[bi])
            base = bi * self.max_seqs
            out.append([PrefilterHit(seq_id=int(o_seq[base + i]),
                                     score=int(o_score[base + i]),
                                     diagonal=int(o_diag[base + i]))
                        for i in range(n)])
        # prefilter statistics (the printStatistics analog,
        # Prefiltering.cpp:953-975), accumulated across streamed chunks
        counts = np.asarray(o_cnt[:n_q], dtype=np.int64)
        prev = getattr(self, "stats", None) or {
            "db_matches": 0, "sum_passed": 0, "empty_lists": 0,
            "queries": 0, "_counts": []}
        prev.setdefault("_counts", [])
        prev["db_matches"] = prev.get("db_matches", 0) + int(_raw)
        prev["sum_passed"] = prev.get("sum_passed", 0) + int(counts.sum())
        prev["empty_lists"] += int((counts == 0).sum())
        prev["queries"] += n_q
        prev["_counts"].append(counts)
        nq = max(1, prev["queries"])
        prev["db_matches_per_seq"] = prev["db_matches"] // nq
        prev["passed_per_seq"] = prev["sum_passed"] / nq
        prev["median_result_list"] = int(
            np.median(np.concatenate(prev["_counts"])))
        self.stats = prev
        return out

    def match_query(self, qkey: int) -> list[PrefilterHit]:
        qseq = self.qdb.sequence(qkey)
        L = len(qseq)
        if qkey in self.query_profiles or not self.comp_bias:
            bias_f32 = np.zeros(L, dtype=np.float32)
        else:
            bias_f32 = local_aa_bias_correction(qseq, self.seed.sub_int,
                                                self.seed.p_back, 1.0)

        if qkey in self.query_profiles:
            seqs, diags = self._raw_hits_profile(qkey)
        else:
            seqs, diags = self._raw_hits(qkey, bias_f32)
        cand_seq, cand_diag, cand_arrival = _find_double_diagonals(seqs, diags)
        scores = self._rescore(qkey, bias_f32, cand_seq, cand_diag)

        # per-target max score (keepMaxScoreElementOnly)
        hits = _per_target_max(cand_seq, cand_diag, scores, cand_arrival,
                               self._bin_count)

        # histogram threshold (computeScoreThreshold) with identity slot
        thr = _score_threshold(hits, self.max_seqs)
        thr = max(self.min_diag_score, thr)

        out: list[PrefilterHit] = []
        identity = qkey if self.same_qt_db else None
        if identity is not None:
            out.append(PrefilterHit(seq_id=identity, score=65535, diagonal=0))
        # stable counting sort desc by score over the bin-major detection
        # stream (radixSortByScoreSize, QueryMatcher.cpp:498-523); the
        # --max-seqs cap then truncates in this order
        order = np.argsort(-hits[:, 2].astype(np.int64), kind="stable")
        for i in order:
            sid, diag, score = int(hits[i, 0]), int(hits[i, 1]), int(hits[i, 2])
            if len(out) >= self.max_seqs:
                break
            if score >= thr and sid != (identity if identity is not None else -1):
                if score >= 255:
                    # exact unclamped rescore (getResult, QueryMatcher.cpp:406-413;
                    # queryBias is 0, UngappedAlignment.h:34-36)
                    score = self._rescore(qkey, bias_f32,
                                          np.array([sid]), np.array([diag]),
                                          clamp=False)[0]
                out.append(PrefilterHit(seq_id=sid, score=int(score), diagonal=diag))

        # length-based coverage filter applied at output, AFTER the max-seqs
        # cap (Prefiltering.cpp:856-864)
        if self.cov_thr > 0.0 and self.cov_mode in (0, 2, 5):
            qlen = np.float32(L)
            kept = []
            for h in out:
                tlen = np.float32(self._tlens[h.seq_id])
                if self.cov_mode == 0:
                    ok = (qlen / tlen >= np.float32(self.cov_thr)
                          and tlen / qlen >= np.float32(self.cov_thr))
                elif self.cov_mode == 2:
                    ok = tlen / qlen >= np.float32(self.cov_thr)
                else:
                    ok = (min(tlen, qlen) / max(tlen, qlen)
                          >= np.float32(self.cov_thr))
                if ok:
                    kept.append(h)
            out = kept
        return out

    # ------------------------------------------------------------------
    def _rescore(self, qkey: int, bias_f32: np.ndarray, cand_seq: np.ndarray,
                 cand_diag: np.ndarray, clamp: bool = True) -> np.ndarray:
        """Ungapped diagonal Kadane rescore, clamped at 255 (A.1)."""
        qseq = self.qdb.sequence(qkey)
        L = len(qseq)
        if qkey in self.query_profiles:
            # alignment profile = pssm/4 (C truncation), X column 0
            # (Sequence.cpp:271-280, UngappedAlignment.cpp:399-404)
            pssm = self.query_profiles[qkey].astype(np.int32)
            profile = np.zeros((L, 21), dtype=np.int32)
            profile[:, :20] = np.trunc(pssm / 4).astype(np.int32)
        else:
            # profile: blosum62-2bit + char(bias/4 +/- 0.5) (UngappedAlignment.cpp:392-414)
            corr = bias_f32.astype(np.float64) / 4.0
            corr = np.where(corr < 0.0, corr - 0.5, corr + 0.5).astype(np.int8)
            profile = (self.ungapped.sub_int[qseq].astype(np.int32)
                       + corr[:, None].astype(np.int32))  # (L, 21)

        C = len(cand_seq)
        scores = np.zeros(C, dtype=np.int32)
        if C == 0:
            return scores
        d16 = cand_diag.astype(np.int64) & 0xFFFF
        min_dist = np.minimum((0 - d16) & 0xFFFF, d16)
        tl = self._tlens[cand_seq].astype(np.int64)
        pos_diag = d16 < 0x8000  # diagonal >= 0 as short
        # segment geometry (UngappedAlignment.cpp:364-369,415-430)
        seg = np.where(pos_diag,
                       np.where(min_dist < L, np.minimum(tl, L - min_dist), 0),
                       np.where(min_dist < tl, np.minimum(tl - min_dist, L), 0))
        q_off = np.where(pos_diag, min_dist, 0)
        t_off = np.where(pos_diag, 0, min_dist)

        Lmax = int(seg.max())
        if Lmax == 0:
            return scores
        ar = np.arange(Lmax, dtype=np.int64)
        mask = ar[None, :] < seg[:, None]
        qpos = np.minimum(q_off[:, None] + ar[None, :], L - 1)
        tpos = self.index.t_offsets[cand_seq][:, None] + np.minimum(
            t_off[:, None] + ar[None, :],
            np.maximum(tl[:, None] - 1, 0))
        t_res = self.index.t_data[tpos]
        vals = profile[qpos, t_res.astype(np.int64)] * mask
        c = np.cumsum(vals, axis=1)
        run_min = np.minimum.accumulate(
            np.concatenate([np.zeros((C, 1), c.dtype), c[:, :-1]], axis=1),
            axis=1)
        best = (c - np.minimum(run_min, 0)).max(axis=1)
        best = np.where(seg > 0, np.maximum(best, 0), 0)
        if clamp:
            best = np.minimum(best, 255)
        return best.astype(np.int32)


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


def compute_bin_count(db_size: int) -> int:
    """QueryMatcher::initDiagonalMatcher's L2-derived bin count
    (QueryMatcher.cpp:424-451); affects only the order of tie-scored hits
    at the --max-seqs cut."""
    try:
        import os
        l2 = os.sysconf("SC_LEVEL2_CACHE_SIZE")
        if l2 <= 0:
            l2 = 2 * 1024 * 1024
    except (ValueError, OSError):
        l2 = 2 * 1024 * 1024
    for n in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024):
        if db_size // n < l2:
            return n
    return 2048


def _find_double_diagonals(seqs: np.ndarray, diags: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Arrival-order double-diagonal detection + consecutive dedup
    (CacheFriendlyOperations::findDuplicates, computeTotalScore=false)."""
    if len(seqs) == 0:
        return (np.empty(0, np.int32), np.empty(0, np.uint16),
                np.empty(0, np.int64))
    diag8 = (diags & 0xFF).astype(np.uint8)
    order = np.argsort(seqs, kind="stable")  # per-seq arrival order preserved
    s_sorted = seqs[order]
    d_sorted = diag8[order]
    first = np.concatenate(([True], s_sorted[1:] != s_sorted[:-1]))
    prev = np.concatenate(([0], d_sorted[:-1]))
    # zero-init quirk: first element of a seq matches prev diag 0
    detected = np.where(first, d_sorted == 0, d_sorted == prev)

    det_idx = np.nonzero(detected)[0]
    if len(det_idx) == 0:
        return (np.empty(0, np.int32), np.empty(0, np.uint16),
                np.empty(0, np.int64))
    ds = s_sorted[det_idx]
    dd = d_sorted[det_idx]
    dfull = diags[order][det_idx]
    arrival = order[det_idx]  # global arrival position of each detection
    # phase 2: drop consecutive same-diag duplicates per seq
    first2 = np.concatenate(([True], ds[1:] != ds[:-1]))
    prev2 = np.concatenate(([0], dd[:-1]))
    keep = first2 | (dd != prev2)
    ds = ds[keep]
    dfull = dfull[keep]
    arrival = arrival[keep]
    # dedupe (seq, diag) keeping the FIRST occurrence in per-seq arrival
    # order — keepMaxElement later keeps the first max-scored entry
    # (CacheFriendlyOperations.cpp:358-377)
    key = ds.astype(np.int64) * (1 << 16) + dfull.astype(np.int64)
    _, first_idx = np.unique(key, return_index=True)
    first_idx.sort()
    return (ds[first_idx].astype(np.int32), dfull[first_idx].astype(np.uint16),
            arrival[first_idx].astype(np.int64))


def _per_target_max(seqs: np.ndarray, diags: np.ndarray, scores: np.ndarray,
                    arrival: np.ndarray, bin_count: int) -> np.ndarray:
    """Keep the max-scoring diagonal per target — FIRST in per-seq arrival
    order among ties (keepMaxElement) — and return entries in the
    bin-major (seq & mask) detection-stream order that feeds the radix
    sort. Returns (N,3) [seq, diag, score].
    """
    if len(seqs) == 0:
        return np.empty((0, 3), np.int64)
    order = np.lexsort((np.arange(len(seqs)), -scores, seqs))
    s = seqs[order]
    first = np.concatenate(([True], s[1:] != s[:-1]))
    sel = order[first]
    bins = seqs[sel].astype(np.int64) & (bin_count - 1)
    stream = np.lexsort((arrival[sel], bins))
    sel = sel[stream]
    return np.stack([seqs[sel].astype(np.int64), diags[sel].astype(np.int64),
                     scores[sel].astype(np.int64)], axis=1)


def _score_threshold(hits: np.ndarray, max_hits: int) -> int:
    """computeScoreThreshold (QueryMatcher.h:206-216)."""
    bins = np.bincount(np.clip(hits[:, 2], 0, 255).astype(np.int64),
                       minlength=256) if len(hits) else np.zeros(256, np.int64)
    found = 0
    for thr in range(255, 0, -1):
        found += int(bins[thr])
        if found >= max_hits:
            return thr
    return 0
