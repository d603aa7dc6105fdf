"""Alignment stage: candidates -> filtered, sorted alignment records.

Orchestrates the batched SW kernels (ops/sw.py) + native banded traceback
(native/) to reproduce the reference's Alignment::run / Matcher::getSWResult
semantics (lib/mmseqs/src/alignment/Alignment.cpp:248-540, Matcher.cpp:60-142):

  * canBeCovered length pre-check (Util.cpp:477-494)
  * identity fast path for self-hits (scoreIdentical,
    StripedSmithWaterman.cpp:1675-1710): score accumulates in int16
  * forward SW -> (score, qEnd, tEnd); E-value from raw score + full
    query length; early rejections for E-value/end-based coverage are
    output-equivalent to the reference's in-kernel returns
  * reverse SW -> (qStart, tStart) via terminate-column semantics
  * banded traceback -> CIGAR; seqId = identical/alnLen (SEQ_ID_ALN_LEN)
  * checkCriteria + Matcher::compareHits sort (eval asc, bit score desc,
    tLen asc, tKey asc)

Batching: pairs are bucketed by padded (qLen, tLen) to bound XLA
recompiles; per-bucket batches are sized to cap device memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..db.setdb import SetDB
from ..ops.sw import (make_profiles, sw_forward_from_profiles,
                      sw_reverse_from_profiles)
from ..native import banded_align, banded_align_profile
from ..stats.evalue import EvalueComputation, BLOSUM62_GAPPED_11_1
from ..stats.submat import SubstitutionMatrix, load_substitution_matrix, composition_bias_int8
from .records import AlnRecord

COV_MODE_BIDIRECTIONAL = 0
COV_MODE_QUERY = 2
COV_MODE_TARGET = 1


def can_be_covered(cov_thr: float, cov_mode: int, qlen: int, tlen: int) -> bool:
    q = np.float32(qlen)
    t = np.float32(tlen)
    thr = np.float32(cov_thr)
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return bool(q / t >= thr and t / q >= thr)
    if cov_mode == COV_MODE_QUERY:
        return bool(t / q >= thr)
    if cov_mode == COV_MODE_TARGET:
        return bool(q / t >= thr)
    return True


def has_coverage(cov_thr: float, cov_mode: int, qcov: float, tcov: float) -> bool:
    thr = np.float32(cov_thr)
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return bool(np.float32(qcov) >= thr and np.float32(tcov) >= thr)
    if cov_mode == COV_MODE_QUERY:
        return bool(np.float32(qcov) >= thr)
    if cov_mode == COV_MODE_TARGET:
        return bool(np.float32(tcov) >= thr)
    return True


def compute_cov(start: int, end: int, length: int) -> np.float32:
    # StripedSmithWaterman.cpp:1671-1673
    return np.float32((min(length, max(start, end)) - min(start, end) + 1)
                      / np.float32(length))


def _cov_vec(start: np.ndarray, end: np.ndarray, length: np.ndarray
             ) -> np.ndarray:
    return ((np.minimum(length, np.maximum(start, end))
             - np.minimum(start, end) + 1).astype(np.float32)
            / length.astype(np.float32))


def _can_be_covered_vec(cov_thr: float, cov_mode: int, qlen: np.ndarray,
                        tlen: np.ndarray) -> np.ndarray:
    thr = np.float32(cov_thr)
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return (qlen / tlen >= thr) & (tlen / qlen >= thr)
    if cov_mode == COV_MODE_QUERY:
        return tlen / qlen >= thr
    if cov_mode == COV_MODE_TARGET:
        return qlen / tlen >= thr
    return np.ones(len(qlen), dtype=bool)


def _has_coverage_vec(cov_thr: float, cov_mode: int, qcov: np.ndarray,
                      tcov: np.ndarray) -> np.ndarray:
    thr = np.float32(cov_thr)
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return (qcov >= thr) & (tcov >= thr)
    if cov_mode == COV_MODE_QUERY:
        return qcov >= thr
    if cov_mode == COV_MODE_TARGET:
        return tcov >= thr
    return np.ones(len(qcov), dtype=bool)


@dataclass
class AlignmentParams:
    gap_open: int = 11
    gap_extend: int = 1
    eval_thr: float = 0.001
    cov_thr: float = 0.0
    cov_mode: int = 0
    seq_id_thr: float = 0.0
    aln_len_thr: int = 0
    max_accept: int = 2147483647
    max_rejected: int = 2147483647
    alt_alignments: int = 0
    comp_bias_correction: bool = True
    comp_bias_correction_scale: float = 1.0
    add_backtrace: bool = True
    include_identity: bool = False


def _bucket_len(x: int) -> int:
    """Pad lengths to the next power of two (>=64) to bound XLA recompiles."""
    n = 64
    while n < x:
        n *= 2
    return n


class AlignmentEngine:
    def __init__(self, query_db: SetDB, target_db: SetDB,
                 params: AlignmentParams | None = None,
                 matrix: SubstitutionMatrix | None = None,
                 same_qt_db: bool | None = None,
                 query_profiles: dict[int, np.ndarray] | None = None,
                 query_profile_seqs: dict[int, np.ndarray] | None = None):
        """`query_profiles` maps query keys to (L, 21) int8 alignment
        profiles (the reference's profile_for_alignment = pssm/4 with the
        X column zeroed, Sequence.cpp:271-280); such queries are scored
        per-position (PROFILE_SEQ) with no composition bias.
        `query_profile_seqs` optionally carries each profile's stored
        query-residue column (Sequence.cpp:254, possibly tantan-masked at
        profile build time) — identity counting must use it, not the
        underlying gene sequence, for seqId bit-parity."""
        self.qdb = query_db
        self.tdb = target_db
        self.par = params or AlignmentParams()
        self.matrix = matrix or load_substitution_matrix()
        self.evaluer = EvalueComputation(target_db.total_residues,
                                         BLOSUM62_GAPPED_11_1)
        self.same_qt_db = (same_qt_db if same_qt_db is not None
                           else query_db is target_db)
        self.query_profiles = query_profiles or {}
        self.query_profile_seqs = query_profile_seqs or {}
        self._bias_cache: dict[int, np.ndarray] = {}
        # scoring alphabet width; subclasses may widen it (the structure
        # mode scores over the combined 3Di x AA alphabet of 441 symbols)
        self.alpha = 21
        # device rung ladder; subclasses may coarsen it (the structure
        # engine's XLA-scan buckets compile slowly, so it trades padding
        # for fewer executables)
        from ..ops.sw_engine import LADDER
        self.ladder = LADDER
        self._dev = None          # lazy DeviceAlignDB (sequence mode only)
        self._dev_tried = False
        import threading
        self._dev_lock = threading.Lock()
        self._warm_thread: threading.Thread | None = None

    def _target_symbols(self, tk: int) -> np.ndarray:
        """Target symbol sequence in the scoring alphabet (hook for the
        combined-alphabet structure mode)."""
        return self.tdb.sequence(tk)

    def _query_len(self, qk: int) -> int:
        if qk in self.query_profiles:
            return self.query_profiles[qk].shape[0]
        return int(self.qdb.lengths[qk])

    def _row_profile(self, qk: int, lq_pad: int) -> np.ndarray:
        """(alpha, lq_pad) int32 scoring profile for one query."""
        out = np.zeros((self.alpha, lq_pad), dtype=np.int32)
        if qk in self.query_profiles:
            qp = self.query_profiles[qk]
            out[:, :qp.shape[0]] = qp.T.astype(np.int32)
        else:
            qs = self.qdb.sequence(qk)
            out[:, :len(qs)] = (self.matrix.sub_int[qs].T.astype(np.int32)
                                + self._bias(qk).astype(np.int32)[None, :])
        return out

    # ------------------------------------------------------------------
    def _qbias_all(self) -> np.ndarray:
        """Whole-DB int8 composition bias, computed once natively
        (comp_bias_batch), concatenated in seq_data layout."""
        if getattr(self, "_qbias_arr", None) is None:
            if (self.par.comp_bias_correction
                    and abs(self.par.comp_bias_correction_scale - 1.0)
                    < 1e-9):
                from ..native import comp_bias_batch
                qdb = self.qdb
                self._qbias_arr = comp_bias_batch(
                    np.ascontiguousarray(qdb.seq_data, dtype=np.uint8),
                    np.ascontiguousarray(qdb.offsets[:-1], dtype=np.int64),
                    np.ascontiguousarray(qdb.lengths, dtype=np.int32),
                    np.ascontiguousarray(self.matrix.sub_int,
                                         dtype=np.int32),
                    np.ascontiguousarray(self.matrix.p_back,
                                         dtype=np.float64))
            else:
                self._qbias_arr = False
        return self._qbias_arr

    def _bias(self, qkey: int) -> np.ndarray:
        if qkey not in self._bias_cache:
            seq = self.qdb.sequence(qkey)
            if qkey in self.query_profiles:
                self._bias_cache[qkey] = np.zeros(len(seq), dtype=np.int8)
            elif self.par.comp_bias_correction:
                allb = self._qbias_all()
                if allb is not False:
                    o = self.qdb.offsets
                    self._bias_cache[qkey] = allb[o[qkey]:o[qkey + 1]]
                else:
                    self._bias_cache[qkey] = composition_bias_int8(
                        seq, self.matrix,
                        self.par.comp_bias_correction_scale)
            else:
                self._bias_cache[qkey] = np.zeros(len(seq), dtype=np.int8)
        return self._bias_cache[qkey]

    def _identity_raws_all(self) -> np.ndarray | None:
        """Whole-DB int16 identity raw scores (scoreIdentical semantics)
        in ONE pass over the concatenated tokens: per-key numpy calls
        cost ~0.5 ms each under GIL/core contention with the overlapped
        prefilter, which made the old per-query loop the align stage's
        largest hidden host cost at scale."""
        if getattr(self, "_ident_raws", None) is None:
            qdb = self.qdb
            diag = np.diagonal(self.matrix.sub_int).astype(np.int64).copy()
            d = diag[qdb.seq_data.astype(np.int64)]
            if self.par.comp_bias_correction:
                allb = self._qbias_all()
                if allb is False:
                    self._ident_raws = False
                    return None
                d = d + allb.astype(np.int64)
            csum = np.concatenate(([0], np.cumsum(d)))
            o = qdb.offsets
            self._ident_raws = (csum[o[1:]] - csum[o[:-1]]).astype(np.int16)
        if self._ident_raws is False:
            return None
        return self._ident_raws

    def _identity_records_batch(self, qkeys: np.ndarray
                                ) -> dict[int, AlnRecord]:
        """Vectorized identity fast path for many queries (scoreIdentical
        semantics; int16 raw accumulation is order-independent mod 2^16)."""
        out: dict[int, AlnRecord] = {}
        if (type(self)._identity_record
                is not AlignmentEngine._identity_record):
            # subclasses with custom identity scoring (structure mode's
            # combined-alphabet profile) take the per-key path
            return {int(qk): self._identity_record(int(qk)) for qk in qkeys}
        seq_keys = [int(qk) for qk in qkeys
                    if int(qk) not in self.query_profiles]
        for qk in qkeys:
            if int(qk) in self.query_profiles:
                out[int(qk)] = self._identity_record(int(qk))
        if not seq_keys:
            return out
        qdb = self.qdb
        all_raws = self._identity_raws_all()
        if all_raws is not None:
            raws = all_raws[np.asarray(seq_keys)].astype(np.int64)
        else:
            # non-unit bias scale: per-key fallback
            raws = np.empty(len(seq_keys), dtype=np.int64)
            for i, qk in enumerate(seq_keys):
                seq = qdb.sequence(qk)
                bias = (self._bias(qk).astype(np.int64)
                        if self.par.comp_bias_correction else 0)
                raws[i] = np.int16(
                    (self.matrix.sub_int[seq, seq].astype(np.int64) + bias)
                    .sum())
        lens = qdb.lengths[np.asarray(seq_keys)].astype(np.int64)
        evalues = self.evaluer.compute_evalue(raws, lens)
        bits = (self.evaluer.compute_bit_score(raws) + 0.5).astype(np.int64)
        for i, qk in enumerate(seq_keys):
            L = int(lens[i])
            out[qk] = AlnRecord(
                tkey=qk, score=int(bits[i]), seq_id=1.0,
                evalue=float(evalues[i]), qstart=0, qend=L - 1, qlen=L,
                tstart=0, tend=L - 1, tlen=L, backtrace="M" * L,
                raw_score=int(raws[i]), qcov=1.0, tcov=1.0,
                cigar=f"{L}M")
        return out

    def _identity_record(self, qkey: int) -> AlnRecord:
        seq = self.qdb.sequence(qkey)
        L = len(seq)
        if qkey in self.query_profiles:
            # profile_word_linear scoring (scoreIdentical with a profile)
            qp = self.query_profiles[qkey]
            scores = qp[np.arange(L), seq.astype(np.int64)].astype(np.int64)
        else:
            bias = self._bias(qkey)
            scores = (self.matrix.sub_int[seq, seq].astype(np.int64)
                      + bias.astype(np.int64))
        raw = np.int16(scores.sum())  # short accumulation (scoreIdentical)
        evalue = float(self.evaluer.compute_evalue(int(raw), L))
        bit = int(self.evaluer.compute_bit_score(int(raw)) + 0.5)
        return AlnRecord(tkey=qkey, score=bit, seq_id=1.0, evalue=evalue,
                         qstart=0, qend=L - 1, qlen=L, tstart=0, tend=L - 1,
                         tlen=L, backtrace="M" * L, raw_score=int(raw),
                         qcov=1.0, tcov=1.0, cigar=f"{L}M")

    # ------------------------------------------------------------------
    def forward_accepts(self, candidates: dict[int, list[int]],
                        eval_thr: float, aln_len_thr: int,
                        can_cov_thr: float, cov_mode: int
                        ) -> dict[int, list[AlnRecord]]:
        """SCORE_ONLY acceptance pass (the realign mode's first stage,
        Alignment.cpp:47-56): forward SW only; records carry end positions
        with start = -1 and the alignment-length proxy
        max(qEnd, tEnd) + 2 (computeAlnLength with start -1)."""
        tlens_all = self.tdb.lengths
        accepted: dict[int, list[AlnRecord]] = {qk: [] for qk in candidates}
        pairs: list[tuple[int, int]] = []
        for qk, tkeys in candidates.items():
            for tk in tkeys:
                if not can_be_covered(can_cov_thr, cov_mode,
                                      self._query_len(qk), int(tlens_all[tk])):
                    continue
                if qk == tk and self.same_qt_db:
                    accepted[qk].append(self._identity_record(qk))
                else:
                    pairs.append((qk, tk))
        fwd = self._run_forward(pairs)
        for (qk, tk), (score, q_end, t_end) in zip(pairs, fwd):
            if t_end < 0:
                continue
            qlen = self._query_len(qk)
            evalue = float(self.evaluer.compute_evalue(score, qlen))
            proxy_aln_len = max(q_end + 1, t_end + 1) + 1
            if evalue <= eval_thr and proxy_aln_len >= aln_len_thr:
                bit = int(self.evaluer.compute_bit_score(score) + 0.5)
                accepted[qk].append(AlnRecord(
                    tkey=tk, score=bit, seq_id=0.0, evalue=evalue,
                    qstart=-1, qend=q_end, qlen=qlen, tstart=-1, tend=t_end,
                    tlen=int(tlens_all[tk]), backtrace="", raw_score=score))
        for qk in accepted:
            accepted[qk].sort(key=lambda r: (r.evalue, -r.score, r.tlen,
                                             r.tkey))
        return accepted

    # ------------------------------------------------------------------
    def stream(self) -> "_AlignStream":
        """Streaming entry: add() candidate fragments as the prefilter
        produces them (forward SW dispatches asynchronously per fragment,
        overlapping device scoring with the host prefilter), finish()
        collects and completes.  align_all == one add + finish."""
        return _AlignStream(self)

    def align_all(self, candidates: dict[int, list[int]],
                  progress: bool = False) -> dict[int, list[AlnRecord]]:
        """candidates: query key -> target keys (prefilter order).
        Returns query key -> sorted accepted records.

        All SW passes run batched; the per-query --max-accept /
        --max-rejected early-stop (Alignment.cpp:346,389-397: stop at
        max_accept acceptances or max_rejected CONSECUTIVE rejections,
        candidates in prefilter order) is applied as an output-equivalent
        post-pass over the eagerly computed decisions."""
        st = self.stream()
        st.add(candidates)
        return st.finish()

    def _stage0_arrays(self, candidates: dict[int, list[int]]):
        """Array form of the identity/coverage pre-check for one
        candidate fragment (no per-candidate Python loop; the 'items'
        state machine is skipped entirely when --max-accept/--max-
        rejected are unset, which is the clustersearch default).
        Returns (qks, aqk, atk, keep_ident, pair_idx, ident_recs) where
        pair_idx are the candidate positions that become device pairs."""
        par = self.par
        qlens_all = self.qdb.lengths
        tlens_all = self.tdb.lengths
        qks = list(candidates)
        all_qk: list[int] = []
        all_tk: list[int] = []
        for qk, tkeys in candidates.items():
            all_qk.extend([qk] * len(tkeys))
            all_tk.extend(tkeys)
        aqk = np.asarray(all_qk, dtype=np.int64)
        atk = np.asarray(all_tk, dtype=np.int64)
        covered = _can_be_covered_vec(par.cov_thr, par.cov_mode,
                                      qlens_all[aqk].astype(np.float32),
                                      tlens_all[atk].astype(np.float32))
        is_ident = ((aqk == atk)
                    if (par.include_identity or self.same_qt_db)
                    else np.zeros(len(aqk), dtype=bool))
        ident_recs = self._identity_records_batch(
            np.unique(aqk[is_ident & covered]))
        keep_ident = is_ident & covered
        pair_idx = np.nonzero(covered & ~is_ident)[0]
        return qks, aqk, atk, keep_ident, pair_idx, ident_recs

    def _stage0(self, candidates: dict[int, list[int]],
                items: dict[int, list], pairs: list[tuple[int, int]]) -> int:
        """Identity + coverage pre-check for one candidate fragment;
        appends to items/pairs, returns the fragment's first pair index.

        items[qk] keeps every candidate in prefilter order as
        ('acc', record) / ('rej', None) / ('pair', pair list index).
        The coverage pre-check and identity records are vectorized
        across all candidates (the per-candidate Python loop dominates
        host time otherwise)."""
        par = self.par
        qlens_all = self.qdb.lengths
        tlens_all = self.tdb.lengths
        all_qk: list[int] = []
        all_tk: list[int] = []
        for qk, tkeys in candidates.items():
            all_qk.extend([qk] * len(tkeys))
            all_tk.extend(tkeys)
        aqk = np.asarray(all_qk, dtype=np.int64)
        atk = np.asarray(all_tk, dtype=np.int64)
        covered = _can_be_covered_vec(par.cov_thr, par.cov_mode,
                                      qlens_all[aqk].astype(np.float32),
                                      tlens_all[atk].astype(np.float32))
        is_ident = ((aqk == atk)
                    if (par.include_identity or self.same_qt_db)
                    else np.zeros(len(aqk), dtype=bool))
        ident_recs = self._identity_records_batch(
            np.unique(aqk[is_ident & covered]))

        frag_start = len(pairs)
        ci = 0
        for qk, tkeys in candidates.items():
            lst = items.setdefault(qk, [])
            for tk in tkeys:
                if not covered[ci]:
                    lst.append(("rej", None))
                elif is_ident[ci]:
                    lst.append(("acc", ident_recs[qk]))
                else:
                    lst.append(("pair", len(pairs)))
                    pairs.append((qk, tk))
                ci += 1
        return frag_start

    def _survivor_filter(self, pairs, fwd, pair_base: int):
        """Stage 2 for one pair fragment: E-value/end-coverage filters
        (vectorized) -> survivor tuples + {global pair idx: local surv
        idx} (the reverse-pass batch)."""
        if not pairs:
            return [], {}
        n = len(pairs)
        pqk = np.fromiter((p[0] for p in pairs), np.int64, n)
        ptk = np.fromiter((p[1] for p in pairs), np.int64, n)
        scores = np.fromiter((f[0] for f in fwd), np.int64, n)
        q_ends = np.fromiter((f[1] for f in fwd), np.int64, n)
        t_ends = np.fromiter((f[2] for f in fwd), np.int64, n)
        return self._survivor_filter_arrays(pqk, ptk, scores, q_ends,
                                            t_ends, pair_base)

    def _survivor_filter_arrays(self, pqk, ptk, scores, q_ends, t_ends,
                                pair_base: int = 0):
        """Array-based survivor filter (the streaming driver decodes
        forward results straight into flat arrays)."""
        par = self.par
        n = len(pqk)
        qlens = self.qdb.lengths[pqk].astype(np.int64)
        tlens = self.tdb.lengths[ptk].astype(np.int64)
        evalues = self.evaluer.compute_evalue(scores, qlens)
        qcov0 = _cov_vec(np.zeros(n, np.int64), q_ends, qlens)
        tcov0 = _cov_vec(np.zeros(n, np.int64), t_ends, tlens)
        keep = ((t_ends >= 0) & (evalues <= par.eval_thr)
                & _has_coverage_vec(par.cov_thr, par.cov_mode,
                                    qcov0, tcov0))
        surv_of_pair: dict[int, int] = {}
        survivors: list[tuple[int, int, int, int, int, float]] = []
        for pi in np.nonzero(keep)[0]:
            surv_of_pair[pair_base + int(pi)] = len(survivors)
            survivors.append((int(pqk[pi]), int(ptk[pi]),
                              int(scores[pi]), int(q_ends[pi]),
                              int(t_ends[pi]), float(evalues[pi])))
        return survivors, surv_of_pair

    def _post_forward(self, items: dict[int, list],
                      pairs: list[tuple[int, int]], fwd
                      ) -> dict[int, list[AlnRecord]]:
        survivors, surv_of_pair = self._survivor_filter(pairs, fwd, 0)
        starts = self._run_reverse(survivors)
        recs = self._finish_pairs(survivors, starts)
        return self._accept_stage(items, surv_of_pair, recs)

    def _accept_stage(self, items: dict[int, list],
                      surv_of_pair: dict[int, int], recs
                      ) -> dict[int, list[AlnRecord]]:
        par = self.par
        # Stage 4: per-query accept/reject state machine in prefilter order
        accepted: dict[int, list[AlnRecord]] = {qk: [] for qk in items}
        for qk, lst in items.items():
            passed = 0
            rejected = 0
            out = accepted[qk]
            for kind, val in lst:
                if passed >= par.max_accept or rejected >= par.max_rejected:
                    break
                rec = None
                if kind == "acc":
                    rec = val
                elif kind == "pair":
                    si = surv_of_pair.get(val)
                    if si is not None:
                        rec = recs[si]
                if rec is not None:
                    out.append(rec)
                    passed += 1
                    rejected = 0
                else:
                    rejected += 1

        # Stage 5: alternative alignments on masked targets
        if par.alt_alignments > 0:
            self._compute_alt_alignments(accepted)

        # Stage 6: sort by compareHits
        for qk in accepted:
            accepted[qk].sort(key=lambda r: (r.evalue, -r.score, r.tlen, r.tkey))
        return accepted

    # ------------------------------------------------------------------
    def _compute_alt_alignments(self, accepted: dict[int, list[AlnRecord]]
                                ) -> None:
        """computeAlternativeAlignment (Alignment.cpp:569-601): per
        accepted non-identity hit, X-mask the aligned target region
        [tstart, tend) (end column NOT masked — reference quirk) and
        re-align up to --alt-ali times, stopping at the first failure."""
        from ..constants import X_INDEX
        par = self.par
        for qk, out in accepted.items():
            if qk in self.query_profiles:
                continue
            qlen = self._query_len(qk)
            prof_full = self._row_profile(qk, qlen)
            for rec in list(out):
                if rec.tkey == qk and (par.include_identity or self.same_qt_db):
                    continue
                tseq = self._target_symbols(rec.tkey).copy()
                tseq[rec.tstart:rec.tend] = X_INDEX
                for _alt in range(par.alt_alignments):
                    new = self._align_one_masked(qk, rec.tkey, prof_full,
                                                 tseq)
                    if new is None:
                        break
                    out.append(new)
                    tseq[new.tstart:new.tend] = X_INDEX

    def _align_one_masked(self, qk: int, tk: int, prof_full: np.ndarray,
                          tseq: np.ndarray) -> AlnRecord | None:
        """One full SW (forward + reverse + traceback + checkCriteria)
        against an explicitly provided (masked) target."""
        from ..ops.sw import sw_forward_from_profiles, sw_reverse_from_profiles
        par = self.par
        qlen = prof_full.shape[1]
        tlen = len(tseq)
        prof = prof_full[None].astype(np.int32)
        tarr = tseq[None].astype(np.int32)
        score, q_end, t_end = sw_forward_from_profiles(
            prof, tarr, np.array([tlen], np.int32), np.array([qlen], np.int32),
            par.gap_open, par.gap_extend)
        score, q_end, t_end = int(score[0]), int(q_end[0]), int(t_end[0])
        if t_end < 0:
            return None
        evalue = float(self.evaluer.compute_evalue(score, qlen))
        if evalue > par.eval_thr:
            return None
        if not has_coverage(par.cov_thr, par.cov_mode,
                            compute_cov(0, q_end, qlen),
                            compute_cov(0, t_end, tlen)):
            return None
        rprof = np.zeros_like(prof_full)[None].astype(np.int32)
        rprof[0, :, :q_end + 1] = prof_full[:, :q_end + 1][:, ::-1]
        rt = tseq[:t_end + 1][::-1]
        rtarr = np.zeros((1, tlen), np.int32)
        rtarr[0, :len(rt)] = rt
        _s, fj, fi, found = sw_reverse_from_profiles(
            rprof, rtarr, np.array([len(rt)], np.int32),
            np.array([q_end + 1], np.int32), np.array([score], np.int32),
            par.gap_open, par.gap_extend)
        if not found[0]:
            return None
        q_start, t_start = q_end - int(fi[0]), t_end - int(fj[0])
        return self._finish_pair_masked(qk, tk, score, q_start, q_end,
                                        t_start, t_end, evalue, tseq)

    def _finish_pair_masked(self, qk, tk, score, q_start, q_end, t_start,
                            t_end, evalue, tseq) -> AlnRecord | None:
        par = self.par
        qseq = self.qdb.sequence(qk)
        qlen, tlen = len(qseq), len(tseq)
        qcov = compute_cov(q_start, q_end, qlen)
        tcov = compute_cov(t_start, t_end, tlen)
        if not has_coverage(par.cov_thr, par.cov_mode, qcov, tcov):
            return None
        bias = self._bias(qk)
        ops = banded_align(qseq[q_start:q_end + 1], tseq[t_start:t_end + 1],
                           bias[q_start:q_end + 1],
                           self.matrix.sub_int.astype(np.int8), score,
                           par.gap_open, par.gap_extend)
        aa_ids = 0
        qp, tp = q_start, t_start
        for op in ops:
            if op == "M":
                aa_ids += int(qseq[qp] == tseq[tp])
                qp += 1
                tp += 1
            elif op == "I":
                qp += 1
            else:
                tp += 1
        aln_len = len(ops)
        seq_id = np.float32(aa_ids) / np.float32(aln_len)
        bit = int(self.evaluer.compute_bit_score(score) + 0.5)
        if not (evalue <= par.eval_thr
                and seq_id >= np.float32(par.seq_id_thr)
                and aln_len >= par.aln_len_thr):
            return None
        return AlnRecord(tkey=tk, score=bit, seq_id=float(seq_id),
                         evalue=evalue, qstart=q_start, qend=q_end, qlen=qlen,
                         tstart=t_start, tend=t_end, tlen=tlen,
                         backtrace=ops, raw_score=score,
                         qcov=float(qcov), tcov=float(tcov))

    # ------------------------------------------------------------------
    def warm_async(self) -> None:
        """Build the device DB and precompile the SW bucket executables on
        a background thread.  Call at pipeline start: the prefilter
        (native OpenMP, GIL-free) runs concurrently, so by align time the
        executables are compiled."""
        import threading

        def _go():
            try:
                dev = self._device_db()
                if dev is not None:
                    from ..ops.sw_engine import device_max_len
                    # a forward pair's rung is bucket_len(max(ql, tl)) ==
                    # the longer sequence's own bucket, so the forward
                    # rungs are exactly the buckets the lengths fall
                    # into; warm() adds the smaller rungs that reverse
                    # prefixes can need
                    lens = np.concatenate([self.qdb.lengths,
                                           self.tdb.lengths])
                    lens = lens[lens <= device_max_len()]
                    ladder = np.asarray(self.ladder)
                    need = np.unique(np.searchsorted(ladder, lens))
                    rungs = [int(ladder[i]) for i in need]
                    dev.warm(rungs, self.par.gap_open, self.par.gap_extend,
                             ladder=self.ladder)
            except Exception:     # warm failures surface on the real call
                pass

        self._warm_thread = threading.Thread(target=_go, daemon=True)
        self._warm_thread.start()

    def _device_db(self):
        """Device-resident token/bias arrays (plain sequence mode only;
        profile queries and widened alphabets use the host-assembly path)."""
        with self._dev_lock:
            return self._device_db_locked()

    def _device_db_locked(self):
        if self._dev_tried:
            return self._dev
        self._dev_tried = True
        if self.query_profiles or self.alpha != 21:
            return None
        # the fused wide-batch path pays off on an accelerator; on the CPU
        # backend the x4-padded batches cost more than the pow2 host path
        import os
        import jax
        if (jax.default_backend() == "cpu"
                and not os.environ.get("SPACEDUST_FORCE_DEVICE_ALIGN")):
            return None
        from ..ops.sw_engine import DeviceAlignDB
        from ..native import comp_bias_batch
        qdb, tdb = self.qdb, self.tdb
        qdata = np.ascontiguousarray(qdb.seq_data, dtype=np.uint8)
        qoffs = np.ascontiguousarray(qdb.offsets[:-1], dtype=np.int64)
        qlens = np.ascontiguousarray(qdb.lengths, dtype=np.int32)
        if self.par.comp_bias_correction:
            qbias = comp_bias_batch(
                qdata, qoffs, qlens,
                np.ascontiguousarray(self.matrix.sub_int, dtype=np.int32),
                np.ascontiguousarray(self.matrix.p_back, dtype=np.float64))
        else:
            qbias = np.zeros(len(qdata), dtype=np.int8)
        self._dev = DeviceAlignDB(qdata, qbias,
                                  np.ascontiguousarray(tdb.seq_data,
                                                       dtype=np.uint8),
                                  self.matrix.sub_int,
                                  q_offsets=np.ascontiguousarray(
                                      qdb.offsets, dtype=np.int64),
                                  t_offsets=np.ascontiguousarray(
                                      tdb.offsets, dtype=np.int64))
        # per-sequence token offsets — what forward/reverse jobs carry
        self._qoffs32 = self._dev.q_offs
        self._toffs32 = self._dev.t_offs
        return self._dev

    def _forward_jobs(self, pairs: list[tuple[int, int]], base: int,
                      positions: np.ndarray | None = None):
        """Bucketed forward jobs for a pair fragment; positions are
        global pair indices (base + local, or the explicit array)."""
        qk = np.fromiter((p[0] for p in pairs), np.int64, len(pairs))
        tk = np.fromiter((p[1] for p in pairs), np.int64, len(pairs))
        if positions is None:
            positions = base + np.arange(len(pairs), dtype=np.int64)
        return self._forward_jobs_arrays(qk, tk, positions)

    def _forward_jobs_arrays(self, qk: np.ndarray, tk: np.ndarray,
                             positions: np.ndarray):
        """Array-native forward-job bucketing (the streaming fast path
        never materializes pair tuples)."""
        ql = self.qdb.lengths[qk].astype(np.int32)
        tl = self.tdb.lengths[tk].astype(np.int32)
        # square rungs only: one executable serves both dimensions
        # (and the reverse pass), keeping the compiled-shape count at
        # the ladder size; rung assignment vectorized over the ladder
        ladder = np.asarray(self.ladder, dtype=np.int64)
        ri = np.searchsorted(ladder, np.maximum(ql, tl))
        jobs = []
        for r in np.unique(ri):
            sel = np.nonzero(ri == r)[0]
            rung = int(ladder[r])
            jobs.append(((rung, rung), self._qoffs32[qk[sel]], ql[sel],
                         self._toffs32[tk[sel]], tl[sel],
                         np.full(len(sel), -1, np.int32), positions[sel]))
        return jobs

    @staticmethod
    def _decode_forward(collected, out):
        for pos, (score, t_end, q_end, _f, _fj, _fi) in collected:
            for bi, pidx in enumerate(pos):
                out[pidx] = (int(score[bi]), int(q_end[bi]), int(t_end[bi]))

    def _split_device_eligible(self, lens_of):
        """Partition indices by device eligibility: pairs longer than the
        compiled ladder top go to the unbounded host path (the resident-
        array gather would silently truncate them otherwise)."""
        from ..ops.sw_engine import device_max_len
        cap = device_max_len()
        dev_idx, host_idx = [], []
        for i, m in enumerate(lens_of):
            (dev_idx if m <= cap else host_idx).append(i)
        return dev_idx, host_idx

    def _run_forward(self, pairs: list[tuple[int, int]]
                     ) -> list[tuple[int, int, int]]:
        if not pairs:
            return []
        dev = self._device_db()
        if dev is not None:
            qlens_all, tlens_all = self.qdb.lengths, self.tdb.lengths
            dev_idx, host_idx = self._split_device_eligible(
                [max(int(qlens_all[qk]), int(tlens_all[tk]))
                 for qk, tk in pairs])
            out: list[tuple[int, int, int] | None] = [None] * len(pairs)
            if dev_idx:
                jobs = self._forward_jobs([pairs[i] for i in dev_idx], 0)
                sub: list = [None] * len(dev_idx)
                self._decode_forward(
                    dev.run_buckets(jobs, self.par.gap_open,
                                    self.par.gap_extend, reverse=False), sub)
                for i, r in zip(dev_idx, sub):
                    out[i] = r
            if host_idx:
                for i, r in zip(host_idx, self._run_forward_host(
                        [pairs[i] for i in host_idx])):
                    out[i] = r
            return out  # type: ignore[return-value]
        return self._run_forward_host(pairs)

    def _reverse_jobs(self, survivors, base: int,
                      positions: np.ndarray | None = None):
        """Bucketed reverse jobs for a survivor fragment (reversed
        prefixes [0..q_end] x [0..t_end], terminate = forward score);
        positions are global survivor indices."""
        n = len(survivors)
        qk = np.fromiter((s[0] for s in survivors), np.int64, n)
        tk = np.fromiter((s[1] for s in survivors), np.int64, n)
        term = np.fromiter((s[2] for s in survivors), np.int32, n)
        ql = np.fromiter((s[3] + 1 for s in survivors), np.int32, n)
        tl = np.fromiter((s[4] + 1 for s in survivors), np.int32, n)
        ladder = np.asarray(self.ladder, dtype=np.int64)
        ri = np.searchsorted(ladder, np.maximum(ql, tl))
        jobs = []
        for r in np.unique(ri):
            sel = np.nonzero(ri == r)[0]
            rung = int(ladder[r])
            pos = (positions[sel] if positions is not None else sel + base)
            jobs.append(((rung, rung), self._qoffs32[qk[sel]], ql[sel],
                         self._toffs32[tk[sel]], tl[sel],
                         term[sel], pos))
        return jobs

    def _decode_reverse(self, collected, survivors, out) -> None:
        for pos, (_s, _gj, _gi, found, fj, fi) in collected:
            for bi, sidx in enumerate(pos):
                if not found[bi]:
                    raise RuntimeError(
                        "forward/backward SW scores differ for "
                        f"q={survivors[sidx][0]} t={survivors[sidx][1]}")
                q_end, t_end = survivors[sidx][3], survivors[sidx][4]
                out[sidx] = (q_end - int(fi[bi]), t_end - int(fj[bi]))

    def _run_reverse(self, survivors) -> list[tuple[int, int]]:
        if not survivors:
            return []
        dev = self._device_db()
        if dev is not None:
            dev_idx, host_idx = self._split_device_eligible(
                [max(s[3] + 1, s[4] + 1) for s in survivors])
            out: list[tuple[int, int] | None] = [None] * len(survivors)
            if dev_idx:
                sub_surv = [survivors[i] for i in dev_idx]
                jobs = self._reverse_jobs(sub_surv, 0)
                sub: list = [None] * len(dev_idx)
                self._decode_reverse(
                    dev.run_buckets(jobs, self.par.gap_open,
                                    self.par.gap_extend, reverse=True),
                    sub_surv, sub)
                for i, r in zip(dev_idx, sub):
                    out[i] = r
            if host_idx:
                for i, r in zip(host_idx, self._run_reverse_host(
                        [survivors[i] for i in host_idx])):
                    out[i] = r
            return out  # type: ignore[return-value]
        return self._run_reverse_host(survivors)

    # ------------------------------------------------------------------
    def _run_forward_host(self, pairs: list[tuple[int, int]]
                          ) -> list[tuple[int, int, int]]:
        qlens_all = self.qdb.lengths
        tlens_all = self.tdb.lengths
        buckets: dict[tuple[int, int], list[int]] = {}
        for idx, (qk, tk) in enumerate(pairs):
            key = (_bucket_len(int(qlens_all[qk])),
                   _bucket_len(int(tlens_all[tk])))
            buckets.setdefault(key, []).append(idx)

        out: list[tuple[int, int, int] | None] = [None] * len(pairs)
        for (lq, lt), idxs in sorted(buckets.items()):
            max_batch = max(1, (1 << 20) // lq // max(1, self.alpha // 21))
            for s in range(0, len(idxs), max_batch):
                chunk = idxs[s:s + max_batch]
                B = len(chunk)
                prof = np.zeros((B, self.alpha, lq), dtype=np.int32)
                tarr = np.zeros((B, lt), dtype=np.int32)
                ql = np.zeros(B, dtype=np.int32)
                tl = np.zeros(B, dtype=np.int32)
                for bi, pidx in enumerate(chunk):
                    qk, tk = pairs[pidx]
                    ts = self._target_symbols(tk)
                    prof[bi] = self._row_profile(qk, lq)
                    tarr[bi, :len(ts)] = ts
                    ql[bi] = self._query_len(qk)
                    tl[bi] = len(ts)
                score, q_end, t_end = sw_forward_from_profiles(
                    prof, tarr, tl, ql, self.par.gap_open, self.par.gap_extend)
                for bi, pidx in enumerate(chunk):
                    out[pidx] = (int(score[bi]), int(q_end[bi]), int(t_end[bi]))
        return out  # type: ignore[return-value]

    # ------------------------------------------------------------------
    def _run_reverse_host(self, survivors) -> list[tuple[int, int]]:
        """Batched reverse pass; returns (q_start, t_start) per survivor."""
        buckets: dict[tuple[int, int], list[int]] = {}
        for idx, (qk, tk, score, q_end, t_end, _ev) in enumerate(survivors):
            key = (_bucket_len(q_end + 1), _bucket_len(t_end + 1))
            buckets.setdefault(key, []).append(idx)

        out: list[tuple[int, int] | None] = [None] * len(survivors)
        for (lq, lt), idxs in sorted(buckets.items()):
            max_batch = max(1, (1 << 20) // lq // max(1, self.alpha // 21))
            for s in range(0, len(idxs), max_batch):
                chunk = idxs[s:s + max_batch]
                B = len(chunk)
                prof = np.zeros((B, self.alpha, lq), dtype=np.int32)
                tarr = np.zeros((B, lt), dtype=np.int32)
                ql = np.zeros(B, dtype=np.int32)
                tl = np.zeros(B, dtype=np.int32)
                term = np.zeros(B, dtype=np.int32)
                for bi, sidx in enumerate(chunk):
                    qk, tk, score, q_end, t_end, _ev = survivors[sidx]
                    full = self._row_profile(qk, self._query_len(qk))
                    prof[bi, :, :q_end + 1] = full[:, :q_end + 1][:, ::-1]
                    tr = self._target_symbols(tk)[:t_end + 1][::-1]
                    tarr[bi, :len(tr)] = tr
                    ql[bi] = q_end + 1
                    tl[bi] = len(tr)
                    term[bi] = score
                _score, fj, fi, found = sw_reverse_from_profiles(
                    prof, tarr, tl, ql, term,
                    self.par.gap_open, self.par.gap_extend)
                for bi, sidx in enumerate(chunk):
                    qk, tk, score, q_end, t_end, _ev = survivors[sidx]
                    if not found[bi]:
                        raise RuntimeError(
                            f"forward/backward SW scores differ for q={qk} t={tk}")
                    out[sidx] = (q_end - int(fi[bi]), t_end - int(fj[bi]))
        return out  # type: ignore[return-value]

    # ------------------------------------------------------------------
    def _finish_pairs(self, survivors, starts) -> list["AlnRecord | None"]:
        """Stage-3 driver: vectorized coverage gate, one batched native
        traceback call for all sequence-mode pairs (OpenMP over pairs),
        scalar fallback for profile queries / overridden tracebacks."""
        n = len(survivors)
        if n == 0:
            return []
        base_tb = type(self)._traceback is AlignmentEngine._traceback
        bias_ok = (not self.par.comp_bias_correction
                   or self._qbias_all() is not False)
        use_batch = base_tb and not self.query_profiles and bias_ok
        if not use_batch:
            return [self._finish_pair(qk, tk, score, q_start, q_end,
                                      t_start, t_end, evalue)
                    for (qk, tk, score, q_end, t_end, evalue),
                        (q_start, t_start) in zip(survivors, starts)]
        par = self.par
        qk = np.fromiter((s[0] for s in survivors), np.int64, n)
        tk = np.fromiter((s[1] for s in survivors), np.int64, n)
        score = np.fromiter((s[2] for s in survivors), np.int64, n)
        q_end = np.fromiter((s[3] for s in survivors), np.int64, n)
        t_end = np.fromiter((s[4] for s in survivors), np.int64, n)
        evalue = np.fromiter((s[5] for s in survivors), np.float64, n)
        q_start = np.fromiter((p[0] for p in starts), np.int64, n)
        t_start = np.fromiter((p[1] for p in starts), np.int64, n)
        qlen = self.qdb.lengths[qk].astype(np.int64)
        tlen = self.tdb.lengths[tk].astype(np.int64)
        qcov = _cov_vec(q_start, q_end, qlen)
        tcov = _cov_vec(t_start, t_end, tlen)
        cov_ok = _has_coverage_vec(par.cov_thr, par.cov_mode, qcov, tcov)
        sel = np.nonzero(cov_ok)[0]
        recs: list[AlnRecord | None] = [None] * n
        if len(sel) == 0:
            return recs
        from ..native import banded_align_batch
        if par.comp_bias_correction:
            bias_data = self._qbias_all()
        else:
            bias_data = np.zeros(len(self.qdb.seq_data), dtype=np.int8)
        ops_list, idents, cigars = banded_align_batch(
            np.ascontiguousarray(self.qdb.seq_data, dtype=np.uint8),
            np.ascontiguousarray(self.qdb.offsets[:-1], dtype=np.int64),
            np.ascontiguousarray(self.tdb.seq_data, dtype=np.uint8),
            np.ascontiguousarray(self.tdb.offsets[:-1], dtype=np.int64),
            np.ascontiguousarray(bias_data, dtype=np.int8),
            self.matrix.sub_int.astype(np.int8),
            qk[sel], tk[sel], q_start[sel], q_end[sel],
            t_start[sel], t_end[sel], score[sel],
            par.gap_open, par.gap_extend, want_cigar=True)
        bits = (self.evaluer.compute_bit_score(score[sel])
                + 0.5).astype(np.int64)
        for bi, si in enumerate(sel):
            ops = ops_list[bi]
            aln_len = len(ops)
            seq_id = np.float32(int(idents[bi])) / np.float32(aln_len)
            # checkCriteria (Alignment.cpp:548-567)
            if not (evalue[si] <= par.eval_thr
                    and seq_id >= np.float32(par.seq_id_thr)
                    and aln_len >= par.aln_len_thr):
                continue
            recs[si] = AlnRecord(
                tkey=int(tk[si]), score=int(bits[bi]),
                seq_id=float(seq_id), evalue=float(evalue[si]),
                qstart=int(q_start[si]), qend=int(q_end[si]),
                qlen=int(qlen[si]), tstart=int(t_start[si]),
                tend=int(t_end[si]), tlen=int(tlen[si]), backtrace=ops,
                raw_score=int(score[si]), qcov=float(qcov[si]),
                tcov=float(tcov[si]), cigar=cigars[bi])
        return recs

    # ------------------------------------------------------------------
    def _traceback(self, qk: int, tk: int, q_start: int, q_end: int,
                   t_start: int, t_end: int, score: int) -> str:
        tseq = self.tdb.sequence(tk)
        if qk in self.query_profiles:
            qp = self.query_profiles[qk]
            return banded_align_profile(
                tseq[t_start:t_end + 1], q_end - q_start + 1,
                qp.T.astype(np.int8), q_start, score,
                self.par.gap_open, self.par.gap_extend)
        qseq = self.qdb.sequence(qk)
        bias = self._bias(qk)
        return banded_align(qseq[q_start:q_end + 1],
                            tseq[t_start:t_end + 1],
                            bias[q_start:q_end + 1],
                            self.matrix.sub_int.astype(np.int8), score,
                            self.par.gap_open, self.par.gap_extend)

    # ------------------------------------------------------------------
    def _finish_pair(self, qk: int, tk: int, score: int, q_start: int,
                     q_end: int, t_start: int, t_end: int,
                     evalue: float) -> AlnRecord | None:
        par = self.par
        qseq = self.qdb.sequence(qk)
        tseq = self.tdb.sequence(tk)
        qlen, tlen = len(qseq), len(tseq)

        qcov = compute_cov(q_start, q_end, qlen)
        tcov = compute_cov(t_start, t_end, tlen)
        if not has_coverage(par.cov_thr, par.cov_mode, qcov, tcov):
            return None

        # banded traceback in the rectangle; identity count vectorized
        # (profile queries compare the profile's stored query column)
        ops = self._traceback(qk, tk, q_start, q_end, t_start, t_end, score)
        qid_seq = self.query_profile_seqs.get(qk, qseq)
        b = np.frombuffer(ops.encode(), dtype=np.uint8)
        is_m = b == ord("M")
        q_adv = is_m | (b == ord("I"))
        t_adv = is_m | (b == ord("D"))
        qp = q_start + np.cumsum(q_adv) - q_adv
        tp = t_start + np.cumsum(t_adv) - t_adv
        aa_ids = int((qid_seq[qp[is_m]] == tseq[tp[is_m]]).sum())
        aln_len = len(ops)
        seq_id = np.float32(aa_ids) / np.float32(aln_len)
        bit = int(self.evaluer.compute_bit_score(score) + 0.5)

        # checkCriteria (Alignment.cpp:548-567)
        if not (evalue <= par.eval_thr
                and seq_id >= np.float32(par.seq_id_thr)
                and has_coverage(par.cov_thr, par.cov_mode, qcov, tcov)
                and aln_len >= par.aln_len_thr):
            return None
        return AlnRecord(tkey=tk, score=bit, seq_id=float(seq_id),
                         evalue=evalue, qstart=q_start, qend=q_end, qlen=qlen,
                         tstart=t_start, tend=t_end, tlen=tlen,
                         backtrace=ops, raw_score=score,
                         qcov=float(qcov), tcov=float(tcov))


class _AlignStream:
    """Incremental alignment driver: candidate fragments stream in (from
    the chunked prefilter) and their forward SW pairs are ENQUEUED into
    the device engine's per-rung buffers; every full batch (batch_width
    pairs, one device execution) dispatches asynchronously, overlapping
    device scoring with the host prefilter of later fragments.  finish()
    flushes the tails, collects all forward results in one transfer,
    filters survivors, and runs the reverse pass + traceback.  Buffering
    across fragments keeps device executions full-width: each execution
    has a fixed cost beyond its kernel, so per-fragment partial batches
    would multiply it."""

    def __init__(self, eng: AlignmentEngine):
        self.eng = eng
        self.items: dict[int, list] = {}
        self.pairs: list[tuple[int, int]] = []
        self._dev = None
        self._dev_checked = False
        self._fwd_pending: list = []
        self._fwd_host: list = []     # (global pair idx, host result)
        # with --max-accept/--max-rejected unset (the clustersearch
        # default) the per-candidate accept state machine is a no-op, so
        # the stream keeps array-form fragments and only ACCEPTED
        # records touch Python (vs one loop step per candidate)
        par = eng.par
        self._fast = (par.max_accept >= (1 << 31) - 1
                      and par.max_rejected >= (1 << 31) - 1)
        self._frags: list = []
        # fast path: pairs live as per-fragment (qk, tk) ARRAY blocks
        self._pair_qk: list[np.ndarray] = []
        self._pair_tk: list[np.ndarray] = []
        self._n_pairs = 0

    def _check_dev(self) -> None:
        if not self._dev_checked:
            # engines with custom forward/reverse drivers (the mesh-
            # sharded engine overrides them) run monolithically at
            # finish(); only the base device path streams
            base_fwd = (type(self.eng)._run_forward
                        is AlignmentEngine._run_forward)
            self._dev = self.eng._device_db() if base_fwd else None
            self._dev_checked = True

    def _enqueue_fwd(self, pqk: np.ndarray, ptk: np.ndarray,
                     base: int) -> None:
        """Route one fragment's pair arrays: rare over-ladder pairs to
        the host path, the rest bucketed + enqueued on the device."""
        eng = self.eng
        from ..ops.sw_engine import device_max_len
        mx = np.maximum(eng.qdb.lengths[pqk], eng.tdb.lengths[ptk])
        long = mx > device_max_len()
        if long.any():
            li = np.nonzero(long)[0]
            host_pairs = list(zip(pqk[li].tolist(), ptk[li].tolist()))
            self._fwd_host += list(zip(
                (base + li).tolist(), eng._run_forward_host(host_pairs)))
            keep = np.nonzero(~long)[0]
        else:
            keep = np.arange(len(pqk), dtype=np.int64)
        jobs = eng._forward_jobs_arrays(pqk[keep], ptk[keep], base + keep)
        self._fwd_pending += self._dev.enqueue(
            jobs, eng.par.gap_open, eng.par.gap_extend, reverse=False)

    def add(self, candidates: dict[int, list[int]]) -> None:
        eng = self.eng
        self._check_dev()
        if self._fast:
            qks, aqk, atk, keep_ident, pair_idx, ident_recs = \
                eng._stage0_arrays(candidates)
            base = self._n_pairs
            pair_pos = np.full(len(aqk), -1, dtype=np.int64)
            pair_pos[pair_idx] = base + np.arange(len(pair_idx))
            self._frags.append((qks, aqk, keep_ident, pair_pos,
                                ident_recs))
            pqk, ptk = aqk[pair_idx], atk[pair_idx]
            self._pair_qk.append(pqk)
            self._pair_tk.append(ptk)
            self._n_pairs += len(pair_idx)
            if self._dev is not None and len(pair_idx):
                self._enqueue_fwd(pqk, ptk, base)
            return
        frag_start = eng._stage0(candidates, self.items, self.pairs)
        frag = self.pairs[frag_start:]
        if not frag:
            return
        if self._dev is not None:
            pqk = np.fromiter((p[0] for p in frag), np.int64, len(frag))
            ptk = np.fromiter((p[1] for p in frag), np.int64, len(frag))
            self._enqueue_fwd(pqk, ptk, frag_start)

    def _accept_fast(self, surv_of_pair: dict[int, int],
                     recs) -> dict[int, list[AlnRecord]]:
        """Accept stage without the per-candidate state machine (legal
        when max_accept/max_rejected are unset): only kept candidates
        run Python, in candidate order per query."""
        eng = self.eng
        surv_idx = np.full(max(self._n_pairs, 1), -1, np.int64)
        for pi, si in surv_of_pair.items():
            surv_idx[pi] = si
        recs_ok = (np.fromiter((r is not None for r in recs), bool,
                               len(recs)) if recs
                   else np.zeros(0, dtype=bool))
        accepted: dict[int, list[AlnRecord]] = {}
        for qks, aqk, keep_ident, pair_pos, ident_recs in self._frags:
            for qk in qks:
                accepted.setdefault(qk, [])
            has_pair = pair_pos >= 0
            si = np.full(len(aqk), -1, np.int64)
            si[has_pair] = surv_idx[pair_pos[has_pair]]
            ok = si >= 0
            ok[ok] = recs_ok[si[ok]]
            keep = keep_ident | ok
            for ci in np.nonzero(keep)[0]:
                qk = int(aqk[ci])
                accepted[qk].append(ident_recs[qk] if keep_ident[ci]
                                    else recs[si[ci]])
        if eng.par.alt_alignments > 0:
            eng._compute_alt_alignments(accepted)
        for qk in accepted:
            accepted[qk].sort(key=lambda r: (r.evalue, -r.score, r.tlen,
                                             r.tkey))
        return accepted

    def finish(self) -> dict[int, list[AlnRecord]]:
        eng = self.eng
        self._check_dev()
        if self._fast:
            pqk = (np.concatenate(self._pair_qk) if self._pair_qk
                   else np.empty(0, np.int64))
            ptk = (np.concatenate(self._pair_tk) if self._pair_tk
                   else np.empty(0, np.int64))
            n = self._n_pairs
        else:
            n = len(self.pairs)
            pqk = np.fromiter((p[0] for p in self.pairs), np.int64, n)
            ptk = np.fromiter((p[1] for p in self.pairs), np.int64, n)
        if self._dev is None:
            pairs = list(zip(pqk.tolist(), ptk.tolist()))
            fwd = eng._run_forward(pairs)
            if not self._fast:
                return eng._post_forward(self.items, self.pairs, fwd)
            survivors, surv_of_pair = eng._survivor_filter(pairs, fwd, 0)
            starts = eng._run_reverse(survivors)
            recs = eng._finish_pairs(survivors, starts)
            return self._accept_fast(surv_of_pair, recs)
        from ..ops.sw_engine import device_max_len
        self._fwd_pending += self._dev.flush(
            eng.par.gap_open, eng.par.gap_extend, reverse=False)
        score = np.zeros(n, np.int64)
        q_end = np.zeros(n, np.int64)
        t_end = np.full(n, -1, np.int64)
        for pos, (s, te, qe, _f, _fj, _fi) in \
                self._dev.collect(self._fwd_pending):
            score[pos] = s
            t_end[pos] = te
            q_end[pos] = qe
        for pidx, (s, qe, te) in self._fwd_host:
            score[pidx], q_end[pidx], t_end[pidx] = s, qe, te
        survivors, surv_of_pair = eng._survivor_filter_arrays(
            pqk, ptk, score, q_end, t_end)
        starts: list = [None] * len(survivors)
        if survivors:
            long_loc = [i for i, s in enumerate(survivors)
                        if max(s[3] + 1, s[4] + 1) > device_max_len()]
            long_set = set(long_loc)
            dev_loc = [i for i in range(len(survivors))
                       if i not in long_set]
            if dev_loc:
                pos = np.fromiter(dev_loc, np.int64)
                jobs = eng._reverse_jobs(
                    [survivors[i] for i in dev_loc], 0, positions=pos)
                pend = self._dev.enqueue(jobs, eng.par.gap_open,
                                         eng.par.gap_extend, reverse=True)
                pend += self._dev.flush(eng.par.gap_open,
                                        eng.par.gap_extend, reverse=True)
                eng._decode_reverse(self._dev.collect(pend), survivors,
                                    starts)
            for i, st in zip(long_loc, eng._run_reverse_host(
                    [survivors[i] for i in long_loc])):
                starts[i] = st
        recs = eng._finish_pairs(survivors, starts)
        if self._fast:
            return self._accept_fast(surv_of_pair, recs)
        return eng._accept_stage(self.items, surv_of_pair, recs)
