"""Multi-chip clustersearch: target-sharded prefilter + mesh-sharded SW.

The real pipeline over a device mesh, mirroring the reference's MPI
target-split mode (Prefiltering.cpp:575-722, Alignment.cpp:219-242):

  1. the target SetDB is cut into residue-balanced contiguous shards
     (parallel/split.py = decomposeDomainByAminoAcid semantics);
  2. the k-mer prefilter runs per shard (shard-local index, exactly the
     single-chip engine's semantics) and per-query shard hit lists are
     merged with a recomputed global histogram threshold — the analog of
     the reference's split merge + re-threshold
     (Prefiltering::mergeTargetSplits, Prefiltering.cpp:379-560);
  3. Smith-Waterman runs on the mesh: device d holds shard d's tokens
     resident in its memory and scores only pairs whose target lives in
     its shard (parallel/sw_sharded.py); per-shard results merge on host
     (or via an all-gather, ShardedAlignDB.gather_scores);
  4. the aggregation tail (besthit -> combinehits -> clusterhits ->
     summarize) is unchanged — it consumes the merged records.

Because the per-pair SW math and the per-target prefilter state machine
are split-invariant, an n-device sharded search produces the same
records as the single-chip path (tests/test_multichip.py asserts TSV
equality on a real-genome slice).  The only caveat, shared with the
reference's own split mode, is tie ORDER inside the --max-seqs
truncation when a query saturates the hit cap.
"""

from __future__ import annotations

import numpy as np

from ..db.setdb import SetDB
from ..search.alignment import AlignmentEngine, AlignmentParams
from ..search.prefilter import PrefilterEngine, PrefilterHit, _score_threshold
from .split import residue_balanced_splits
from .sw_sharded import ShardedAlignDB, make_mesh


def sharded_prefilter(query_db: SetDB, target_db: SetDB,
                      shards: list[tuple[int, int]],
                      sensitivity: float = 5.7, max_seqs: int = 300,
                      min_diag_score: int = 15,
                      comp_bias_correction: bool = True, mask: bool = True,
                      cov_thr: float = 0.0, cov_mode: int = 0,
                      same_qt_db: bool = False,
                      sequential: bool = False,
                      query_chunk: int = 8192,
                      qrange: tuple[int, int] | None = None
                      ) -> dict[int, list[PrefilterHit]]:
    """Target-split prefilter with a CACHED per-query k-mer beam.

    The reference's target-split mode regenerates the per-query
    similar-k-mer beam for every split (Prefiltering.cpp:662-723) —
    the beam dominates on small shards, capping scaling.  Here the
    split is restructured: broadcast the tiny global state, shard only
    the heavy state.

      1. each shard builds its local index (parallel; the postings are
         the memory-heavy part and scale 1/n per device);
      2. the 8 MB k-mer occupancy bitmaps are OR-ed into a GLOBAL
         occupancy mask (across hosts: an all-reduce-OR — 8 MB,
         trivially replicable);
      3. the beam is generated ONCE per query, pre-screened against the
         global mask (~97% of generated k-mers hit nothing anywhere and
         are dropped before any shard sees them);
      4. every shard is probed with the cached, screened beam — the
         per-shard probe cost now scales with the shard's postings, not
         with the full beam;
      5. per-query shard hit lists merge under the global histogram
         re-threshold (Prefiltering::mergeTargetSplits semantics), then
         identity slot / --max-seqs / coverage in single-chip order.

    `sequential=True` is the out-of-core mode (--split-memory-limit):
    shards are processed one at a time with at most one shard index in
    memory (beam caching is skipped there — the unscreened beam would
    itself break the memory budget).

    Wall-time accounting lands in sharded_prefilter.last_stats:
    index_s (per shard), beam_s, probe_s (per shard), merge_s.
    """
    import os
    import time
    from concurrent.futures import ThreadPoolExecutor
    from ..constants import X_INDEX
    from ..native import (build_shard_mask_table, partition_beams,
                          prefilter_generate_beams, prefilter_match_beams)
    from .merge import merge_shard_hits

    if sequential:
        return _sharded_prefilter_rebuild(
            query_db, target_db, shards, sensitivity=sensitivity,
            max_seqs=max_seqs, min_diag_score=min_diag_score,
            comp_bias_correction=comp_bias_correction, mask=mask,
            cov_thr=cov_thr, cov_mode=cov_mode, same_qt_db=same_qt_db)

    width = max(1, min(len(shards), (os.cpu_count() or 2) // 2))

    # --- 1. per-shard engines (index build; concurrent) ---------------
    def build(args):
        si, (s, e) = args
        t0 = time.perf_counter()
        # zero-copy view of the contiguous shard: with an mmapped SetDB
        # only the shard actually touched becomes resident
        eng = PrefilterEngine(query_db, target_db.subrange(s, e),
                              sensitivity=sensitivity, max_seqs=max_seqs,
                              min_diag_score=min_diag_score,
                              same_qt_db=False,
                              comp_bias_correction=comp_bias_correction,
                              mask=mask, cov_thr=0.0, cov_mode=0)
        return eng, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=width) as pool:
        built = list(pool.map(build, enumerate(shards)))
    engines = [b[0] for b in built]
    index_s = [round(b[1], 3) for b in built]
    e0 = engines[0]

    # --- 2. global occupancy + shard mask table -----------------------
    # (on hardware: all-gather the 8 MB per-shard bitmaps, then each
    # host derives the union mask and the per-k-mer shard-bit table)
    t0 = time.perf_counter()
    shard_bitmaps = np.ascontiguousarray(
        np.stack([eng.index.occupied for eng in engines]))
    gbm = np.bitwise_or.reduce(shard_bitmaps, axis=0)
    n_sh = len(shards)
    mask_tables = [build_shard_mask_table(
        np.ascontiguousarray(shard_bitmaps[g:g + 8]))
        for g in range(0, n_sh, 8)]
    bitmap_or_s = time.perf_counter() - t0

    # --- 3+4. chunked beam generation + concurrent shard probes -------
    qoffs_all = query_db.offsets
    q_lo, q_hi = qrange if qrange is not None else (0, query_db.size)
    beam_s = 0.0
    probe_s = [0.0] * len(shards)
    seed_sub = np.ascontiguousarray(e0.seed.sub_int, dtype=np.int32)
    p_back = np.ascontiguousarray(e0.seed.p_back, dtype=np.float64)
    ungapped_sub = np.ascontiguousarray(e0.ungapped.sub_int, dtype=np.int32)
    sc3 = np.ascontiguousarray(e0.tables.scores, dtype=np.int16)
    id3 = np.ascontiguousarray(e0.tables.idx, dtype=np.int16)
    # chunk results: per shard, lists of compact hit arrays
    acc_qk, acc_seq, acc_score, acc_diag, acc_arr = [], [], [], [], []
    j_range = np.arange(max_seqs)

    for cs in range(q_lo, q_hi, query_chunk):
        ce = min(cs + query_chunk, q_hi)
        qdata = np.ascontiguousarray(
            query_db.seq_data[qoffs_all[cs]:qoffs_all[ce]], dtype=np.uint8)
        qoffs = np.ascontiguousarray(qoffs_all[cs:ce] - qoffs_all[cs],
                                     dtype=np.int64)
        qlens = np.ascontiguousarray(query_db.lengths[cs:ce],
                                     dtype=np.int32)
        t0 = time.perf_counter()
        t2 = e0.tables2
        beam_kmer, beam_win, beam_offs, corr8 = prefilter_generate_beams(
            qdata, qoffs, qlens, seed_sub, p_back, comp_bias_correction,
            sc3, id3, gbm, X_INDEX, e0.kmer_thr, want_corr8=True,
            kmer_size=e0.kmer_size,
            sc2=(np.ascontiguousarray(t2.scores, dtype=np.int16)
                 if t2 is not None else None),
            id2=(np.ascontiguousarray(t2.idx, dtype=np.int16)
                 if t2 is not None else None))
        # per-shard sub-beams: on hardware each query host ships every
        # target-shard host only the beam k-mers its bitmap can match
        ncq = ce - cs
        parts = []       # (group base, pk, pw, poffs)
        for gi, g in enumerate(range(0, n_sh, 8)):
            pk, pw, poffs = partition_beams(
                beam_kmer, beam_win, beam_offs, mask_tables[gi],
                min(8, n_sh - g))
            parts.append((g, pk, pw, poffs))
        del beam_kmer, beam_win
        beam_s += time.perf_counter() - t0

        def probe(args):
            si, eng = args
            g, pk, pw, poffs = parts[si // 8]
            li = si - g
            t0 = time.perf_counter()
            idx = eng.index
            o_seq, o_score, o_diag, o_cnt, _ = prefilter_match_beams(
                qdata, qoffs, qlens, seed_sub, p_back,
                comp_bias_correction, pk, pw,
                poffs[li * ncq:li * ncq + ncq + 1],
                idx.hkeys, idx.hoff, idx.hcnt, None,
                np.ascontiguousarray(idx.seq_ids, dtype=np.int32),
                np.ascontiguousarray(idx.positions, dtype=np.int32),
                np.ascontiguousarray(idx.t_data, dtype=np.uint8),
                np.ascontiguousarray(idx.t_offsets, dtype=np.int64),
                np.ascontiguousarray(eng._tlens, dtype=np.int32),
                ungapped_sub, max_seqs, min_diag_score, eng._bin_count,
                -1, 0.0, 0, corr8=corr8)
            dt = time.perf_counter() - t0
            # compact: (qk, global seq, score, diag, shard arrival)
            cnt = o_cnt[:ncq]
            m = j_range[None, :] < cnt[:, None]
            qi_idx, j_idx = np.nonzero(m)
            flat = qi_idx * max_seqs + j_idx
            return (si, dt, (qi_idx + cs).astype(np.int64),
                    o_seq[flat].astype(np.int64) + shards[si][0],
                    o_score[flat].astype(np.int64),
                    o_diag[flat].astype(np.int64),
                    (si * max_seqs + j_idx).astype(np.int64))

        with ThreadPoolExecutor(max_workers=width) as pool:
            for si, dt, qk, sq, sc, dg, ar in pool.map(
                    probe, enumerate(engines)):
                probe_s[si] += dt
                acc_qk.append(qk)
                acc_seq.append(sq)
                acc_score.append(sc)
                acc_diag.append(dg)
                acc_arr.append(ar)

    # --- 5. vectorized global merge -----------------------------------
    t0 = time.perf_counter()
    out = merge_shard_hits(
        np.concatenate(acc_qk) if acc_qk else np.empty(0, np.int64),
        np.concatenate(acc_seq) if acc_seq else np.empty(0, np.int64),
        np.concatenate(acc_score) if acc_score else np.empty(0, np.int64),
        np.concatenate(acc_diag) if acc_diag else np.empty(0, np.int64),
        np.concatenate(acc_arr) if acc_arr else np.empty(0, np.int64),
        q_lo, q_hi, query_db.lengths, target_db.lengths, max_seqs,
        min_diag_score, cov_thr, cov_mode, same_qt_db)
    merge_s = time.perf_counter() - t0
    sharded_prefilter.last_stats = {
        "index_s": index_s,
        "bitmap_or_s": round(bitmap_or_s, 3),
        "beam_s": round(beam_s, 3),
        "probe_s": [round(t, 3) for t in probe_s],
        "merge_s": round(merge_s, 3),
    }
    return out


def _sharded_prefilter_rebuild(query_db: SetDB, target_db: SetDB,
                               shards: list[tuple[int, int]],
                               sensitivity: float = 5.7, max_seqs: int = 300,
                               min_diag_score: int = 15,
                               comp_bias_correction: bool = True,
                               mask: bool = True,
                               cov_thr: float = 0.0, cov_mode: int = 0,
                               same_qt_db: bool = False
                               ) -> dict[int, list[PrefilterHit]]:
    """Out-of-core split (--split-memory-limit): shards processed
    SEQUENTIALLY, one engine (one shard index) in memory at a time —
    the reference's non-MPI sequential target split
    (Prefiltering.cpp:662-723)."""
    import time
    from .merge import merge_shard_hits

    acc_qk, acc_seq, acc_score, acc_diag, acc_arr = [], [], [], [], []
    shard_s = []
    nq = query_db.size
    j_range = np.arange(max_seqs)
    for si, (s, e) in enumerate(shards):
        t0 = time.perf_counter()
        shard_db = target_db.subrange(s, e)
        eng = PrefilterEngine(query_db, shard_db, sensitivity=sensitivity,
                              max_seqs=max_seqs,
                              min_diag_score=min_diag_score,
                              same_qt_db=False,
                              comp_bias_correction=comp_bias_correction,
                              mask=mask, cov_thr=0.0, cov_mode=0)
        hits = eng.match_all()
        for qk, hs in hits.items():
            n = len(hs)
            if n == 0:
                continue
            acc_qk.append(np.full(n, qk, np.int64))
            acc_seq.append(np.fromiter((h.seq_id + s for h in hs),
                                       np.int64, n))
            acc_score.append(np.fromiter((h.score for h in hs), np.int64, n))
            acc_diag.append(np.fromiter((h.diagonal for h in hs),
                                        np.int64, n))
            acc_arr.append(si * max_seqs + j_range[:n].astype(np.int64))
        del eng
        shard_s.append(round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    out = merge_shard_hits(
        np.concatenate(acc_qk) if acc_qk else np.empty(0, np.int64),
        np.concatenate(acc_seq) if acc_seq else np.empty(0, np.int64),
        np.concatenate(acc_score) if acc_score else np.empty(0, np.int64),
        np.concatenate(acc_diag) if acc_diag else np.empty(0, np.int64),
        np.concatenate(acc_arr) if acc_arr else np.empty(0, np.int64),
        0, nq, query_db.lengths, target_db.lengths, max_seqs,
        min_diag_score, cov_thr, cov_mode, same_qt_db)
    _sharded_prefilter_rebuild.last_stats = {
        "shard_s": shard_s,
        "merge_s": round(time.perf_counter() - t0, 3),
    }
    return out


def query_split_prefilter(query_db: SetDB, target_db: SetDB,
                          n_splits: int,
                          sensitivity: float = 5.7, max_seqs: int = 300,
                          comp_bias_correction: bool = True,
                          mask: bool = True, cov_thr: float = 0.0,
                          cov_mode: int = 0, same_qt_db: bool = False
                          ) -> dict[int, list[PrefilterHit]]:
    """Query-split mode (the reference's preferred split when the index
    fits memory, Prefiltering.cpp:273-377): every host holds the full
    target index and prefilters a residue-balanced query slice.  Unlike
    the target split, the per-query k-mer beam generation — the dominant
    cost — shards linearly, and the merge is a trivial concatenation
    (results are per-query complete).  Per-slice wall times land in
    query_split_prefilter.last_stats."""
    import time
    eng = PrefilterEngine(query_db, target_db, sensitivity=sensitivity,
                          max_seqs=max_seqs, same_qt_db=same_qt_db,
                          comp_bias_correction=comp_bias_correction,
                          mask=mask, cov_thr=cov_thr, cov_mode=cov_mode)
    splits = residue_balanced_splits(query_db.lengths, n_splits)
    out: dict[int, list[PrefilterHit]] = {}
    times = []
    for (s, e) in splits:
        t0 = time.perf_counter()
        out.update(eng.match_range(s, e))
        times.append(round(time.perf_counter() - t0, 3))
    query_split_prefilter.last_stats = {"slice_s": times}
    return out


class ShardedAlignmentEngine(AlignmentEngine):
    """AlignmentEngine whose forward/reverse SW batches run on a device
    mesh with per-device target-shard residency."""

    def __init__(self, query_db: SetDB, target_db: SetDB,
                 params: AlignmentParams, mesh,
                 shards: list[tuple[int, int]],
                 same_qt_db: bool | None = None):
        super().__init__(query_db, target_db, params, same_qt_db=same_qt_db)
        from ..native import comp_bias_batch
        self.mesh = mesh
        self.shards = shards
        self.key_bounds = np.array([s for s, _ in shards] + [shards[-1][1]],
                                   dtype=np.int64)
        qdata = np.ascontiguousarray(query_db.seq_data, dtype=np.uint8)
        qoffs = np.ascontiguousarray(query_db.offsets[:-1], dtype=np.int64)
        qlens = np.ascontiguousarray(query_db.lengths, dtype=np.int32)
        if params.comp_bias_correction:
            qbias = comp_bias_batch(
                qdata, qoffs, qlens,
                np.ascontiguousarray(self.matrix.sub_int, dtype=np.int32),
                np.ascontiguousarray(self.matrix.p_back, dtype=np.float64))
        else:
            qbias = np.zeros(len(qdata), dtype=np.int8)
        self._qoffs = qoffs
        toffs = target_db.offsets
        tok_bounds = [(int(toffs[s]), int(toffs[e])) for s, e in shards]
        self._toffs = toffs
        self._tok_starts = np.array([b[0] for b in tok_bounds], dtype=np.int64)
        self.sharded_db = ShardedAlignDB(
            mesh, qdata, qbias,
            np.ascontiguousarray(target_db.seq_data, dtype=np.uint8),
            tok_bounds, self.matrix.sub_int)

    def _shard_of(self, tkeys: np.ndarray) -> np.ndarray:
        return (np.searchsorted(self.key_bounds, tkeys, side="right")
                - 1).astype(np.int64)

    def _run_grid_jobs(self, qk, tk, ql, tl, term, reverse: bool):
        """Dispatch (qk, tk) pairs over the mesh grid; ql/tl are the
        (possibly truncated) SW lengths. Returns per-pair result tuples."""
        from ..ops.sw_engine import bucket_len, batch_width
        n = len(qk)
        out = [None] * n
        if n == 0:
            return out
        n_dev = self.mesh.devices.size
        shard = self._shard_of(tk)
        buckets: dict[tuple[int, int], list[int]] = {}
        for i in range(n):
            buckets.setdefault((bucket_len(int(ql[i])), bucket_len(int(tl[i]))),
                               []).append(i)
        for key, idxs in sorted(buckets.items()):
            per_dev: list[list[int]] = [[] for _ in range(n_dev)]
            for i in idxs:
                per_dev[shard[i]].append(i)
            W = batch_width(*key)
            rounds = max(1, -(-max(len(p) for p in per_dev) // W))
            for r in range(rounds):
                chunks = [p[r * W:(r + 1) * W] for p in per_dev]
                B = max(len(c) for c in chunks)
                if B == 0:
                    continue
                grid = np.zeros((5, n_dev, B), dtype=np.int32)
                grid[1] = 1  # qlen pad
                grid[3] = 1  # tlen pad
                for d, c in enumerate(chunks):
                    if not c:
                        continue
                    sel = np.asarray(c)
                    grid[0, d, :len(c)] = self._qoffs[qk[sel]]
                    grid[1, d, :len(c)] = ql[sel]
                    grid[2, d, :len(c)] = (self._toffs[tk[sel]]
                                           - self._tok_starts[d])
                    grid[3, d, :len(c)] = tl[sel]
                    grid[4, d, :len(c)] = term[sel]
                res = self.sharded_db.run_grid(
                    key, grid[0], grid[1], grid[2], grid[3], grid[4],
                    self.par.gap_open, self.par.gap_extend, reverse)
                for d, c in enumerate(chunks):
                    for bi, pidx in enumerate(c):
                        out[pidx] = tuple(int(x[d, bi]) for x in res)
        return out

    def _run_forward(self, pairs):
        if not pairs:
            return []
        qlens_all, tlens_all = self.qdb.lengths, self.tdb.lengths
        dev_idx, host_idx = self._split_device_eligible(
            [max(int(qlens_all[p[0]]), int(tlens_all[p[1]]))
             for p in pairs])
        out = [None] * len(pairs)
        if dev_idx:
            sub = [pairs[i] for i in dev_idx]
            n = len(sub)
            qk = np.fromiter((p[0] for p in sub), np.int64, n)
            tk = np.fromiter((p[1] for p in sub), np.int64, n)
            ql = qlens_all[qk].astype(np.int32)
            tl = tlens_all[tk].astype(np.int32)
            term = np.zeros(n, np.int32)
            res = self._run_grid_jobs(qk, tk, ql, tl, term, reverse=False)
            for i, r in zip(dev_idx, res):
                out[i] = (r[0], r[2], r[1])   # (score, q_end, t_end)
        if host_idx:
            for i, r in zip(host_idx, self._run_forward_host(
                    [pairs[i] for i in host_idx])):
                out[i] = r
        return out

    def _run_reverse(self, survivors):
        if not survivors:
            return []
        dev_idx, host_idx = self._split_device_eligible(
            [max(s[3] + 1, s[4] + 1) for s in survivors])
        out = [None] * len(survivors)
        if dev_idx:
            sub = [survivors[i] for i in dev_idx]
            n = len(sub)
            qk = np.fromiter((s[0] for s in sub), np.int64, n)
            tk = np.fromiter((s[1] for s in sub), np.int64, n)
            term = np.fromiter((s[2] for s in sub), np.int32, n)
            ql = np.fromiter((s[3] + 1 for s in sub), np.int32, n)
            tl = np.fromiter((s[4] + 1 for s in sub), np.int32, n)
            res = self._run_grid_jobs(qk, tk, ql, tl, term, reverse=True)
            for i, ((qs, ts), r) in zip(dev_idx,
                                        zip(((s[3], s[4]) for s in sub),
                                            res)):
                found, fj, fi = r[3:]
                if not found:
                    raise RuntimeError("forward/backward SW scores differ")
                out[i] = (qs - fi, ts - fj)
        if host_idx:
            for i, r in zip(host_idx, self._run_reverse_host(
                    [survivors[i] for i in host_idx])):
                out[i] = r
        return out


def sharded_search(query_db: SetDB, target_db: SetDB, mesh=None,
                   n_shards: int | None = None, params=None,
                   same_qt_db: bool | None = None,
                   sensitivity: float = 5.7, max_seqs: int = 300,
                   mask: bool = True):
    """Full sharded search stage: prefilter + alignment over the mesh.
    Returns records identical to PrefilterEngine + AlignmentEngine."""
    mesh = mesh or make_mesh()
    par = params or AlignmentParams()
    if same_qt_db is None:
        same_qt_db = query_db is target_db
    n = n_shards or mesh.devices.size
    shards = residue_balanced_splits(target_db.lengths, n)
    cands_hits = sharded_prefilter(
        query_db, target_db, shards, sensitivity=sensitivity,
        max_seqs=max_seqs, comp_bias_correction=par.comp_bias_correction,
        mask=mask, cov_thr=par.cov_thr, cov_mode=par.cov_mode,
        same_qt_db=same_qt_db)
    candidates = {qk: [h.seq_id for h in hs] for qk, hs in cands_hits.items()}
    eng = ShardedAlignmentEngine(query_db, target_db, par, mesh, shards,
                                 same_qt_db=same_qt_db)
    return eng.align_all(candidates)


def sharded_cluster_search(query_db: SetDB, target_db: SetDB, params=None,
                           mesh=None, n_shards: int | None = None):
    """clustersearch with the search stage sharded over a device mesh;
    the aggregation tail is the standard host path."""
    from ..workflow.clustersearch import (ClusterSearchParams,
                                          ClusterSearchResult)
    from ..cluster.aggregate import (besthit_by_set, merge_results_by_set,
                                     combine_hits)
    from ..cluster.clusterhits import cluster_hits
    from ..cluster.summarize import summarize_results, seq_to_clu

    par = params or ClusterSearchParams()
    apar = AlignmentParams(gap_open=par.gap_open, gap_extend=par.gap_extend,
                           eval_thr=par.eval_thr, cov_thr=par.cov_thr,
                           cov_mode=par.cov_mode,
                           aln_len_thr=par.aln_len_thr,
                           comp_bias_correction=par.comp_bias_correction)
    records = sharded_search(query_db, target_db, mesh=mesh,
                             n_shards=n_shards, params=apar,
                             same_qt_db=query_db is target_db,
                             sensitivity=par.sensitivity,
                             max_seqs=par.max_seqs, mask=par.mask)
    results = {qk: [[str(qk)] + r.columns() for r in recs]
               for qk, recs in records.items()}
    agg = besthit_by_set(results, target_db,
                         simple_best_hit=par.simple_best_hit,
                         subopt_hits_factor=par.subopt_hits_factor)
    merged = merge_results_by_set(agg, query_db)
    matches = combine_hits(merged, query_db, target_db, alpha=par.alpha,
                           aggregation_mode=par.aggregation_mode,
                           filter_self_match=par.filter_self_match)
    clusters = cluster_hits(matches, query_db, target_db,
                            max_gene_gaps=par.max_gene_gaps,
                            cluster_size=par.cluster_size,
                            p_clu_thr=par.p_clu_thr,
                            p_mh_thr=par.p_mh_thr, alpha=par.alpha)
    tsv = summarize_results(clusters, query_db, target_db)
    return ClusterSearchResult(tsv=tsv, clusters=clusters, matches=matches,
                               seq_to_clu=seq_to_clu(clusters))
