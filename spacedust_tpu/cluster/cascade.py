"""Cascaded clustering: linclust redundancy pass + sensitivity cascade.

Equivalent of the reference's default `mmseqs cluster` workflow
(lib/mmseqs/src/workflow/Cluster.cpp:34-226 +
data/workflow/cascaded_clustering.sh):

  1. a linear-time redundancy pass (`linclust`,
     lib/mmseqs/src/linclust/kmermatcher.cpp): per sequence, pick the
     lowest-hashed k-mers; sequences sharing a selected k-mer are grouped
     under the group's longest sequence, members are verified by gapped
     alignment against that center, and surviving edges are clustered
     greedy-incrementally;
  2. `clusterSteps` rounds of (prefilter -> align -> clust) over the
     shrinking representative sub-DB, with sensitivity ramping linearly
     from 1.0 to the target (Cluster.cpp:194-214: step s_i =
     1 + (target-1) * i / (steps-1); steps = 1 if target <= 2 else 3,
     Cluster.cpp:34-40);
  3. `mergeclusters` composes the per-round assignments back onto the
     original key space (util/mergeclusters.cpp; cascaded_clustering.sh:84).

On the accelerator: verification alignments ride the batched SW kernel via
AlignmentEngine; k-mer selection/hashing is vectorized numpy on host
(bandwidth-trivial next to the alignment work).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..db.setdb import SetDB
from ..search.alignment import AlignmentEngine, AlignmentParams
from .seqcluster import (SeqClusterParams, cluster_sequences,
                         greedy_incremental, length_order)


@dataclass
class LinclustParams:
    """kmermatcher parameters as the reference resolves them for the
    cascade's redundancy pass (setKmerLengthAndAlphabet,
    linclust/kmermatcher.cpp:1267-1291: seqIdThr >= 0.9 -> k=14 over the
    13-letter reduced alphabet; --kmer-per-seq 21)."""
    k: int = 14
    alphabet_size: int = 13
    kmers_per_seq: int = 21
    seq_id_thr: float = 0.9
    cov_thr: float = 0.8
    cov_mode: int = 0
    eval_thr: float = 1e-3


def reduced_alphabet_mapping(target_size: int = 13) -> np.ndarray:
    """ReducedMatrix's greedy mutual-information alphabet reduction
    (lib/mmseqs/src/prefiltering/ReducedMatrix.cpp:36-158): starting
    from the blosum62 joint probabilities over the 20 residues (X
    excluded), repeatedly merge the pair (i, j) maximizing the mutual
    information sum(p * log2(p / pi*pj)) of the coupled matrix; first
    strict maximum in row-major scan wins (coupleWithBestInfo).  Returns
    a (21,) token -> group-id map; X keeps its own final group.  The
    13-letter result is pinned by test_cascade against the reference's
    printed grouping: (A S T)(C)(D N)(E Q)(F Y)(G)(H)(I V)(K R)(L M)
    (P)(W)(X)."""
    from ..stats.submat import load_substitution_matrix
    m = load_substitution_matrix()
    p = m.prob[:20, :20].astype(np.float64).copy()
    groups: list[list[int]] = [[a] for a in range(20)]

    def merged(p, i, j):
        q = np.delete(np.delete(p, j, axis=0), j, axis=1).copy()
        q[i, :] += np.delete(p[j, :], j)
        q[:, i] += np.delete(p[:, j], j)
        q[i, i] += p[j, j]
        return q

    def mutual_info(q):
        pb = q.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            s = np.log2(q / (pb[:, None] * pb[None, :]))
        return float(np.nansum(q * s))

    while len(groups) > target_size - 1:      # -1: X joins at the end
        n = len(groups)
        best, bi, bj = -np.inf, 0, 0
        for i in range(n):
            for j in range(i + 1, n):
                v = mutual_info(merged(p, i, j))
                if v > best:
                    best, bi, bj = v, i, j
        p = merged(p, bi, bj)
        groups[bi] = groups[bi] + groups[bj]
        del groups[bj]
    mapping = np.empty(21, dtype=np.int64)
    for gid, members in enumerate(groups):
        for a in members:
            mapping[a] = gid
    mapping[20] = len(groups)                 # X -> own group
    return mapping


def _hash_kmers(seq: np.ndarray, k: int, mapping: np.ndarray | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """All k-mer codes + multiply-shift hashes for one encoded sequence,
    over the reduced alphabet when `mapping` is given (windows touching
    the X group are skipped, as the reference's Indexer packs only the
    alphabetSize-1 informative letters).  (The reference uses a circular
    hash, kmermatcher.cpp getNextKmer; any uniform hash preserves the
    algorithm — selection is by hash order.)"""
    base = 21
    valid = None
    if mapping is not None:
        x_group = int(mapping[20])
        seq = mapping[seq.astype(np.int64)]
        base = x_group                       # informative group count
        valid_res = seq != x_group
    else:
        valid_res = np.ones(len(seq), bool)
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(seq, k)
    ok = np.lib.stride_tricks.sliding_window_view(valid_res, k).all(axis=1)
    codes = np.zeros(n, dtype=np.uint64)
    for i in range(k):
        codes = codes * np.uint64(base) + win[:, i].astype(np.uint64)
    codes = codes[ok]
    h = codes * np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(29)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(32)
    return codes, h


def linclust(db: SetDB, params: LinclustParams | None = None
             ) -> dict[int, list[int]]:
    """Linear-time redundancy clustering. Returns {rep_key: member_keys}."""
    par = params or LinclustParams()
    lens = db.lengths

    # 1. kmermatcher: per sequence keep the kmers_per_seq lowest-hash
    # k-mers over the reduced alphabet; bucket sequences by k-mer code
    # (kmermatcher.cpp fillKmerBuffer)
    mapping = (reduced_alphabet_mapping(par.alphabet_size)
               if par.alphabet_size < 21 else None)
    buckets: dict[int, list[int]] = {}
    for key in range(db.size):
        codes, h = _hash_kmers(db.sequence(key), par.k, mapping)
        if len(codes) == 0:
            continue
        m = min(par.kmers_per_seq, len(codes))
        sel = np.argpartition(h, m - 1)[:m] if m < len(codes) else slice(None)
        for code in np.unique(codes[sel]):
            buckets.setdefault(int(code), []).append(key)

    # 2. per bucket, the longest member (ties: lowest key) is the center;
    # every other member gets a candidate edge to it (kmermatcher
    # assignGroup semantics)
    cand: dict[int, set[int]] = {}
    for members in buckets.values():
        if len(members) < 2:
            continue
        center = min(members, key=lambda kk: (-int(lens[kk]), kk))
        for m in members:
            if m != center:
                cand.setdefault(m, set()).add(center)

    # 3. verify candidate edges by gapped alignment (the linclust.sh
    # rescorediagonal/align stage) — batched through the SW engine
    aln_par = AlignmentParams(eval_thr=par.eval_thr, cov_thr=par.cov_thr,
                              cov_mode=par.cov_mode,
                              seq_id_thr=par.seq_id_thr)
    eng = AlignmentEngine(db, db, aln_par, same_qt_db=True)
    records = eng.align_all({qk: sorted(ts) for qk, ts in cand.items()})

    # 4. greedy incremental clustering over the verified star edges:
    # longest-first, each unassigned sequence joins its verified center's
    # cluster if that center is itself a representative
    order = length_order(db)
    key_to_int = np.empty(db.size, dtype=np.int64)
    key_to_int[order] = np.arange(db.size)
    adj: list[list[tuple[int, int]]] = [[] for _ in range(db.size)]
    for qk, recs in records.items():
        qi = int(key_to_int[qk])
        for r in recs:
            ti = int(key_to_int[r.tkey])
            score = int(min(r.seq_id, 1.0) * 1000)
            adj[qi].append((ti, score))
            adj[ti].append((qi, score))
    assigned = greedy_incremental(adj)

    clusters: dict[int, list[int]] = {}
    for i in range(db.size):
        rep_key = int(order[assigned[i]])
        clusters.setdefault(rep_key, []).append(int(order[i]))
    return {rep: sorted(ms) for rep, ms in sorted(clusters.items())}


def merge_clusters(rounds: list[dict[int, list[int]]]) -> dict[int, list[int]]:
    """Compose per-round assignments (mergeclusters semantics): round i+1
    clusters representatives of round i; final clusters are over the
    original keys of round 0."""
    if not rounds:
        return {}
    merged = {rep: list(ms) for rep, ms in rounds[0].items()}
    for nxt in rounds[1:]:
        out: dict[int, list[int]] = {}
        for rep, member_reps in nxt.items():
            acc: list[int] = []
            for mr in member_reps:
                acc.extend(merged[mr])
            out[rep] = sorted(acc)
        merged = out
    return dict(sorted(merged.items()))


def cascade_steps(sensitivity: float) -> list[float]:
    """Cluster.cpp:34-40,194-214: 1 step at target if s <= 2, else 3 steps
    ramping 1.0 -> target linearly."""
    if sensitivity <= 2.0:
        return [sensitivity]
    steps = 3
    step_size = (sensitivity - 1.0) / (steps - 1)
    return [1.0 + step_size * i for i in range(steps)]


def cascaded_cluster(db: SetDB, params: SeqClusterParams | None = None,
                     linclust_params: LinclustParams | None = None
                     ) -> dict[int, list[int]]:
    """linclust redundancy pass + sensitivity cascade + merge.
    Returns {representative key: sorted member keys} over `db`'s keys."""
    par = params or SeqClusterParams()
    rounds: list[dict[int, list[int]]] = []

    clu0 = linclust(db, linclust_params)
    rounds.append(clu0)
    reps = sorted(clu0)

    for sens in cascade_steps(par.sensitivity):
        if len(reps) <= 1:
            break
        sub = db.subset(reps)
        sub_par = replace(par, sensitivity=sens)
        sub_clu = cluster_sequences(sub, sub_par)
        # sub keys are positions into `reps`
        rounds.append({reps[r]: [reps[m] for m in ms]
                       for r, ms in sub_clu.items()})
        reps = sorted(rounds[-1])

    return merge_clusters(rounds)
