"""Command-line interface mirroring the reference's command surface
(src/spacedust.cpp:26-120): createsetdb, clustersearch, and utility
commands, with the reference's flag names.

Run as `python -m spacedust_tpu <command> ...`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .db.setdb import SetDB


def _add_clustersearch_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("output")
    p.add_argument("tmp_dir", nargs="?")
    p.add_argument("-s", "--sensitivity", type=float, default=5.7)
    p.add_argument("-e", "--eval-thr", type=float, default=10.0)
    p.add_argument("-c", "--cov-thr", type=float, default=0.8)
    p.add_argument("--cov-mode", type=int, default=2)
    p.add_argument("--max-seqs", type=int, default=300)
    p.add_argument("--aln-len", type=int, default=30, dest="aln_len_thr")
    p.add_argument("--gap-open", type=int, default=11)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--filter-self-match", action="store_true")
    # ALIGNMENT_PAR forwarding (data/clustersearch.sh; the reference
    # align stage receives --max-accept/--max-rejected/--alt-ali)
    p.add_argument("--max-accept", type=int, default=2147483647)
    p.add_argument("--max-rejected", type=int, default=2147483647)
    p.add_argument("--alt-ali", type=int, default=0)
    p.add_argument("--suboptimal-hits", type=int, default=0)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--aggregation-mode", type=int, default=0)
    p.add_argument("--multihit-pval", type=float, default=0.01)
    p.add_argument("--cluster-pval", type=float, default=0.01)
    p.add_argument("--max-gene-gap", type=int, default=3)
    p.add_argument("--cluster-size", type=int, default=2)
    p.add_argument("--mask", type=int, default=1)
    p.add_argument("--comp-bias-corr", type=int, default=1)
    p.add_argument("--split-memory-limit", type=int, default=0,
                   help="bytes; bound the per-split k-mer index "
                        "(out-of-core target splits), 0 = off")
    p.add_argument("--threads", type=int, default=0,
                   help="cap OpenMP threads in the native engines "
                        "(0 = all cores, the reference default)")
    p.add_argument("-k", "--kmer-size", type=int, default=0,
                   help="seed k-mer size (0 = auto: 6, or 7 above "
                        "3.35 G residues — IndexTable.h:439-441)")
    p.add_argument("--spaced-kmer-mode", type=int, default=1,
                   help="1: spaced seed pattern (default), 0: "
                        "consecutive k-mer")
    p.add_argument("--max-seq-len", type=int, default=65535,
                   help="reject sequences longer than this "
                        "(Parameters.cpp maxSeqLen default 65535)")
    p.add_argument("--search-mode", type=int, default=0,
                   help="0: sequence, 1: foldseek-mapped structure + "
                        "unmapped sequence, 2: structure (3Di) search")
    p.add_argument("--foldseek-db",
                   help="aa2foldseek output dir of the query/target "
                        "(search-mode 1; default <db>_foldseek)")
    p.add_argument("--profile-cluster-search", action="store_true")
    p.add_argument("--cluster-db",
                   help="precomputed clusterdb dir of the target "
                        "(default <target_db>_clu; built if absent)")
    p.add_argument("--multihost", type=int, default=0,
                   help="N>1: run the search stage as N query-slice "
                        "worker processes over a shared tmp dir (the "
                        "reference's MPI/$RUNNER analog; "
                        "parallel/multihost.py). Requires "
                        "query_db == target_db. On a real pod, launch "
                        "workers via the cluster runner instead with "
                        "SPACEDUST_{COORDINATOR,NUM_PROCS,PROC_ID}.")
    p.add_argument("--multihost-local-devices", type=int, default=1,
                   help="virtual/real devices per multihost worker")


def _apply_threads(n: int) -> None:
    """--threads: cap the native engines' OpenMP team (Parameters
    PARAM_THREADS; 0 keeps the all-cores default)."""
    if n and n > 0:
        import os
        os.environ["OMP_NUM_THREADS"] = str(n)   # for worker processes
        from .native import set_num_threads
        set_num_threads(n)


def _check_max_seq_len(db, max_seq_len: int) -> None:
    """--max-seq-len (Parameters maxSeqLen, default 65535): hard input
    bound; longer sequences are rejected up front with their names."""
    import numpy as np
    too_long = np.nonzero(db.lengths > max_seq_len)[0]
    if len(too_long):
        names = ", ".join(db.names[int(k)] for k in too_long[:5])
        raise SystemExit(
            f"error: {len(too_long)} sequence(s) exceed --max-seq-len "
            f"{max_seq_len} (first: {names}); raise --max-seq-len")


def cmd_createsetdb(argv: list[str]) -> int:
    from .workflow.createsetdb import create_setdb
    p = argparse.ArgumentParser(prog="spacedust createsetdb")
    p.add_argument("inputs", nargs="+")
    p.add_argument("out_db")
    p.add_argument("tmp_dir", nargs="?")
    p.add_argument("--gff-dir")
    p.add_argument("--gff-type", default="CDS")
    p.add_argument("--translation-table", type=int, default=1)
    p.add_argument("--file-include", default=".*")
    p.add_argument("--file-exclude", default="^$")
    a = p.parse_args(argv)
    db = create_setdb(a.inputs, a.out_db, gff_dir=a.gff_dir,
                      gff_type=a.gff_type,
                      translation_table=a.translation_table,
                      file_include=a.file_include,
                      file_exclude=a.file_exclude)
    print(f"createsetdb: {db.size} genes in {db.num_sets} sets -> {a.out_db}")
    return 0


def cmd_clustersearch(argv: list[str]) -> int:
    from .workflow.clustersearch import (ClusterSearchParams,
                                         cluster_search_to_file)
    p = argparse.ArgumentParser(prog="spacedust clustersearch")
    _add_clustersearch_args(p)
    a = p.parse_args(argv)
    qdb = SetDB.load(a.query_db)
    tdb = qdb if a.target_db == a.query_db else SetDB.load(a.target_db)
    params = ClusterSearchParams(
        sensitivity=a.sensitivity, max_seqs=a.max_seqs, cov_thr=a.cov_thr,
        cov_mode=a.cov_mode, eval_thr=a.eval_thr, aln_len_thr=a.aln_len_thr,
        gap_open=a.gap_open, gap_extend=a.gap_extend,
        max_accept=a.max_accept, max_rejected=a.max_rejected,
        alt_alignments=a.alt_ali,
        subopt_hits_factor=a.suboptimal_hits, alpha=a.alpha,
        aggregation_mode=a.aggregation_mode,
        filter_self_match=a.filter_self_match,
        max_gene_gaps=a.max_gene_gap, cluster_size=a.cluster_size,
        p_clu_thr=a.cluster_pval, p_mh_thr=a.multihit_pval,
        mask=bool(a.mask), comp_bias_correction=bool(a.comp_bias_corr),
        split_memory_limit=a.split_memory_limit,
        profile_cluster_search=a.profile_cluster_search,
        search_mode=a.search_mode,
        kmer_size=a.kmer_size, spaced_kmer_mode=a.spaced_kmer_mode)
    _apply_threads(a.threads)
    _check_max_seq_len(qdb, a.max_seq_len)
    if tdb is not qdb:
        _check_max_seq_len(tdb, a.max_seq_len)
    if a.multihost and a.multihost > 1:
        if a.target_db != a.query_db:
            p.error("--multihost currently requires query_db == target_db")
        from .parallel.multihost import run_multihost
        t0 = time.time()
        run_multihost(a.query_db, a.output, a.multihost, params,
                      tmp_dir=a.tmp_dir,
                      local_devices=a.multihost_local_devices)
        tsv = open(a.output).read()
        n_hits = sum(1 for ln in tsv.splitlines() if ln.startswith(">"))
        n_clusters = sum(1 for ln in tsv.splitlines()
                         if ln.startswith("#"))
        print(f"clustersearch[multihost x{a.multihost}]: {n_clusters} "
              f"clusters / {n_hits} hits in {time.time() - t0:.1f}s "
              f"-> {a.output}")
        return 0
    cdb = None
    if a.profile_cluster_search:
        from .workflow.clusterdb import cluster_db_cached
        cdb = cluster_db_cached(tdb, a.cluster_db or (a.target_db + "_clu"))
    qmap = tmap = None
    if a.search_mode == 1:
        from .workflow.aa2foldseek import load_mapping
        qmap = load_mapping(a.foldseek_db
                            or (a.query_db.rstrip("/") + "_foldseek"))
        tmap = (qmap if a.target_db == a.query_db
                else load_mapping(a.target_db.rstrip("/") + "_foldseek"))
    t0 = time.time()
    res = cluster_search_to_file(qdb, tdb, a.output, a.tmp_dir, params=params,
                                 target_cluster_db=cdb,
                                 query_mapping=qmap, target_mapping=tmap)
    if res.seq_to_clu:
        # ${OUTPUT}_seq_to_clu sidecar (data/clustersearch.sh:157-164:
        # filterdb --trim-to-one-column + swapdb of the cluster DB)
        from .db.mmseqs_io import write_flatdb
        write_flatdb(a.output + "_seq_to_clu",
                     [(k, "".join(f"{c}\n" for c in clus))
                      for k, clus in sorted(res.seq_to_clu.items())],
                     dbtype=5)
    n_hits = sum(1 for ln in res.tsv.splitlines() if ln.startswith(">"))
    n_clusters = sum(1 for ln in res.tsv.splitlines() if ln.startswith("#"))
    print(f"clustersearch: {n_clusters} clusters / {n_hits} hits "
          f"in {time.time()-t0:.1f}s -> {a.output}")
    for k, v in res.timings.items():
        if isinstance(v, float):
            print(f"  {k}: {v:.2f}s")
    return 0


def _read_prefixed_tsv(path: str) -> dict[int, list[list[str]]]:
    """Key-prefixed result lines (the prefixid --tsv idiom): each line is
    `key \\t col1 \\t col2 ...`, grouped by leading key."""
    out: dict[int, list[list[str]]] = {}
    with open(path) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            out.setdefault(int(cols[0]), []).append(cols)
    return out


def _write_prefixed_tsv(path: str, data: dict[int, list[list[str]]]) -> None:
    with open(path, "w") as fh:
        for key in data:
            for cols in data[key]:
                fh.write("\t".join(str(c) for c in cols) + "\n")


def _write_matches(path: str, matches) -> None:
    with open(path, "w") as fh:
        for m in matches:
            fh.write("#" + m.header + "\n")
            for cols in m.lines:
                fh.write("\t".join(cols) + "\n")


def _read_matches(path: str):
    from .cluster.aggregate import Match
    matches = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                c = line[1:].rstrip("\n").split("\t")
                matches.append(Match(qset=int(c[0]), tset=int(c[1]),
                                     nq=int(c[2]), nt=int(c[3]), k=int(c[4]),
                                     combined_eval_str=c[5]))
            else:
                matches[-1].lines.append(line.rstrip("\n").split("\t"))
    return matches


def _write_clusters(path: str, clusters) -> None:
    with open(path, "w") as fh:
        for cl in clusters:
            fh.write("#" + cl.header + "\n")
            for h in cl.hits:
                fh.write(h.line if h.line.endswith("\n") else h.line + "\n")


def _read_clusters(path: str):
    from .cluster.clusterhits import Cluster, Hit
    clusters = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                c = line[1:].rstrip("\n").split("\t")
                clusters.append(Cluster(qset=int(c[0]), tset=int(c[1]),
                                        p_co=float(c[2]), p_mh=float(c[3])))
            else:
                clusters[-1].hits.append(Hit(line=line, pval=0.0, q_pos=0,
                                             t_pos=0, q_strand=True,
                                             t_strand=True))
    return clusters


def cmd_gff2db(argv: list[str]) -> int:
    """Per-genome GFF3 + contig FASTA -> gene SetDB (src/workflow/gff2db.cpp)."""
    from .db.gff import create_setdb_from_gff
    p = argparse.ArgumentParser(prog="spacedust gff2db")
    p.add_argument("fna_inputs", nargs="+")
    p.add_argument("out_db")
    p.add_argument("--gff-dir", required=True,
                   help="file listing one GFF path per line, or a directory")
    p.add_argument("--gff-type", default="CDS")
    p.add_argument("--translation-table", type=int, default=1)
    a = p.parse_args(argv)
    from pathlib import Path
    gd = Path(a.gff_dir)
    if gd.is_dir():
        gff_files = sorted(str(p) for p in gd.glob("*.gff*"))
    else:
        gff_files = [ln.strip() for ln in gd.read_text().splitlines()
                     if ln.strip()]
    db = create_setdb_from_gff(gff_files, a.fna_inputs, gff_type=a.gff_type,
                               translation_table=a.translation_table)
    db.save(a.out_db)
    print(f"gff2db: {db.size} genes in {db.num_sets} sets -> {a.out_db}")
    return 0


def cmd_clusterdb(argv: list[str]) -> int:
    from .cluster.seqcluster import SeqClusterParams
    from .workflow.clusterdb import ClusterDBParams, cluster_db
    p = argparse.ArgumentParser(prog="spacedust clusterdb")
    p.add_argument("in_db")
    p.add_argument("out_dir", nargs="?",
                   help="output dir (default <in_db>_clu)")
    p.add_argument("--min-seq-id", type=float, default=0.7)
    p.add_argument("-c", "--cov-thr", type=float, default=0.8)
    p.add_argument("--cov-mode", type=int, default=0)
    p.add_argument("--cluster-mode", type=int, default=0)
    p.add_argument("-s", "--sensitivity", type=float, default=4.0)
    p.add_argument("--single-step-clustering", type=int, default=1,
                   help="0: cascaded clustering (linclust pass + "
                        "sensitivity ramp), 1: one direct round")
    a = p.parse_args(argv)
    db = SetDB.load(a.in_db)
    par = ClusterDBParams(cluster=SeqClusterParams(
        seq_id_thr=a.min_seq_id, cov_thr=a.cov_thr, cov_mode=a.cov_mode,
        sensitivity=a.sensitivity, mode=a.cluster_mode),
        single_step_clustering=bool(a.single_step_clustering))
    cdb = cluster_db(db, par)
    out = a.out_dir or (a.in_db + "_clu")
    cdb.save(out)
    print(f"clusterdb: {db.size} seqs -> {len(cdb.rep_keys)} clusters -> {out}")
    return 0


def cmd_besthitbyset(argv: list[str]) -> int:
    from .cluster.aggregate import besthit_by_set
    p = argparse.ArgumentParser(prog="spacedust besthitbyset")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("result_tsv", help="key-prefixed alignment lines")
    p.add_argument("out_tsv")
    p.add_argument("--simple-best-hit", type=int, default=1)
    p.add_argument("--suboptimal-hits", type=int, default=0)
    a = p.parse_args(argv)
    tdb = SetDB.load(a.target_db)
    results = _read_prefixed_tsv(a.result_tsv)
    agg = besthit_by_set(results, tdb,
                         simple_best_hit=bool(a.simple_best_hit),
                         subopt_hits_factor=a.suboptimal_hits)
    _write_prefixed_tsv(a.out_tsv, agg)
    return 0


def cmd_mergeresultsbyset(argv: list[str]) -> int:
    from .cluster.aggregate import merge_results_by_set
    p = argparse.ArgumentParser(prog="spacedust mergeresultsbyset")
    p.add_argument("query_db")
    p.add_argument("in_tsv")
    p.add_argument("out_tsv")
    a = p.parse_args(argv)
    qdb = SetDB.load(a.query_db)
    merged = merge_results_by_set(_read_prefixed_tsv(a.in_tsv), qdb)
    _write_prefixed_tsv(a.out_tsv, merged)
    return 0


def cmd_combinehits(argv: list[str]) -> int:
    from .cluster.aggregate import combine_hits
    p = argparse.ArgumentParser(prog="spacedust combinehits")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("merged_tsv", help="set-merged best-hit lines")
    p.add_argument("out")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--aggregation-mode", type=int, default=0)
    p.add_argument("--filter-self-match", action="store_true")
    a = p.parse_args(argv)
    qdb = SetDB.load(a.query_db)
    tdb = qdb if a.target_db == a.query_db else SetDB.load(a.target_db)
    merged = _read_prefixed_tsv(a.merged_tsv)
    matches = combine_hits(merged, qdb, tdb, alpha=a.alpha,
                           aggregation_mode=a.aggregation_mode,
                           filter_self_match=a.filter_self_match)
    _write_matches(a.out, matches)
    return 0


def cmd_clusterhits(argv: list[str]) -> int:
    from .cluster.clusterhits import cluster_hits
    p = argparse.ArgumentParser(prog="spacedust clusterhits")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("matches")
    p.add_argument("out")
    p.add_argument("--multihit-pval", type=float, default=0.01)
    p.add_argument("--cluster-pval", type=float, default=0.01)
    p.add_argument("--max-gene-gap", type=int, default=3)
    p.add_argument("--cluster-size", type=int, default=2)
    p.add_argument("--alpha", type=float, default=1.0)
    a = p.parse_args(argv)
    qdb = SetDB.load(a.query_db)
    tdb = qdb if a.target_db == a.query_db else SetDB.load(a.target_db)
    clusters = cluster_hits(_read_matches(a.matches), qdb, tdb,
                            max_gene_gaps=a.max_gene_gap,
                            cluster_size=a.cluster_size,
                            p_clu_thr=a.cluster_pval,
                            p_mh_thr=a.multihit_pval, alpha=a.alpha)
    _write_clusters(a.out, clusters)
    return 0


def cmd_summarizeresults(argv: list[str]) -> int:
    from .cluster.summarize import summarize_results
    p = argparse.ArgumentParser(prog="spacedust summarizeresults")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("clusters")
    p.add_argument("out_tsv")
    a = p.parse_args(argv)
    qdb = SetDB.load(a.query_db)
    tdb = qdb if a.target_db == a.query_db else SetDB.load(a.target_db)
    tsv = summarize_results(_read_clusters(a.clusters), qdb, tdb)
    with open(a.out_tsv, "w") as fh:
        fh.write(tsv)
    return 0


def cmd_aa2foldseek(argv: list[str]) -> int:
    from .workflow.aa2foldseek import aa2foldseek_cli
    return aa2foldseek_cli(argv)


def _run_search(qdb, tdb, a, same_qt_db: bool):
    """Prefilter + align; returns {query_key: [AlnRecord]}."""
    from .search.alignment import AlignmentEngine, AlignmentParams
    from .search.prefilter import PrefilterEngine
    if getattr(a, "num_iterations", 1) > 1:
        from .search.iterative import (IterativeSearchConfig,
                                       search_iterative)
        cfg = IterativeSearchConfig(
            num_iterations=a.num_iterations, sensitivity=a.sensitivity,
            max_seqs=a.max_seqs, eval_thr=a.eval_thr,
            eval_profile=a.e_profile, cov_thr=a.cov_thr,
            cov_mode=a.cov_mode, aln_len_thr=a.aln_len_thr,
            gap_open=a.gap_open, gap_extend=a.gap_extend,
            mask=bool(a.mask),
            comp_bias_correction=bool(a.comp_bias_corr))
        return search_iterative(qdb, tdb, cfg, same_qt_db=same_qt_db)
    pref = PrefilterEngine(qdb, tdb, sensitivity=a.sensitivity,
                           max_seqs=a.max_seqs, same_qt_db=same_qt_db,
                           comp_bias_correction=bool(a.comp_bias_corr),
                           mask=bool(a.mask),
                           cov_thr=a.cov_thr, cov_mode=a.cov_mode,
                           kmer_size=getattr(a, "kmer_size", 0) or None,
                           spaced_kmer_mode=getattr(a, "spaced_kmer_mode",
                                                    1))
    cands = {qk: [h.seq_id for h in hits]
             for qk, hits in pref.match_all().items()}
    aln_par = AlignmentParams(gap_open=a.gap_open, gap_extend=a.gap_extend,
                              eval_thr=a.eval_thr, cov_thr=a.cov_thr,
                              cov_mode=a.cov_mode, aln_len_thr=a.aln_len_thr,
                              max_accept=getattr(a, "max_accept", 2147483647),
                              max_rejected=getattr(a, "max_rejected",
                                                   2147483647),
                              alt_alignments=getattr(a, "alt_ali", 0),
                              comp_bias_correction=bool(a.comp_bias_corr))
    eng = AlignmentEngine(qdb, tdb, aln_par, same_qt_db=same_qt_db)
    return eng.align_all(cands)


def _run_nucl_search(a) -> int:
    """blastn-style nucleotide contig search (--search-type 3): FASTA in,
    key-prefixed contig-coordinate alignment TSV out (search/nucl.py)."""
    from .search.nucl import nucl_search

    def read_contigs(path: str) -> dict[int, str]:
        out: dict[int, str] = {}
        cur: list[str] = []
        for ln in open(path):
            if ln.startswith(">"):
                if cur:
                    out[len(out)] = "".join(cur)
                    cur = []
            else:
                cur.append(ln.strip())
        if cur:
            out[len(out)] = "".join(cur)
        return out

    q = read_contigs(a.query_db)
    t = q if a.target_db == a.query_db else read_contigs(a.target_db)
    res = nucl_search(q, t, eval_thr=a.eval_thr, max_seqs=a.max_seqs)
    with open(a.output, "w") as fh:
        for k in sorted(res):
            for cols in res[k]:
                fh.write(f"{k}\t" + "\t".join(cols) + "\n")
    n = sum(len(v) for v in res.values())
    print(f"search (nucleotide): {n} alignments -> {a.output}")
    return 0


def cmd_search(argv: list[str]) -> int:
    """Standalone homology search (the inherited `mmseqs search` surface,
    workflow/Search.cpp): setDB x setDB -> alignment records, written as
    key-prefixed TSV or BLAST-m8 with --format-mode 4."""
    from .search.convert import DEFAULT_FORMAT, convert_alignments
    p = argparse.ArgumentParser(prog="spacedust search")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("output")
    p.add_argument("tmp_dir", nargs="?")
    p.add_argument("-s", "--sensitivity", type=float, default=5.7)
    p.add_argument("-e", "--eval-thr", type=float, default=1e-3)
    p.add_argument("-c", "--cov-thr", type=float, default=0.0)
    p.add_argument("--cov-mode", type=int, default=0)
    p.add_argument("--max-seqs", type=int, default=300)
    p.add_argument("--aln-len", type=int, default=0, dest="aln_len_thr")
    p.add_argument("--gap-open", type=int, default=11)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--mask", type=int, default=1)
    p.add_argument("--comp-bias-corr", type=int, default=1)
    p.add_argument("--max-accept", type=int, default=2147483647)
    p.add_argument("--max-rejected", type=int, default=2147483647)
    p.add_argument("--alt-ali", type=int, default=0)
    p.add_argument("--threads", type=int, default=0,
                   help="cap OpenMP threads in the native engines")
    p.add_argument("-k", "--kmer-size", type=int, default=0,
                   help="seed k-mer size (0 = auto by DB size)")
    p.add_argument("--spaced-kmer-mode", type=int, default=1,
                   help="1: spaced seed pattern (default), 0: consecutive")
    p.add_argument("--max-seq-len", type=int, default=65535)
    p.add_argument("--num-iterations", type=int, default=1,
                   help="iterative profile search rounds (the blastpgp.sh "
                        "path, workflow/Search.cpp:202): round 0 searches "
                        "sequences and realigns, later rounds search with "
                        "result2profile PSSMs, subtracting prior hits")
    p.add_argument("--e-profile", type=float, default=0.1,
                   help="profile inclusion E-value; intermediate rounds "
                        "run at min(-e, --e-profile) (Search.cpp:482)")
    p.add_argument("--format-mode", type=int, default=0,
                   help="0: key-prefixed alignment TSV, 4: BLAST-tab "
                        "with column headers, 1: BLAST-tab")
    p.add_argument("--format-output", default=DEFAULT_FORMAT)
    p.add_argument("--search-type", type=int, default=0,
                   help="0/1: protein setDB search; 3: nucleotide contig "
                        "search (query/target are FASTA files)")
    a = p.parse_args(argv)
    if a.search_type == 3:
        return _run_nucl_search(a)
    qdb = SetDB.load(a.query_db)
    tdb = qdb if a.target_db == a.query_db else SetDB.load(a.target_db)
    _apply_threads(a.threads)
    _check_max_seq_len(qdb, a.max_seq_len)
    if tdb is not qdb:
        _check_max_seq_len(tdb, a.max_seq_len)
    records = _run_search(qdb, tdb, a, same_qt_db=a.target_db == a.query_db)
    n = sum(len(v) for v in records.values())
    if a.format_mode in (1, 4):
        text = convert_alignments(records, qdb.names, tdb.names,
                                  a.format_output)
        if a.format_mode == 4:
            text = "\t".join(a.format_output.split(",")) + "\n" + text
        with open(a.output, "w") as fh:
            fh.write(text)
    else:
        _write_prefixed_tsv(a.output,
                            {qk: [[str(qk)] + r.columns() for r in recs]
                             for qk, recs in records.items()})
    print(f"search: {n} alignments -> {a.output}")
    return 0


def cmd_convertalignments(argv: list[str]) -> int:
    """Key-prefixed alignment TSV -> BLAST-m8
    (util/convertalignments.cpp)."""
    from .search.convert import DEFAULT_FORMAT, convert_alignments
    from .search.records import AlnRecord
    p = argparse.ArgumentParser(prog="spacedust convertalignments")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("result_tsv", help="key-prefixed alignment lines")
    p.add_argument("out_m8")
    p.add_argument("--format-output", default=DEFAULT_FORMAT)
    a = p.parse_args(argv)
    qdb = SetDB.load(a.query_db)
    tdb = qdb if a.target_db == a.query_db else SetDB.load(a.target_db)
    records = {qk: [AlnRecord.parse("\t".join(cols[1:])) for cols in rows]
               for qk, rows in _read_prefixed_tsv(a.result_tsv).items()}
    text = convert_alignments(records, qdb.names, tdb.names, a.format_output)
    with open(a.out_m8, "w") as fh:
        fh.write(text)
    return 0


COMMANDS = {
    # the reference's 9 commands (src/spacedust.cpp:26-120)
    "createsetdb": cmd_createsetdb,
    "gff2db": cmd_gff2db,
    "aa2foldseek": cmd_aa2foldseek,
    "clusterdb": cmd_clusterdb,
    "clustersearch": cmd_clustersearch,
    "besthitbyset": cmd_besthitbyset,
    "combinehits": cmd_combinehits,
    "summarizeresults": cmd_summarizeresults,
    "clusterhits": cmd_clusterhits,
    # workflow-internal module stage, exposed for interop
    "mergeresultsbyset": cmd_mergeresultsbyset,
    # inherited base-command surface (hidden in the reference's help,
    # src/spacedust.cpp:16 hide_base_commands, but callable)
    "search": cmd_search,
    "convertalignments": cmd_convertalignments,
}


def main(argv: list[str] | None = None) -> int:
    from .utils import log
    argv = sys.argv[1:] if argv is None else argv
    # global -v/--verbosity (Parameters PARAM_V; Debug levels 0..3)
    if "-v" in argv:
        i = argv.index("-v")
        log.set_verbosity(int(argv[i + 1]))
        argv = argv[:i] + argv[i + 2:]
    if not argv or argv[0] in ("-h", "--help"):
        print("spacedust_tpu — accelerated gene-cluster discovery\n"
              "commands: " + ", ".join(COMMANDS))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}", file=sys.stderr)
        return 1
    timer = log.Timer()
    rc = COMMANDS[cmd](argv[1:])
    log.info(f"Time for processing: {timer.format()}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
