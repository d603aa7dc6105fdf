"""Multi-host (multi-process) clustersearch — the reference's MPI analog.

The reference distributes the search stage by giving every MPI rank one
split and exchanging DATA through the shared filesystem; only rank
scheduling, a barrier, and the master-side merge go through MPI
(lib/mmseqs/src/prefiltering/Prefiltering.cpp:575-660,
lib/mmseqs/src/commons/MMseqsMPI.h:26-34, data/workflow/blastp.sh:62-97
"$RUNNER" injection).  The equivalent here keeps that shape:

  * across hosts (processes): QUERY-slice data parallelism — each
    process owns a residue-balanced slice of the queries
    (decomposeDomainByAminoAcid semantics, parallel/split.py) and runs
    the full search stage for it.  Per-query results are complete, so
    the merge is pure concatenation, exactly the reference's
    query-split mode (Prefiltering.cpp:273-377).
  * within a host: the process's local device mesh runs the
    target-sharded engine (parallel/pipeline.py) or the single-chip
    engine, unchanged.
  * rendezvous: search-stage records are written as reference-format
    flat DBs into the shared tmp dir (db/mmseqs_io.py); rank 0 merges
    and runs the aggregation tail (besthit -> combinehits ->
    clusterhits -> summarize), mirroring MMseqsMPI's master-only merge.
  * process identity comes from SPACEDUST_NUM_PROCS / SPACEDUST_PROC_ID
    (on a cluster, from its runner); the global barrier is a filesystem
    sentinel.  A worker computes on its own devices only, so it needs no
    JAX distributed runtime; SPACEDUST_USE_JAX_DISTRIBUTED=1 runs
    `jax.distributed.initialize` against SPACEDUST_COORDINATOR anyway.

`run_multihost` is the in-host launcher (the mpirun stand-in): it
spawns N local worker processes over the same artifact dir and waits.
On a GPU host each worker gets its own `local_devices` cards through
CUDA_VISIBLE_DEVICES; with JAX_PLATFORMS=cpu each gets that many virtual
CPU devices.  On real multi-host hardware, the cluster runner launches
`python -m spacedust_tpu.parallel.multihost <args>` once per host
instead.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path


def _try_init_distributed() -> tuple[int, int]:
    """(proc_id, n_procs) from the SPACEDUST_* env; with
    SPACEDUST_USE_JAX_DISTRIBUTED=1 and a coordinator set, also joins the
    JAX distributed runtime (falling back to the filesystem barrier if
    the handshake fails)."""
    coord = os.environ.get("SPACEDUST_COORDINATOR")
    n_procs = int(os.environ.get("SPACEDUST_NUM_PROCS", "1"))
    proc_id = int(os.environ.get("SPACEDUST_PROC_ID", "0"))
    if (coord and n_procs > 1
            and os.environ.get("SPACEDUST_USE_JAX_DISTRIBUTED") == "1"):
        import jax
        try:
            jax.distributed.initialize(coordinator_address=coord,
                                       num_processes=n_procs,
                                       process_id=proc_id)
            # marker for tests/ops: the handshake actually ran
            # (jax.process_count() now reflects the cluster)
            sentinel = os.environ.get("SPACEDUST_DISTRIBUTED_SENTINEL")
            if sentinel:
                Path(sentinel).with_suffix(f".rank{proc_id}").write_text(
                    f"{jax.process_index()}/{jax.process_count()}")
        except Exception as e:      # noqa: BLE001 — fs barrier fallback
            print(f"[multihost] jax.distributed unavailable ({e}); "
                  "using filesystem barrier", file=sys.stderr)
    return proc_id, n_procs


def _barrier(tmp: Path, proc_id: int, n_procs: int, stage: str,
             timeout_s: float = 3600.0) -> None:
    """Filesystem sentinel barrier (the notExists idiom applied to
    rank coordination; data already flows via the shared fs)."""
    (tmp / f"{stage}.rank{proc_id}.done").write_text("")
    t0 = time.time()
    while True:
        if all((tmp / f"{stage}.rank{r}.done").exists()
               for r in range(n_procs)):
            return
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"barrier {stage}: peers missing")
        time.sleep(0.05)


def worker(db_path: str, tmp_dir: str, out_path: str,
           params_json: str, n_shards: int | None = None) -> None:
    """One rank of the multi-host clustersearch."""
    proc_id, n_procs = _try_init_distributed()
    tmp = Path(tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)

    from ..db.mmseqs_io import write_flatdb
    from ..db.setdb import SetDB
    from ..search.alignment import AlignmentParams
    from ..workflow.clustersearch import ClusterSearchParams
    from .split import residue_balanced_splits

    par = ClusterSearchParams(**json.loads(params_json))
    db = SetDB.load(db_path)

    slices = residue_balanced_splits(db.lengths, n_procs)
    s, e = slices[proc_id]
    qslice = list(range(s, e))

    apar = AlignmentParams(gap_open=par.gap_open, gap_extend=par.gap_extend,
                           eval_thr=par.eval_thr, cov_thr=par.cov_thr,
                           cov_mode=par.cov_mode,
                           aln_len_thr=par.aln_len_thr,
                           max_accept=par.max_accept,
                           max_rejected=par.max_rejected,
                           alt_alignments=par.alt_alignments,
                           comp_bias_correction=par.comp_bias_correction)

    import jax
    use_mesh = len(jax.local_devices()) > 1 and n_shards != 1
    if use_mesh:
        # local device mesh: target shards within this host
        from .pipeline import ShardedAlignmentEngine, sharded_prefilter
        from .sw_sharded import make_mesh
        mesh = make_mesh(jax.local_devices())
        shards = residue_balanced_splits(db.lengths,
                                         n_shards or mesh.devices.size)
        hits = sharded_prefilter(
            db, db, shards, sensitivity=par.sensitivity,
            max_seqs=par.max_seqs,
            comp_bias_correction=par.comp_bias_correction, mask=par.mask,
            cov_thr=par.cov_thr, cov_mode=par.cov_mode, same_qt_db=True,
            qrange=(s, e))
        cands = {qk: [h.seq_id for h in hits[qk]] for qk in qslice}
        eng = ShardedAlignmentEngine(db, db, apar, mesh, shards,
                                     same_qt_db=True)
        records = eng.align_all(cands)
    else:
        from ..search.alignment import AlignmentEngine
        from ..search.prefilter import PrefilterEngine
        pref = PrefilterEngine(db, db, sensitivity=par.sensitivity,
                               max_seqs=par.max_seqs, same_qt_db=True,
                               comp_bias_correction=par.comp_bias_correction,
                               mask=par.mask, cov_thr=par.cov_thr,
                               cov_mode=par.cov_mode)
        hits = pref.match_all(qslice)
        cands = {qk: [h.seq_id for h in hs] for qk, hs in hits.items()}
        eng = AlignmentEngine(db, db, apar, same_qt_db=True)
        records = eng.align_all(cands)

    # shared-fs rendezvous: per-rank reference-format result DB
    write_flatdb(tmp / f"result.{proc_id}",
                 [(qk, "".join(r.line() + "\n"
                               for r in records.get(qk, [])))
                  for qk in qslice])
    _barrier(tmp, proc_id, n_procs, "search")

    if proc_id != 0:
        return

    # ---- rank 0: merge + aggregation tail (MMseqsMPI master merge) ----
    from ..cluster.aggregate import (besthit_by_set, combine_hits,
                                     merge_results_by_set)
    from ..cluster.clusterhits import cluster_hits
    from ..cluster.summarize import seq_to_clu, summarize_results

    results = load_results(tmp, n_procs)
    agg = besthit_by_set(results, db, simple_best_hit=par.simple_best_hit,
                         subopt_hits_factor=par.subopt_hits_factor)
    merged = merge_results_by_set(agg, db)
    matches = combine_hits(merged, db, db, alpha=par.alpha,
                           aggregation_mode=par.aggregation_mode,
                           filter_self_match=par.filter_self_match)
    clusters = cluster_hits(matches, db, db,
                            max_gene_gaps=par.max_gene_gaps,
                            cluster_size=par.cluster_size,
                            p_clu_thr=par.p_clu_thr,
                            p_mh_thr=par.p_mh_thr, alpha=par.alpha)
    tsv = summarize_results(clusters, db, db)
    Path(out_path).write_text(tsv)
    (Path(out_path).parent / (Path(out_path).name + ".seq_to_clu.tsv")
     ).write_text("".join(f"{k}\t{v}\n"
                          for k, v in seq_to_clu(clusters).items()))


def worker_env(base: dict, rank: int, n_procs: int, local_devices: int,
               coordinator_port: int) -> dict:
    """Environment of one worker.  With JAX_PLATFORMS=cpu the worker gets
    `local_devices` virtual CPU devices; otherwise it gets its own
    `local_devices` GPUs through CUDA_VISIBLE_DEVICES, taken in order
    from the parent's visible set (all cards when that is unset)."""
    env = dict(base)
    env["SPACEDUST_NUM_PROCS"] = str(n_procs)
    env["SPACEDUST_PROC_ID"] = str(rank)
    env["SPACEDUST_COORDINATOR"] = f"127.0.0.1:{coordinator_port}"
    if env.get("JAX_PLATFORMS") == "cpu":
        flags = env.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            env["XLA_FLAGS"] = (flags + " --xla_force_host_platform_"
                                f"device_count={local_devices}").strip()
        return env
    visible = base.get("CUDA_VISIBLE_DEVICES")
    cards = (visible.split(",") if visible
             else [str(i) for i in range(n_procs * local_devices)])
    mine = cards[rank * local_devices:(rank + 1) * local_devices]
    if len(mine) < local_devices:
        raise RuntimeError(f"{n_procs} workers x {local_devices} cards "
                           f"need more than the {len(cards)} visible")
    env["CUDA_VISIBLE_DEVICES"] = ",".join(mine)
    return env


def load_results(tmp: Path, n_procs: int) -> dict[int, list[list[str]]]:
    """Every rank's result records as the prefixed column lists the
    aggregation tail reads.  The stored columns are used verbatim:
    parsing a record and formatting it again is not the identity (the
    reference's seq-id formatting maps "0.511" to "0.510"), so only the
    original strings reproduce the single-process TSV."""
    from ..db.mmseqs_io import FlatDB
    results: dict[int, list[list[str]]] = {}
    for r in range(n_procs):
        fdb = FlatDB.open(tmp / f"result.{r}")
        for qk in fdb.keys():
            results[qk] = [[str(qk)] + ln.split("\t")
                           for ln in fdb.lines(qk)]
    return results


def run_multihost(db_path: str, out_path: str, n_procs: int,
                  params, tmp_dir: str | None = None,
                  local_devices: int = 1,
                  coordinator_port: int = 0) -> str:
    """Spawn n_procs local worker processes (the mpirun stand-in) over a
    shared artifact dir and wait for rank 0's merged TSV.  The parent
    opens no device.  Returns the output path."""
    import socket
    import tempfile
    tmp_dir = tmp_dir or tempfile.mkdtemp(prefix="spacedust_mh")
    Path(tmp_dir).mkdir(parents=True, exist_ok=True)
    if coordinator_port == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coordinator_port = s.getsockname()[1]
    pj = json.dumps(asdict(params))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "spacedust_tpu.parallel.multihost",
         db_path, tmp_dir, out_path, pj],
        env=worker_env(os.environ, r, n_procs, local_devices,
                       coordinator_port))
        for r in range(n_procs)]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise RuntimeError(f"multihost workers failed: rcs={rcs}")
    return out_path


def main() -> None:
    db_path, tmp_dir, out_path, params_json = sys.argv[1:5]
    worker(db_path, tmp_dir, out_path, params_json)


if __name__ == "__main__":
    main()
