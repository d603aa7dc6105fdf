"""Time the GPU Smith-Waterman paths against each other on the card.

  * super-batching: for each forward rung of the 12-genome workload, K
    chunks of 1/K of the engine's batch width dispatched as K executions
    ("K=1"), the same K chunks inside one execution (lax.map over the
    chunks, the removed super-batch dispatch), and one execution of the
    whole width ("wide", what the engine does), with K the super-batch
    counts the engine used to carry;
  * the align stage: the 12-genome cluster_search with the CUDA kernel
    and with the XLA reference scan as the engine's scan (at batch widths
    capped by chip_smoke.xla_width), in turns (cuda, xla, cuda), checking
    that the TSVs are identical.

Prints one line per measurement and the card's name and power limit.
Usage (GPU host): python tools/sw_timing.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# the per-rung chunk counts of the removed super-batch dispatch
OLD_SUPER_K = {256: 16, 384: 8, 512: 8, 768: 8, 1024: 8, 1536: 8, 2048: 8,
               3072: 4, 4096: 8}


def log(msg: str) -> None:
    print(msg, flush=True)


def super_batching(db) -> None:
    import jax
    import numpy as np
    import chip_smoke as cs
    from spacedust_tpu.db.synth import _tables
    from spacedust_tpu.ops import sw_engine as se
    from spacedust_tpu.stats.submat import load_substitution_matrix

    m = load_substitution_matrix()
    back, cum = _tables()
    gpu = jax.devices()[0]
    rng = np.random.default_rng([cs.SEED, 3])
    fwd = sorted({se.bucket_len(int(x)) for x in db.lengths})
    for r in fwd:
        K = OLD_SUPER_K[r]
        prev = max([x for x in se.LADDER if x < r], default=0)
        B = se.batch_width(r, r) // K
        pairs = cs._rung_pairs(db, r, prev, B, rng, cum, back)
        arrays, params, cells = cs._resident(pairs, m.sub_int, m.p_back)
        dev = [jax.device_put(a, gpu) for a in arrays]
        sub = jax.device_put(m.sub_int.astype(np.int32), gpu)
        chunks = [jax.device_put(params, gpu) for _ in range(K)]
        stacked = jax.device_put(np.stack([params] * K), gpu)
        wide_arrays, wide_params, _ = cs._resident(pairs * K, m.sub_int,
                                                   m.p_back)
        wdev = [jax.device_put(a, gpu) for a in wide_arrays]
        wparams = jax.device_put(wide_params, gpu)
        kw = dict(Lq=r, Lt=r, gap_open=11, gap_extend=1, reverse=False,
                  kernel="cuda")

        @jax.jit
        def mapped(qd, qb, td, sb, ps):
            return jax.lax.map(lambda p: se.bucket_sw(qd, qb, td, sb, p,
                                                      **kw), ps)

        def separate():
            outs = [se._sw_bucket(*dev, sub, p, **kw) for p in chunks]
            return np.asarray(se._concat_results(outs))

        def together():
            return np.asarray(mapped(*dev, sub, stacked)[0])

        def wide():
            return np.asarray(se._sw_bucket(*wdev, sub, wparams, **kw)[0])

        runs = {"K=1": separate, f"K={K}": together, "wide": wide}
        for fn in runs.values():
            fn()
        times = {name: [] for name in runs}
        for name in (*runs, *reversed(runs)):
            t0 = time.perf_counter()
            runs[name]()
            times[name].append(time.perf_counter() - t0)
        log(f"[super] rung {r}: {K} chunks x {B} pairs ({K * cells} real "
            "cells): " + ", ".join(
                f"{name} {min(ts) * 1e3:.3f} ms "
                f"{[round(t * 1e3, 3) for t in ts]}"
                for name, ts in times.items()))


def align_stage(db) -> None:
    from spacedust_tpu.ops import sw_engine as se
    from spacedust_tpu.workflow.clustersearch import (ClusterSearchParams,
                                                      cluster_search)
    import chip_smoke as cs
    par = ClusterSearchParams(filter_self_match=True)
    cuda_select, cuda_width = se.select_kernel, se.batch_width
    tsvs = {}
    for kernel in ("cuda", "xla", "cuda"):
        if kernel == "xla":
            se.select_kernel = lambda: "xla"
            se.batch_width = lambda lq, lt: cs.xla_width(
                cuda_width(lq, lt), max(lq, lt))
        else:
            se.select_kernel, se.batch_width = cuda_select, cuda_width
        t0 = time.perf_counter()
        res = cluster_search(db, db, par)
        wall = time.perf_counter() - t0
        d = res.timings.get("align_detail", {})
        log(f"[align] {kernel}: align {res.timings['align']:.3f}s, "
            f"prefilter (exposed) {res.timings['prefilter']:.3f}s, "
            f"aggregate {res.timings['aggregate']:.3f}s, wall {wall:.3f}s; "
            f"compile {d.get('compile_s', 0):.3f}s over "
            f"{d.get('n_executables', 0)} executables, dispatch "
            f"{d.get('dispatch_s', 0):.3f}s, fetch {d.get('fetch_s', 0):.3f}s, "
            f"{d.get('n_batches', 0)} batches")
        tsvs.setdefault(kernel, res.tsv)
    se.select_kernel, se.batch_width = cuda_select, cuda_width
    log(f"[align] TSV with the XLA scan == TSV with the CUDA kernel: "
        f"{tsvs['xla'] == tsvs['cuda']}")


def main() -> None:
    import chip_smoke as cs
    cs.device_check(1)
    work = REPO / ".tmp" / f"sw_timing_{int(time.time())}"
    work.mkdir(parents=True)
    try:
        db = cs.make_db(work, "full")
        super_batching(db)
        align_stage(db)
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
