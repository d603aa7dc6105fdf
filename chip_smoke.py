#!/usr/bin/env python3
"""Bring-up check of spacedust_tpu on an NVIDIA GPU.

Drives the main path on the card, one process, exiting non-zero at the
first failure:

  1. device check: JAX must report a GPU (no CPU fallback); prints the
     card's name and power limit from nvidia-smi;
  2. kernel check: for every (rung, direction) the 12-genome workload
     uses, the CUDA Smith-Waterman kernel at that rung's batch width on
     pairs from the generated database (with diverged, gapped homologs)
     plus random pairs.  Every output of every pair must equal the plain
     reference scan (ops/sw_tiled.sw_scan_core) compiled by XLA for the
     same card, and the first pairs of each batch must equal it run on
     the CPU device.  Prints each new executable's memory analysis and
     the kernel's and XLA's times;
  3. full run: createsetdb -> SetDB save/load -> cluster_search with
     --filter-self-match on the 12-genome workload (~31.9k genes);
     prints hit and cluster counts and the stage times, with
     compilation shown as set-up;
  4. path equality: the 2-genome instance on the card, and the same
     instance through the CLI in a child process with JAX_PLATFORMS=cpu
     that never opens the card; the two cluster TSVs must be
     byte-identical.

With `--cards 4` it runs only the four-card check: run_multihost with
2 processes x 2 cards (before this process opens any card), then
sharded_cluster_search over a 4-GPU mesh, both compared byte for byte
with the single-card TSV of the 12-genome workload.

The last line of standard output is the JSON result
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import shlex
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import spacedust_tpu  # noqa: E402,F401  (fails at once outside the repo)

SEED = 42


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_lines() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=120)
    if r.returncode:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def device_check(count: int):
    """Phase 1: the card, as JAX and nvidia-smi report it."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devs[0].platform})")
    if len(devs) < count:
        fail(f"{count} GPUs needed, JAX found {len(devs)}")
    log(f"[1] device: {devs[0].platform} {devs[0].device_kind} "
        f"x{len(devs)}; jax {jax.__version__}")
    log(f"[1] card: {card_lines()}")
    return devs


def tsv_counts(tsv: str) -> tuple[int, int]:
    lines = tsv.splitlines()
    return (sum(1 for ln in lines if ln.startswith(">")),
            sum(1 for ln in lines if ln.startswith("#")))


def make_db(work: Path, name: str, **shape):
    from spacedust_tpu.db import synth
    from spacedust_tpu.db.setdb import SetDB
    t0 = time.perf_counter()
    db = synth.make_setdb(work / f"{name}_faa", SEED, **shape)
    db.save(work / f"{name}_db")
    db = SetDB.load(work / f"{name}_db")
    log(f"[setup] {name}: {db.num_sets} genomes, {db.size} genes, "
        f"{int(db.lengths.sum())} residues, generated and ingested in "
        f"{time.perf_counter() - t0:.2f}s")
    return db


# --------------------------------------------------------------------------
# phase 2


def _homolog(seq, rng, cum, back):
    """A diverged copy: 25% BLOSUM62-conditional substitutions and short
    indels about every 40 residues."""
    import numpy as np
    from spacedust_tpu.db.synth import mutate
    out = mutate(seq, 0.25, rng, cum)
    parts, i = [], 0
    while i < len(out):
        step = int(rng.geometric(1 / 40))
        parts.append(out[i:i + step])
        i += step
        n = int(rng.integers(1, 6))
        if rng.random() < 0.5:
            parts.append(rng.choice(20, size=n, p=back).astype(np.uint8))
        else:
            i += n
    return np.concatenate(parts) if parts else out


def _rung_pairs(db, r: int, prev: int, B: int, rng, cum, back):
    """B (query, target) residue-index pairs whose longer side falls in
    (prev, r]: DB genes against diverged homologs, DB gene pairs, and
    random sequences."""
    import numpy as np
    lens = db.lengths
    seqs = [db.sequence(k) for k in range(db.size)]
    inr = np.nonzero((lens > prev) & (lens <= r))[0]
    fits = np.nonzero(lens <= r)[0]

    def rand_seq(lo, hi):
        return rng.choice(20, size=int(rng.integers(lo, hi + 1)),
                          p=back).astype(np.uint8)

    def long_side():
        if len(inr) and rng.random() < 0.9:
            return seqs[int(rng.choice(inr))]
        return rand_seq(prev + 1, r)

    pairs = []
    for i in range(B):
        kind = i % 4
        if kind < 2:
            a = long_side()
            b = _homolog(a, rng, cum, back)[:r]
            if len(b) == 0:
                b = a
        elif kind == 2:
            a, b = long_side(), seqs[int(rng.choice(fits))]
        else:
            a, b = rand_seq(prev + 1, r), rand_seq(1, r)
        pairs.append((a, b) if rng.random() < 0.5 else (b, a))
    return pairs


def _resident(pairs, sub, p_back):
    """Concatenated int8 query/bias/target arrays and (6, B) params."""
    import numpy as np
    from spacedust_tpu.native import comp_bias_batch
    q = [p[0] for p in pairs]
    t = [p[1] for p in pairs]
    ql = np.array([len(s) for s in q], np.int32)
    tl = np.array([len(s) for s in t], np.int32)
    qo = np.concatenate(([0], np.cumsum(ql)))
    to = np.concatenate(([0], np.cumsum(tl)))
    qdata = np.concatenate(q).astype(np.uint8)
    tdata = np.concatenate(t).astype(np.uint8)
    qbias = comp_bias_batch(qdata, qo[:-1].astype(np.int64), ql,
                            np.ascontiguousarray(sub, dtype=np.int32),
                            np.ascontiguousarray(p_back, dtype=np.float64))
    params = np.zeros((6, len(pairs)), np.int32)
    params[0], params[1], params[2], params[3] = qo[:-1], ql, to[:-1], tl
    params[4] = -1
    cells = int((ql.astype(np.int64) * tl).sum())
    return (qdata.astype(np.int8), qbias.astype(np.int8),
            tdata.astype(np.int8)), params, cells


def xla_width(B: int, r: int) -> int:
    """Widest batch the XLA reference scan gets at rung r: it holds a
    B x r x 128 int32 score tile, kept here at 2^29 elements (a power of
    two, so it divides every batch width)."""
    return min(B, 1 << ((1 << 22) // r).bit_length() - 1)


def _timed(fn):
    import numpy as np
    t0 = time.perf_counter()
    out = [np.asarray(x) for x in fn()]
    return out, time.perf_counter() - t0


def kernel_check(db) -> None:
    """Phase 2."""
    import jax
    import numpy as np
    from spacedust_tpu.db.synth import _tables
    from spacedust_tpu.ops import sw_engine as se
    from spacedust_tpu.stats.submat import load_substitution_matrix

    m = load_substitution_matrix()
    back, cum = _tables()
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    fwd = sorted({se.bucket_len(int(x)) for x in db.lengths})
    rev = [r for r in se.LADDER if r <= fwd[-1]]
    rng = np.random.default_rng([SEED, 2])
    fwd_scores = {}
    for r in sorted(set(fwd) | set(rev)):
        prev = max([x for x in se.LADDER if x < r], default=0)
        B = se.batch_width(r, r)
        pairs = _rung_pairs(db, r, prev, B, rng, cum, back)
        arrays, params, cells = _resident(pairs, m.sub_int, m.p_back)
        dev = [jax.device_put(a, gpu) for a in arrays]
        sub = jax.device_put(m.sub_int.astype(np.int32), gpu)
        n_cpu = min(B, max(8, int(4e7 // (r * r))))
        for reverse in (False, True):
            if reverse and r not in rev or not reverse and r not in fwd:
                continue
            tag = f"{r}{'r' if reverse else 'f'}"
            p = params.copy()
            if reverse:
                # terminate = the forward score, as the search sets it
                if r not in fwd_scores:
                    fwd_scores[r] = np.asarray(se._sw_bucket(
                        *dev, sub, jax.device_put(params, gpu), Lq=r, Lt=r,
                        gap_open=11, gap_extend=1, reverse=False,
                        kernel="cuda")[0])
                p[4] = fwd_scores[r]
            pg = jax.device_put(p, gpu)
            kw = dict(Lq=r, Lt=r, gap_open=11, gap_extend=1,
                      reverse=reverse)
            exe = se._sw_bucket.lower(*dev, sub, pg, kernel="cuda",
                                      **kw).compile()
            mem = exe.memory_analysis()
            log(f"[2] {tag} memory: args={mem.argument_size_in_bytes} "
                f"out={mem.output_size_in_bytes} "
                f"temp={mem.temp_size_in_bytes}")
            got, t_c0 = _timed(lambda: exe(*dev, sub, pg))
            got, t_c = _timed(lambda: exe(*dev, sub, pg))
            # the XLA scan runs in chunks (xla_width); its outputs are
            # per pair, so chunking changes no value
            step = xla_width(B, r)
            parts = [jax.device_put(p[:, s:s + step], gpu)
                     for s in range(0, B, step)]

            def xla_ref():
                outs = [se._sw_bucket(*dev, sub, c, kernel="xla", **kw)
                        for c in parts]
                return [np.concatenate([np.asarray(o[i]) for o in outs])
                        for i in range(6)]

            ref, t_x0 = _timed(xla_ref)
            ref, t_x = _timed(xla_ref)
            eq = int(np.all([g == x.astype(np.int32)
                             for g, x in zip(got, ref)], axis=0).sum())
            small = [jax.device_put(a, cpu) for a in arrays]
            cref = [np.asarray(x) for x in se._sw_bucket(
                *small, jax.device_put(m.sub_int.astype(np.int32), cpu),
                jax.device_put(p[:, :n_cpu], cpu), kernel="xla", **kw)]
            eq_cpu = int(np.all([g[:n_cpu] == x.astype(np.int32)
                                 for g, x in zip(got, cref)], axis=0).sum())
            found = int(got[3].sum())
            log(f"[2] {tag} B={B} (XLA in chunks of {step}): equal to "
                f"XLA-on-GPU {eq}/{B}, equal to "
                f"CPU {eq_cpu}/{n_cpu}; found={found}; cuda "
                f"{t_c * 1e3:.3f} ms ({cells / t_c / 1e9:.1f} GCUPS of "
                f"{cells} real cells), xla {t_x * 1e3:.3f} ms "
                f"({B * r * r / t_x / 1e9:.1f} GCUPS of {B * r * r} padded "
                f"cells); first calls {t_c0:.2f}s / {t_x0:.2f}s")
            if eq != B or eq_cpu != n_cpu:
                bad = np.nonzero(~np.all([g == x.astype(np.int32) for g, x
                                          in zip(got, ref)], axis=0))[0][:5]
                for b in bad:
                    log(f"    pair {b}: qlen={p[1, b]} tlen={p[3, b]} "
                        f"cuda={[int(g[b]) for g in got]} "
                        f"xla={[int(x[b]) for x in ref]}")
                fail(f"kernel {tag} differs from the reference")
            if not reverse:
                fwd_scores[r] = got[0]


# --------------------------------------------------------------------------
# phases 3-5


def full_run(db):
    """Phase 3."""
    from spacedust_tpu.workflow.clustersearch import (ClusterSearchParams,
                                                      cluster_search)
    t0 = time.perf_counter()
    res = cluster_search(db, db, ClusterSearchParams(filter_self_match=True))
    wall = time.perf_counter() - t0
    hits, clusters = tsv_counts(res.tsv)
    detail = res.timings.get("align_detail", {})
    log(f"[3] 12-genome run: {hits} hits, {clusters} clusters "
        f"({len(res.clusters)} cluster records) in {wall:.2f}s")
    log("[3] timings: " + json.dumps(
        {k: v for k, v in res.timings.items() if k != "align_detail"}))
    log("[3] align_detail: " + json.dumps(detail))
    log(f"[3] set-up: compile {detail.get('compile_s', 0.0):.2f}s over "
        f"{detail.get('n_executables', 0)} executables (background, "
        "overlapping the prefilter)")
    if hits == 0 or clusters == 0:
        fail("the 12-genome run found no hits or no clusters")
    return res


def path_equality(work: Path) -> None:
    """Phase 4."""
    import os
    from spacedust_tpu.db import synth
    from spacedust_tpu.workflow.clustersearch import (ClusterSearchParams,
                                                      cluster_search)
    faa = synth.write_genomes(work / "small_faa", SEED, **synth.SMALL)
    cpu_db, cpu_tsv = work / "small_cpu_db", work / "small_cpu.tsv"
    py = shlex.quote(sys.executable)
    cmd = (f"{py} -m spacedust_tpu createsetdb "
           f"{' '.join(shlex.quote(p) for p in faa)} {shlex.quote(str(cpu_db))}"
           f" && {py} -m spacedust_tpu clustersearch {shlex.quote(str(cpu_db))}"
           f" {shlex.quote(str(cpu_db))} {shlex.quote(str(cpu_tsv))} "
           f"{shlex.quote(str(work / 'small_cpu_tmp'))} --filter-self-match")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    child = subprocess.Popen(["sh", "-c", cmd], env=env, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
    t0 = time.perf_counter()
    db = make_db(work, "small", **synth.SMALL)
    res = cluster_search(db, db, ClusterSearchParams(filter_self_match=True))
    t_gpu = time.perf_counter() - t0
    out, _ = child.communicate(timeout=900)
    t_cpu = time.perf_counter() - t0
    if child.returncode:
        log(out[-3000:])
        fail(f"CPU child failed with rc {child.returncode}")
    want = cpu_tsv.read_bytes()
    hits, clusters = tsv_counts(res.tsv)
    same = res.tsv.encode() == want
    log(f"[4] 2-genome instance: GPU {hits} hits / {clusters} clusters in "
        f"{t_gpu:.2f}s; CPU child {len(want)} bytes in {t_cpu:.2f}s; "
        f"TSV byte-identical: {same}")
    if not same or hits == 0:
        fail("the GPU and CPU cluster TSVs differ")


def four_cards(work: Path) -> int:
    """Phase 5: multihost (2 x 2 cards) and the 4-card sharded search
    against the single-card TSV."""
    from spacedust_tpu.parallel.multihost import run_multihost
    from spacedust_tpu.workflow.clustersearch import ClusterSearchParams
    par = ClusterSearchParams(filter_self_match=True)
    db = make_db(work, "full")
    t0 = time.perf_counter()
    # no card is open in this process yet: the workers own all four
    mh = Path(run_multihost(str(work / "full_db"), str(work / "mh.tsv"), 2,
                            par, tmp_dir=str(work / "mh_tmp"),
                            local_devices=2)).read_text()
    log(f"[5] multihost 2 procs x 2 cards: {tsv_counts(mh)} (hits, "
        f"clusters) in {time.perf_counter() - t0:.2f}s")
    import jax
    from spacedust_tpu.parallel.pipeline import sharded_cluster_search
    from spacedust_tpu.parallel.sw_sharded import make_mesh
    from spacedust_tpu.workflow.clustersearch import cluster_search
    devs = device_check(4)
    t0 = time.perf_counter()
    sharded = sharded_cluster_search(db, db, par,
                                     mesh=make_mesh(jax.devices()[:4]))
    log(f"[5] sharded over 4 cards: {tsv_counts(sharded.tsv)} in "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    single = cluster_search(db, db, par)
    log(f"[5] single card: {tsv_counts(single.tsv)} in "
        f"{time.perf_counter() - t0:.2f}s")
    log(f"[5] sharded TSV == single-card TSV: {sharded.tsv == single.tsv}; "
        f"multihost TSV == single-card TSV: {mh == single.tsv}")
    if sharded.tsv != single.tsv or mh != single.tsv:
        fail("a multi-card TSV differs from the single-card TSV")
    return len(devs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    a = ap.parse_args()
    work = REPO / ".tmp" / f"chip_smoke_{int(time.time())}"
    work.mkdir(parents=True)
    try:
        if a.cards == 4:
            count = four_cards(work)
        else:
            count = len(device_check(1))
            db = make_db(work, "full")
            kernel_check(db)
            full_run(db)
            path_equality(work)
        import jax
        d = jax.devices()[0]
        print(json.dumps({"ok": True, "device": {
            "platform": d.platform, "kind": d.device_kind,
            "count": count}}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
