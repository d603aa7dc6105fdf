"""Batched Smith-Waterman engine: device-resident databases, one compiled
bucket per (rung, direction).

The engine keeps the query tokens, their composition-bias column and the
target tokens resident on the device as flat int8 arrays, and a batch of
pairs moves as one (6, B) int32 params array of token offsets and
lengths.  A bucket runs one of two scans, chosen by `select_kernel`:

  * "cuda" on a GPU: the Hopper kernel of ops/sw_cuda.py, which reads
    the resident arrays at the pairs' offsets itself and keeps the DP
    state on chip;
  * "xla" on the CPU backend: an XLA gather of the (B, Lq) and (B, Lt)
    panels, the profile sub[q] + bias, and ops/sw_tiled.sw_scan_core,
    the plain reference.

Both return the same six int32 outputs bit for bit (the reference
striped SW score pass, lib/mmseqs/src/alignment/StripedSmithWaterman.cpp:
354-461).  Length buckets use a fixed ladder with per-rung batch widths,
so the number of compiled shapes is bounded and the persistent
compilation cache (utils/jaxconf.py) amortizes them across processes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxconf import configure_jax
from .sw_tiled import sw_scan_core

configure_jax()

LADDER = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 32768)
# GPU batch widths.  One warp per pair and ~24 resident warps per SM put
# ~3,200 pairs in flight on 132 SMs, and an execution costs ~0.6 ms
# beyond its kernel on an H100, so each width is sized for ~10 ms of
# kernel time per launch (tail pads, qlen = tlen = 1, cost the kernel
# almost nothing).  One wide launch does what a lax.map over several
# narrower chunks in one execution would, without serialising them.
_BATCH_FOR_RUNG = {256: 32768, 384: 32768, 512: 32768, 768: 16384,
                   1024: 8192, 1536: 4096, 2048: 4096, 3072: 1024,
                   4096: 1024, 32768: 64}

DEVICE_MAX_LEN = LADDER[-1]


def select_kernel() -> str:
    """The hand-written kernel on a GPU, the XLA scan on the CPU."""
    return "cuda" if jax.default_backend() == "gpu" else "xla"


def device_max_len() -> int:
    """Longest pair dimension the device path accepts; longer pairs
    route to the unbounded host path.  On the CPU backend (tests with
    SPACEDUST_FORCE_DEVICE_ALIGN) the big rungs are ruinously slow —
    one 32768-rung batch is ~34 Gcells of scalar scan work — so
    eligibility stops at 4096 there."""
    if jax.default_backend() == "cpu":
        return 4096
    return DEVICE_MAX_LEN


def bucket_len(x: int) -> int:
    """Square rung: one executable per (rung, direction).  The ladder is
    small so that a run compiles few shapes; the intermediate rungs
    (768/1536/3072) halve the row padding of the dominant mid-length
    pairs on the XLA path, and warm() only compiles the rungs the DB's
    length histogram maps to.

    Lengths above the ladder top RAISE: the resident-array gather clamps
    indices, so letting an over-long pair through would silently truncate
    the alignment — callers must route such pairs to the unbounded host
    path (reference contract --max-seq-len 65535, QueryMatcher.h:36, with
    no silent cap)."""
    for n in LADDER:
        if x <= n:
            return n
    raise ValueError(
        f"sequence length {x} exceeds the device SW ladder top "
        f"{DEVICE_MAX_LEN}; route this pair to the host path")


def batch_width(lq: int, lt: int) -> int:
    """Per-rung batch width.  On the CPU backend (tests forcing the
    device path via SPACEDUST_FORCE_DEVICE_ALIGN) the GPU widths would
    pad tiny test batches 100-1000x, so a small width is used there."""
    if jax.default_backend() == "cpu":
        return 32
    return _BATCH_FOR_RUNG[max(lq, lt)]


def bucket_sw(qdata, qbias, tdata, sub, params, *, Lq: int, Lt: int,
              gap_open: int, gap_extend: int, reverse: bool, kernel: str):
    """One bucket's scan, unjitted so the sharded engine can wrap it.
    qdata/qbias/tdata: resident int8 arrays; sub: (A, A) int32; params:
    (6, B) int32 rows = qoff, qlen, toff, tlen, terminate, unused, with
    offsets in tokens.  Reverse batches read each pair's prefixes
    [0, qlen) x [0, tlen) backwards.  Returns (score, gj, gi, found, fj,
    fi): forward batches use (score, gj, gi) = (score, t_end, q_end);
    reverse batches read (found, fj, fi), the terminate-column break in
    reversed coordinates."""
    if kernel == "cuda":
        from .sw_cuda import sw_scan_gpu
        return sw_scan_gpu(qdata, qbias, tdata, sub, params, Lq=Lq, Lt=Lt,
                           gap_open=gap_open, gap_extend=gap_extend,
                           reverse=reverse)
    if kernel != "xla":
        raise ValueError(f"unknown SW kernel {kernel!r}")
    qoff, qlen, toff, tlen, terminate = (params[i] for i in range(5))
    iq = np.arange(Lq, dtype=np.int32)
    it = np.arange(Lt, dtype=np.int32)
    if reverse:
        qsel = jnp.maximum(qlen[:, None] - 1 - iq[None, :], 0)
        tsel = jnp.maximum(tlen[:, None] - 1 - it[None, :], 0)
    else:
        qsel = jnp.minimum(iq[None, :], qlen[:, None] - 1)
        tsel = jnp.minimum(it[None, :], tlen[:, None] - 1)
    q_idx = qoff[:, None] + qsel
    t_idx = toff[:, None] + tsel
    qt = qdata[q_idx].astype(jnp.int32)            # (B, Lq) tokens
    qb = qbias[q_idx].astype(jnp.int32)            # (B, Lq) bias
    tt = tdata[t_idx].astype(jnp.int32)            # (B, Lt) tokens
    # prof[b, a, i] = sub[q_bi, a] + bias_bi
    prof = jnp.transpose(sub[qt] + qb[:, :, None], (0, 2, 1))
    return sw_scan_core(prof, tt, qlen, tlen, gap_open, gap_extend,
                        terminate, t_tile=min(128, Lt),
                        with_terminate=True, all_outputs=True)


_sw_bucket = jax.jit(bucket_sw, static_argnames=(
    "Lq", "Lt", "gap_open", "gap_extend", "reverse", "kernel"))


def _concat_results(rs):
    """Stack per-batch output tuples into one (n_out, total) device array
    so a whole stage is fetched with a single transfer."""
    return jnp.concatenate(
        [jnp.stack([x.astype(jnp.int32) for x in r]) for r in rs], axis=1)


def _pow2_pad(a: np.ndarray) -> np.ndarray:
    """Pad a 1-D array to the next power of two: the resident-array shape
    is baked into every compiled executable, so padding keeps executable
    shapes stable across runs and similarly-sized DBs (persistent-cache
    hits instead of fresh compiles)."""
    n = 1
    while n < len(a):
        n *= 2
    if n == len(a):
        return a
    return np.pad(a, (0, n - len(a)))


class DeviceAlignDB:
    """Device-resident query/target token + bias arrays for one engine.

    Executables are AOT-compiled (jit.lower().compile()) and cached per
    (Lq, Lt, gaps, direction) so `warm()` can build them on a background
    thread while the host runs the prefilter."""

    def __init__(self, qdata: np.ndarray, qbias: np.ndarray,
                 tdata: np.ndarray, sub: np.ndarray,
                 q_offsets: np.ndarray | None = None,
                 t_offsets: np.ndarray | None = None):
        if q_offsets is None:
            q_offsets = np.array([0, len(qdata)], dtype=np.int64)
        if t_offsets is None:
            t_offsets = np.array([0, len(tdata)], dtype=np.int64)
        self.kernel = select_kernel()
        # per-sequence token offsets (what jobs carry)
        self.q_offs = np.asarray(q_offsets[:-1], dtype=np.int32)
        self.t_offs = np.asarray(t_offsets[:-1], dtype=np.int32)
        self.qdata = jnp.asarray(_pow2_pad(qdata.astype(np.int8)))
        self.qbias = jnp.asarray(_pow2_pad(qbias.astype(np.int8)))
        self.tdata = jnp.asarray(_pow2_pad(tdata.astype(np.int8)))
        self.sub = jnp.asarray(sub.astype(np.int32))
        self._init_state()

    def _init_state(self) -> None:
        import threading
        self._compiled = {}
        self._inflight = {}
        self._buf = {}
        self._lock = threading.Lock()
        self.metrics = {"compile_s": 0.0, "dispatch_s": 0.0, "fetch_s": 0.0,
                        "n_executables": 0, "n_batches": 0}

    def _resident(self):
        return (self.qdata, self.qbias, self.tdata, self.sub)

    def _call(self, params, lq: int, lt: int, gap_open: int,
              gap_extend: int, reverse: bool = False):
        return _sw_bucket(*self._resident(), params,
                          Lq=lq, Lt=lt, gap_open=gap_open,
                          gap_extend=gap_extend, reverse=reverse,
                          kernel=self.kernel)

    def _lower_compile(self, params, lq: int, lt: int, gap_open: int,
                       gap_extend: int, reverse: bool) -> None:
        _sw_bucket.lower(*self._resident(), params,
                         Lq=lq, Lt=lt, gap_open=gap_open,
                         gap_extend=gap_extend, reverse=reverse,
                         kernel=self.kernel).compile()

    @staticmethod
    def _pad_params(B: int, reverse: bool) -> np.ndarray:
        """A (6, B) params array of tail pads: qlen = tlen = 1 pairs with
        no terminate score."""
        params = np.zeros((6, B), dtype=np.int32)
        params[1] = params[3] = 1
        params[4] = -1
        params[5] = 1 if reverse else 0
        return params

    def ensure_warm(self, lq: int, lt: int, gap_open: int,
                    gap_extend: int, reverse: bool = False) -> None:
        """First-use compile of one bucket shape via AOT
        lower().compile(), which fills the same executable cache the jit
        call path reads without executing anything.  Concurrent warms of
        different shapes are allowed; a per-key in-flight event makes
        late callers WAIT for the owning thread instead of duplicating
        the compile."""
        import threading
        import time
        key = (lq, lt, gap_open, gap_extend, reverse)
        with self._lock:
            if key in self._compiled:
                return
            ev = self._inflight.get(key)
            if ev is None:
                ev = threading.Event()
                self._inflight[key] = ev
                owner = True
            else:
                owner = False
        if not owner:
            ev.wait()
            return
        try:
            t0 = time.perf_counter()
            params = self._pad_params(batch_width(lq, lt), reverse)
            self._lower_compile(jnp.asarray(params), lq, lt, gap_open,
                                gap_extend, reverse)
            dt = time.perf_counter() - t0
            with self._lock:
                self._compiled[key] = True
                self.metrics["compile_s"] += dt
                self.metrics["n_executables"] += 1
        finally:
            ev.set()
            with self._lock:
                self._inflight.pop(key, None)

    def warm(self, rungs, gap_open: int, gap_extend: int,
             ladder=LADDER) -> None:
        """AOT-compile the bucket shapes (call from a background thread at
        pipeline start).  Forward batches use exactly the rungs the DB's
        lengths map to; a reverse batch covers the prefixes up to the
        forward end points, which can fall into any smaller rung of the
        engine's ladder, so the reverse set is every ladder rung up to
        the largest forward one."""
        from concurrent.futures import ThreadPoolExecutor
        rungs = sorted(rungs)
        if not rungs:
            return
        rev = [r for r in ladder if r <= rungs[-1]]
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(lambda lq: self.ensure_warm(lq, lq, gap_open,
                                                      gap_extend), rungs))
        # reverse executables compile after the forward set is hot (the
        # forward pass dominates and dispatches first)
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(lambda lq: self.ensure_warm(lq, lq, gap_open,
                                                      gap_extend, True),
                          rev))

    def enqueue(self, jobs, gap_open: int, gap_extend: int,
                reverse: bool):
        """Append jobs (list of (bucket_key, qoff, qlen, toff, tlen,
        term, positions)) to per-rung buffers and asynchronously dispatch
        every FULL batch (batch_width pairs) as one device execution;
        partial remainders stay buffered until flush().  Returns the
        pending entries dispatched now (for collect())."""
        pending = []
        for (lq, lt), qoff, qlen, toff, tlen, term, pos in jobs:
            key = (lq, lt, gap_open, gap_extend, reverse)
            self._buf.setdefault(key, []).append(
                (np.asarray(qoff, np.int32), np.asarray(qlen, np.int32),
                 np.asarray(toff, np.int32), np.asarray(tlen, np.int32),
                 np.asarray(term, np.int32), np.asarray(pos)))
            pending += self._drain(key, full_only=True)
        return pending

    def flush(self, gap_open: int, gap_extend: int, reverse: bool):
        """Dispatch every buffered remainder for this direction (the
        final partial batch per rung is tail-padded with qlen=1 rows)."""
        pending = []
        for key in sorted(k for k in list(self._buf)
                          if k[2:] == (gap_open, gap_extend, reverse)):
            pending += self._drain(key, full_only=False)
        return pending

    def _drain(self, key, full_only: bool):
        lq, lt = key[:2]
        unit = batch_width(lq, lt)
        buf = self._buf.get(key)
        if not buf:
            return []
        n = sum(len(b[0]) for b in buf)
        if n == 0 or (full_only and n < unit):
            return []
        cols = [np.concatenate([b[i] for b in buf]) for i in range(6)]
        # sort by tlen so the pairs that share a block of the GPU kernel
        # walk similar numbers of columns (results are position-addressed
        # via cols[5], so order is free)
        order = np.argsort(cols[3], kind="stable")
        cols = [c[order] for c in cols]
        take = (n // unit) * unit if full_only else n
        self._buf[key] = ([tuple(c[take:] for c in cols)]
                          if take < n else [])
        return [self._dispatch_unit(key, cols, s, min(s + unit, take))
                for s in range(0, take, unit)]

    def _dispatch_unit(self, key, cols, s: int, e: int):
        """One device execution carrying pairs cols[*][s:e], tail-padded
        to the rung's batch width."""
        import time
        lq, lt, gap_open, gap_extend, reverse = key
        self.ensure_warm(lq, lt, gap_open, gap_extend, reverse)
        t0 = time.perf_counter()
        n = e - s
        params = self._pad_params(batch_width(lq, lt), reverse)
        for i in range(5):
            params[i, :n] = cols[i][s:e]
        r = self._call(jnp.asarray(params), lq, lt, gap_open, gap_extend,
                       reverse)
        self.metrics["n_batches"] += 1
        rk = f"{lq}{'r' if reverse else 'f'}"
        rung = self.metrics.setdefault("rungs", {}).setdefault(
            rk, {"execs": 0, "pairs": 0})
        rung["execs"] += 1
        rung["pairs"] += n
        self.metrics["dispatch_s"] += time.perf_counter() - t0
        return (cols[5][s:e], r)

    def dispatch(self, jobs, gap_open: int, gap_extend: int,
                 reverse: bool):
        """Monolithic entry: enqueue + flush this direction's buffers.
        Returns a pending list for collect()."""
        return (self.enqueue(jobs, gap_open, gap_extend, reverse)
                + self.flush(gap_open, gap_extend, reverse))

    def collect(self, pending):
        """Fetch every pending batch with ONE device-to-host transfer, so
        a stage costs O(1) transfers, not O(batches).  Returns
        (positions, numpy-tuple) per batch: (score, t_end, q_end, found,
        fj, fi)."""
        import time
        if not pending:
            return []
        t1 = time.perf_counter()
        flat = np.asarray(_concat_results([r for _, r in pending]))
        t2 = time.perf_counter()
        self.metrics["fetch_s"] += t2 - t1
        out, col = [], 0
        for pos, r in pending:
            b = r[0].shape[0]
            out.append((pos, tuple(flat[i, col:col + len(pos)]
                                   for i in range(len(r)))))
            col += b
        return out

    def run_buckets(self, jobs, gap_open: int, gap_extend: int,
                    reverse: bool):
        return self.collect(self.dispatch(jobs, gap_open, gap_extend,
                                          reverse))


@functools.partial(
    jax.jit,
    static_argnames=("Lq", "Lt", "gap_open", "gap_extend"))
def _sw_bucket_struct(qss, qaa, qbias, tss, taa, m3di, aasc, params,
                      *, Lq: int, Lt: int, gap_open: int, gap_extend: int):
    """Structure-mode bucket: the combined 3Di x AA score decomposes into
    two 21-wide channels (S = mat3di[q_ss, t_ss] + aa_scaled[q_aa, t_aa]
    + bias_3di[q], search/structure.py; the bias is foldseek's 3Di
    composition correction) over resident token arrays.  Same (6, B)
    params and 6-output contract as bucket_sw, with the direction in the
    runtime row params[5]."""
    qoff, qlen, toff, tlen, terminate, rev = [params[i] for i in range(6)]
    iq = np.arange(Lq, dtype=np.int32)
    it = np.arange(Lt, dtype=np.int32)
    r = rev[:, None] != 0
    q_idx = qoff[:, None] + jnp.where(
        r, jnp.maximum(qlen[:, None] - 1 - iq[None, :], 0),
        jnp.minimum(iq[None, :], qlen[:, None] - 1))
    t_idx = toff[:, None] + jnp.where(
        r, jnp.maximum(tlen[:, None] - 1 - it[None, :], 0),
        jnp.minimum(it[None, :], tlen[:, None] - 1))

    def prof_for(tokens, sub):
        qt = tokens[q_idx].astype(jnp.int32)            # (B, Lq)
        return jnp.transpose(sub[qt], (0, 2, 1))        # (B, A, Lq)

    p1 = prof_for(qss, m3di) + qbias[q_idx].astype(jnp.int32)[:, None, :]
    p2 = prof_for(qaa, aasc)
    t1 = tss[t_idx].astype(jnp.int32)
    t2 = taa[t_idx].astype(jnp.int32)
    return sw_scan_core(p1, t1, qlen, tlen, gap_open, gap_extend,
                        terminate, t_tile=min(128, Lt),
                        all_outputs=True, prof2=p2, tseq2=t2)


class StructureDeviceDB(DeviceAlignDB):
    """Device-resident 3Di + AA token arrays (structure search mode);
    same dispatch/collect/warm contract as DeviceAlignDB."""

    def __init__(self, qss, qaa, qbias, tss, taa, m3di, aasc):
        self.qss = jnp.asarray(_pow2_pad(qss.astype(np.int8)))
        self.qaa = jnp.asarray(_pow2_pad(qaa.astype(np.int8)))
        self.qbias = jnp.asarray(_pow2_pad(qbias.astype(np.int8)))
        self.tss = jnp.asarray(_pow2_pad(tss.astype(np.int8)))
        self.taa = jnp.asarray(_pow2_pad(taa.astype(np.int8)))
        self.m3di = jnp.asarray(m3di.astype(np.int32))
        self.aasc = jnp.asarray(aasc.astype(np.int32))
        self._init_state()

    def _resident(self):
        return (self.qss, self.qaa, self.qbias, self.tss, self.taa,
                self.m3di, self.aasc)

    def _call(self, params, lq: int, lt: int, gap_open: int,
              gap_extend: int, reverse: bool = False):
        # the structure bucket keeps the runtime rev row (params[5])
        return _sw_bucket_struct(*self._resident(), params,
                                 Lq=lq, Lt=lt, gap_open=gap_open,
                                 gap_extend=gap_extend)

    def _lower_compile(self, params, lq: int, lt: int, gap_open: int,
                       gap_extend: int, reverse: bool) -> None:
        _sw_bucket_struct.lower(*self._resident(), params,
                                Lq=lq, Lt=lt, gap_open=gap_open,
                                gap_extend=gap_extend).compile()
