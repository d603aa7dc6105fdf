"""Target-sharded batched Smith-Waterman over a device mesh.

The multi-device analog of ops/sw_engine.py: each device along the
`targets` mesh axis holds ONE target shard's token array resident in its
memory (the reference's target-split mode keeps one split's index per
MPI rank, Prefiltering.cpp:575-722); query tokens + bias are replicated.
Every SW batch is a (D, B) grid — device d scores B pairs whose targets
live in shard d, reading target tokens from its local shard only.
Results come back sharded; `gather_scores` is the all-gather that
replaces the reference's shared-filesystem split merge
(DBWriter::mergeResults).

The per-device body is ops/sw_engine.bucket_sw with the same kernel
choice as the single-device engine (the CUDA scan on GPUs, the XLA
reference scan on the CPU), so sharded and unsharded searches produce
identical records.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.sw_engine import bucket_sw, select_kernel
from ..utils.jaxconf import configure_jax

configure_jax()


def make_mesh(devices=None, axis: str = "targets") -> Mesh:
    """A flat 1-D mesh: every device reaches every other at the same
    rate, so the target shards need no topology-aware layout."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


@functools.lru_cache(maxsize=64)
def _sharded_bucket_fn(mesh: Mesh, Lq: int, Lt: int, gap_open: int,
                       gap_extend: int, reverse: bool, kernel: str):
    """Compiled (D, B)-grid SW for one (Lq, Lt) length bucket."""
    axis = mesh.axis_names[0]

    def local(qdata, qbias, tshard, sub, qoff, qlen, toff, tlen, term):
        # qdata/qbias: (Q,) replicated; tshard: (1, S) this device's shard;
        # qoff..term: (1, B) this device's batch (shard-local toff)
        params = jnp.stack([qoff[0], qlen[0], toff[0], tlen[0], term[0],
                            jnp.zeros_like(qoff[0])])
        out = bucket_sw(qdata, qbias, tshard[0], sub, params, Lq=Lq, Lt=Lt,
                        gap_open=gap_open, gap_extend=gap_extend,
                        reverse=reverse, kernel=kernel)
        return tuple(x.astype(jnp.int32)[None] for x in out)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P(),
                  P(axis, None), P(axis, None), P(axis, None), P(axis, None),
                  P(axis, None)),
        out_specs=tuple(P(axis, None) for _ in range(6)),
        check_vma=False)
    return jax.jit(fn)


class ShardedAlignDB:
    """Device-resident arrays: replicated query tokens/bias, per-device
    target shard tokens."""

    def __init__(self, mesh: Mesh, qdata: np.ndarray, qbias: np.ndarray,
                 tdata: np.ndarray, tok_bounds: list[tuple[int, int]],
                 sub: np.ndarray):
        """tok_bounds: per-shard [start, end) ranges into `tdata` (token
        positions, one entry per mesh device)."""
        self.mesh = mesh
        axis = mesh.axis_names[0]
        n_dev = mesh.devices.size
        assert len(tok_bounds) == n_dev
        self.tok_starts = np.array([s for s, _ in tok_bounds], dtype=np.int64)
        smax = max(1, max(e - s for s, e in tok_bounds))
        shards = np.zeros((n_dev, smax), dtype=np.int8)
        for d, (s, e) in enumerate(tok_bounds):
            shards[d, :e - s] = tdata[s:e].astype(np.int8)
        rep = NamedSharding(mesh, P())
        shd = NamedSharding(mesh, P(axis, None))
        self.qdata = jax.device_put(qdata.astype(np.int8), rep)
        self.qbias = jax.device_put(qbias.astype(np.int8), rep)
        self.tshards = jax.device_put(shards, shd)
        self.sub = jax.device_put(sub.astype(np.int32), rep)
        self._shd = shd
        self.kernel = select_kernel()

    def run_grid(self, bucket: tuple[int, int], qoff, qlen, toff, tlen, term,
                 gap_open: int, gap_extend: int, reverse: bool):
        """qoff..term: (D, B) int32 with shard-local toff; returns the
        per-device (score, gj, gi, found, fj, fi) as numpy (D, B)
        arrays."""
        lq, lt = bucket
        fn = _sharded_bucket_fn(self.mesh, lq, lt, gap_open, gap_extend,
                                reverse, self.kernel)
        args = [jax.device_put(np.asarray(a, dtype=np.int32), self._shd)
                for a in (qoff, qlen, toff, tlen, term)]
        out = fn(self.qdata, self.qbias, self.tshards, self.sub, *args)
        return tuple(np.asarray(x) for x in out)

    def gather_scores(self, scores):
        """All-gather of per-shard score blocks (the collective that
        replaces the reference's file merge); returns (D*B,) on host."""
        axis = self.mesh.axis_names[0]

        @functools.partial(
            shard_map, mesh=self.mesh, in_specs=(P(axis, None),),
            out_specs=P(), check_vma=False)
        def _gather(block):
            return jax.lax.all_gather(block[0], axis)

        return np.asarray(jax.jit(_gather)(
            jax.device_put(jnp.asarray(scores), self._shd))).reshape(-1)
