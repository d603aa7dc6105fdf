"""Tiled Smith-Waterman column scan: the plain XLA reference.

Same math and outputs as ops/sw.py's `_sw_scan`.  The per-column
substitution scores are produced for a whole target tile at once as an
exact int8 one-hot dot —

    S[b, i, j] = sum_a prof[b, a, i] * onehot(t[b, j] == a)

— so the inner scan does a cheap dynamic-slice per column instead of a
batched gather.  The in-column F recurrence stays closed-form via a
log-depth shift-max (associative max-plus scan).  This is the CPU
backend's device path and the reference every GPU kernel is compared
with (ops/cuda/sw_scan.cu must match it bit for bit).

Exactness: profiles are small ints (|v| <= 127), one-hot is 0/1, so the
int8 x int8 -> int32 dot is exact; DP runs in int32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(1 << 30)


def _cummax_lanes(x):
    """Log-depth running max along axis 1 (inclusive)."""
    n = x.shape[1]
    shift = 1
    while shift < n:
        shifted = jnp.pad(x[:, :-shift], ((0, 0), (shift, 0)),
                          constant_values=NEG)
        x = jnp.maximum(x, shifted)
        shift *= 2
    return x


@functools.partial(jax.jit,
                   static_argnames=("gap_open", "gap_extend", "t_tile",
                                    "with_terminate"))
def sw_scan_tiled(prof, tseq, qlens, tlens, gap_open, gap_extend, terminate,
                  t_tile: int = 128, with_terminate: bool = False):
    return sw_scan_core(prof, tseq, qlens, tlens, gap_open, gap_extend,
                        terminate, t_tile=t_tile,
                        with_terminate=with_terminate)


def sw_scan_core(prof, tseq, qlens, tlens, gap_open, gap_extend, terminate,
                 t_tile: int = 128, with_terminate: bool = False,
                 prof2=None, tseq2=None, all_outputs: bool = False):
    """prof: (B, A, Lq) int32; tseq: (B, Lt) int32. Lt % t_tile == 0.
    Returns (score, t_end, q_end) or terminate-column results, identical
    to ops.sw._sw_scan.  Unjitted core so callers can fuse it.

    prof2/tseq2: optional second channel summed into the score grid —
    S = prof[.., tseq] + prof2[.., tseq2]. Used by the structure mode
    where the combined 3Di x AA score decomposes into two 21-wide
    channels (vastly cheaper than a 441-wide one-hot)."""
    B, A, Lq = prof.shape
    Lt = tseq.shape[1]
    assert Lt % t_tile == 0
    iota_q = np.arange(Lq, dtype=np.int32)
    row_valid = iota_q[None, :] < qlens[:, None]
    go = np.int32(gap_open)
    ge = np.int32(gap_extend)

    prof_i8 = prof.astype(jnp.int8)                     # (B, A, Lq)
    prof2_i8 = prof2.astype(jnp.int8) if prof2 is not None else None
    n_tiles = Lt // t_tile

    def _score_tile(pr, ts, tile_idx):
        t_slice = jax.lax.dynamic_slice_in_dim(ts, tile_idx * t_tile,
                                               t_tile, axis=1)
        a = pr.shape[1]
        onehot = (t_slice[:, None, :] ==
                  np.arange(a, dtype=np.int32)[None, :, None]).astype(jnp.int8)
        return jax.lax.dot_general(
            pr, onehot,
            dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)            # (B, Lq, T)

    def tile_step(state, tile_idx):
        H, E, gmax, gj, gi, found, fj, fi = state
        # S[b, i, j] over the tile — exact int8 dot(s)
        S = _score_tile(prof_i8, tseq, tile_idx)
        if prof2_i8 is not None:
            S = S + _score_tile(prof2_i8, tseq2, tile_idx)

        track_term = with_terminate or all_outputs

        def col_step(carry, j):
            H, E, gmax, gj, gi, found, fj, fi = carry
            jj = tile_idx * t_tile + j
            s_col = jax.lax.dynamic_index_in_dim(S, j, axis=2, keepdims=False)
            s_col = jnp.where(row_valid, s_col, NEG)
            diag = jnp.pad(H[:, :-1], ((0, 0), (1, 0)))
            E_new = jnp.maximum(E - ge, H - go)
            Hbase = jnp.maximum(jnp.maximum(diag + s_col, 0), E_new)
            shifted = jnp.pad((Hbase + ge * iota_q[None, :])[:, :-1],
                              ((0, 0), (1, 0)), constant_values=NEG)
            F = _cummax_lanes(shifted) - go - ge * (iota_q[None, :] - 1)
            H_new = jnp.where(row_valid, jnp.maximum(Hbase, F), 0)

            col_valid = jj < tlens
            H_out = jnp.where(col_valid[:, None], H_new, H)
            E_out = jnp.where(col_valid[:, None], E_new, E)

            Hmasked = jnp.where(row_valid, H_new, -1)
            cmax = jnp.max(Hmasked, axis=1)
            ci = jnp.argmax(Hmasked, axis=1).astype(jnp.int32)
            better = col_valid & (cmax > gmax)
            gmax = jnp.where(better, cmax, gmax)
            gj = jnp.where(better, jj, gj)
            gi = jnp.where(better, ci, gi)
            if track_term:
                hit = col_valid & (~found) & (cmax == terminate)
                fj = jnp.where(hit, jj, fj)
                fi = jnp.where(hit, ci, fi)
                found = found | hit
            return (H_out, E_out, gmax, gj, gi, found, fj, fi), None

        state, _ = jax.lax.scan(col_step, state,
                                jnp.arange(t_tile, dtype=jnp.int32))
        return state, None

    init = (jnp.zeros((B, Lq), jnp.int32),
            jnp.full((B, Lq), NEG, jnp.int32),
            jnp.zeros(B, jnp.int32),
            jnp.full(B, -1, jnp.int32),
            jnp.zeros(B, jnp.int32),
            jnp.zeros(B, bool),
            jnp.full(B, -1, jnp.int32),
            jnp.zeros(B, jnp.int32))
    (H, E, gmax, gj, gi, found, fj, fi), _ = jax.lax.scan(
        tile_step, init, jnp.arange(n_tiles, dtype=jnp.int32))
    if all_outputs:
        return gmax, gj, gi, found, fj, fi
    if with_terminate:
        return gmax, fj, fi, found
    return gmax, gj, gi
