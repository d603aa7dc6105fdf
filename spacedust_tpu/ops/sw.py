"""Batched Smith-Waterman (score + endpoints) via JAX: the host path.

Computes the exact affine-gap local-alignment score in int32 — numerically
identical to the reference's striped u8/u16 kernels with saturation
fallback (StripedSmithWaterman.cpp:354-461), since those recompute on
overflow. Endpoint tie-breaking replicates sw_sse2_byte/word:

  * end positions: the FIRST target column (ascending scan) whose column
    maximum strictly exceeds the previous global max, then the minimum
    query row achieving that max within the column
    (StripedSmithWaterman.cpp:869-887,893-900)
  * the reverse pass scans target columns backward from the forward end
    and stops at the first column whose maximum equals the forward score
    (`terminate`, StripedSmithWaterman.cpp:903-905), yielding start
    positions closest to the end (shortest alignment)

Per-cell score for sequence-sequence alignment:
  sub[q_i][t_j] + compositionBias[i]  (ssw_init, StripedSmithWaterman.cpp:1316-1326)

Layout: the target dimension is the scan axis; batch and query dimensions
are vectorized (the F-gap recurrence inside a column is closed-form via a
running-max prefix scan instead of the reference's lazy-F loop).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(1 << 30)


@functools.partial(jax.jit, static_argnames=("with_terminate", "gap_open",
                                             "gap_extend"))
def _sw_scan(prof, tseq, qlens, tlens, gap_open, gap_extend, terminate,
             with_terminate: bool):
    """prof: (B, A, Lq) int32 per-query position profiles (bias included).
    tseq: (B, Lt) int32 residue indices. Returns (score, t_end, q_end) or,
    with_terminate, the (t_break, q_break) of the terminate column."""
    B, A, Lq = prof.shape
    Lt = tseq.shape[1]
    iota_q = np.arange(Lq, dtype=np.int32)
    row_valid = iota_q[None, :] < qlens[:, None]          # (B, Lq)
    batch_idx = np.arange(B)

    go = np.int32(gap_open)
    ge = np.int32(gap_extend)

    def step(state, j):
        H, E, gmax, gj, gi, found, fj, fi = state
        t_col = tseq[:, j]                                 # (B,)
        s_col = prof[batch_idx, t_col, :]                  # (B, Lq)
        s_col = jnp.where(row_valid, s_col, NEG)

        diag = jnp.pad(H[:, :-1], ((0, 0), (1, 0)))        # H[i-1][j-1]
        E_new = jnp.maximum(E - ge, H - go)                # E[:, j] from col j-1
        Hbase = jnp.maximum(jnp.maximum(diag + s_col, 0), E_new)
        # F prefix-scan: F[i] = max_{i'<i}(Hbase[i'] + ge*i') - go - ge*(i-1)
        shifted = jnp.pad((Hbase + ge * iota_q[None, :])[:, :-1],
                          ((0, 0), (1, 0)), constant_values=NEG)
        acc = jax.lax.cummax(shifted, axis=1)
        F = acc - go - ge * (iota_q[None, :] - 1)
        H_new = jnp.maximum(Hbase, F)
        H_new = jnp.where(row_valid, H_new, 0)

        col_valid = j < tlens                              # (B,)
        H_out = jnp.where(col_valid[:, None], H_new, H)
        E_out = jnp.where(col_valid[:, None], E_new, E)

        Hmasked = jnp.where(row_valid, H_new, -1)
        cmax = jnp.max(Hmasked, axis=1)
        ci = jnp.argmax(Hmasked, axis=1).astype(jnp.int32)  # first max row
        better = col_valid & (cmax > gmax)
        gmax = jnp.where(better, cmax, gmax)
        gj = jnp.where(better, j, gj)
        gi = jnp.where(better, ci, gi)

        if with_terminate:
            hit = col_valid & (~found) & (cmax == terminate)
            fj = jnp.where(hit, j, fj)
            fi = jnp.where(hit, ci, fi)
            found = found | hit

        return (H_out, E_out, gmax, gj, gi, found, fj, fi), None

    H0 = jnp.zeros((B, Lq), jnp.int32)
    E0 = jnp.full((B, Lq), NEG)
    init = (H0, E0,
            jnp.zeros(B, jnp.int32),                      # gmax
            jnp.full(B, -1, jnp.int32),                   # gj (end_db)
            jnp.full(B, 0, jnp.int32),                    # gi
            jnp.zeros(B, bool),
            jnp.full(B, -1, jnp.int32),
            jnp.full(B, 0, jnp.int32))
    (H, E, gmax, gj, gi, found, fj, fi), _ = jax.lax.scan(
        step, init, jnp.arange(Lt, dtype=jnp.int32))
    if with_terminate:
        return gmax, fj, fi, found
    return gmax, gj, gi


def make_profiles(qseqs: np.ndarray, qlens: np.ndarray, sub_int: np.ndarray,
                  bias: np.ndarray) -> np.ndarray:
    """prof[b, a, i] = sub[q[b,i], a] + bias[b,i] (int32)."""
    prof = sub_int.T[:, qseqs.astype(np.int64)]            # (A, B, Lq)
    prof = np.transpose(prof, (1, 0, 2)).astype(np.int32)
    prof = prof + bias[:, None, :].astype(np.int32)
    return prof


def _pick_tile(lt: int) -> int:
    for t in (128, 64, 32, 16, 8, 4, 2, 1):
        if lt % t == 0:
            return t
    return 1


def sw_forward_from_profiles(prof, tseqs, tlens, qlens,
                             gap_open=11, gap_extend=1):
    """Forward pass from prebuilt (B, A, Lq) int32 profiles."""
    from .sw_tiled import sw_scan_tiled
    score, t_end, q_end = sw_scan_tiled(
        jnp.asarray(prof), jnp.asarray(tseqs.astype(np.int32)),
        jnp.asarray(qlens.astype(np.int32)), jnp.asarray(tlens.astype(np.int32)),
        gap_open, gap_extend, jnp.zeros(len(qlens), jnp.int32),
        t_tile=_pick_tile(tseqs.shape[1]))
    return np.asarray(score), np.asarray(q_end), np.asarray(t_end)


def sw_reverse_from_profiles(prof_rev, tseqs_rev, tlens, qlens, terminate,
                             gap_open=11, gap_extend=1):
    """Reverse pass from prebuilt reversed profiles + terminate scores."""
    from .sw_tiled import sw_scan_tiled
    score, fj, fi, found = sw_scan_tiled(
        jnp.asarray(prof_rev), jnp.asarray(tseqs_rev.astype(np.int32)),
        jnp.asarray(qlens.astype(np.int32)), jnp.asarray(tlens.astype(np.int32)),
        gap_open, gap_extend, jnp.asarray(terminate.astype(np.int32)),
        t_tile=_pick_tile(tseqs_rev.shape[1]), with_terminate=True)
    return np.asarray(score), np.asarray(fj), np.asarray(fi), np.asarray(found)


def sw_forward(qseqs, qlens, tseqs, tlens, sub_int, bias,
               gap_open=11, gap_extend=1):
    """Forward pass: returns (score, q_end, t_end) int32 arrays (B,)."""
    prof = make_profiles(qseqs, qlens, sub_int, bias)
    return sw_forward_from_profiles(prof, tseqs, tlens, qlens,
                                    gap_open, gap_extend)


def sw_reverse(qseqs_rev, qlens, tseqs_rev, tlens, sub_int, bias_rev,
               terminate, gap_open=11, gap_extend=1):
    """Reverse pass on reversed prefixes; `terminate[b]` = forward score.
    Returns (score, j_break, i_break, found): j/i in reversed coordinates."""
    prof = make_profiles(qseqs_rev, qlens, sub_int, bias_rev)
    return sw_reverse_from_profiles(prof, tseqs_rev, tlens, qlens, terminate,
                                    gap_open, gap_extend)
