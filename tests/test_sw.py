"""Smith-Waterman kernel unit tests: exact scores vs a reference DP,
endpoint tie-breaks, and banded traceback round-trips."""

import numpy as np
import pytest

from spacedust_tpu.constants import encode_aa
from spacedust_tpu.native import banded_align
from spacedust_tpu.ops.sw import sw_forward, sw_reverse
from spacedust_tpu.stats.submat import load_substitution_matrix


def ref_sw(q, t, sub, bias, go=11, ge=1):
    """Textbook Gotoh local alignment in numpy for oracle comparison."""
    NEG = -10**9
    Lq, Lt = len(q), len(t)
    H = np.zeros((Lq + 1, Lt + 1), dtype=np.int64)
    E = np.full((Lq + 1, Lt + 1), NEG, dtype=np.int64)  # gap consuming t
    F = np.full((Lq + 1, Lt + 1), NEG, dtype=np.int64)  # gap consuming q
    for i in range(1, Lq + 1):
        for j in range(1, Lt + 1):
            E[i, j] = max(E[i, j - 1] - ge, H[i, j - 1] - go)
            F[i, j] = max(F[i - 1, j] - ge, H[i - 1, j] - go)
            s = sub[q[i - 1], t[j - 1]] + bias[i - 1]
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
    return H


@pytest.fixture(scope="module")
def matrix():
    return load_substitution_matrix()


def _run_one(matrix, qs, ts, bias=None):
    q = encode_aa(qs)
    t = encode_aa(ts)
    b = np.zeros(len(q), dtype=np.int8) if bias is None else bias
    score, q_end, t_end = sw_forward(
        q[None, :].copy(), np.array([len(q)]),
        t[None, :].copy(), np.array([len(t)]),
        matrix.sub_int, b[None, :].copy())
    H = ref_sw(q, t, matrix.sub_int, b)
    assert int(score[0]) == int(H.max()), f"{qs} vs {ts}"
    return int(score[0]), int(q_end[0]), int(t_end[0]), H


def test_identical_sequences(matrix):
    s, qe, te, H = _run_one(matrix, "MKVLAAGDEW", "MKVLAAGDEW")
    assert qe == 9 and te == 9


def test_gapped_alignment(matrix):
    s, qe, te, H = _run_one(matrix, "MKVLAAAGDEWRK", "MKVLGDEWRK")
    assert s > 0


def test_random_pairs_match_reference_dp(matrix):
    rng = np.random.default_rng(0)
    for _ in range(20):
        lq = int(rng.integers(5, 60))
        lt = int(rng.integers(5, 60))
        q = rng.integers(0, 20, lq).astype(np.uint8)
        t = rng.integers(0, 20, lt).astype(np.uint8)
        bias = rng.integers(-2, 3, lq).astype(np.int8)
        score, q_end, t_end = sw_forward(
            q[None, :].copy(), np.array([lq]), t[None, :].copy(),
            np.array([lt]), matrix.sub_int, bias[None, :].copy())
        H = ref_sw(q, t, matrix.sub_int, bias)
        assert int(score[0]) == int(H.max())
        if H.max() > 0:
            # endpoint: first target column with the max, min row within it
            cols = H[1:, 1:].max(axis=0)
            j_star = int(np.argmax(cols == H.max()))
            i_star = int(np.argmax(H[1:, j_star + 1] == H.max()))
            assert int(t_end[0]) == j_star
            assert int(q_end[0]) == i_star


def test_reverse_pass_finds_start(matrix):
    q = encode_aa("AAAAMKVLGDEWRKAAAA")
    t = encode_aa("CCMKVLGDEWRKCC")
    b = np.zeros(len(q), dtype=np.int8)
    score, q_end, t_end = sw_forward(
        q[None, :].copy(), np.array([len(q)]), t[None, :].copy(),
        np.array([len(t)]), matrix.sub_int, b[None, :].copy())
    qr = q[:int(q_end[0]) + 1][::-1]
    tr = t[:int(t_end[0]) + 1][::-1]
    br = b[:int(q_end[0]) + 1][::-1]
    _s, fj, fi, found = sw_reverse(
        qr[None, :].copy(), np.array([len(qr)]), tr[None, :].copy(),
        np.array([len(tr)]), matrix.sub_int, br[None, :].copy(),
        np.array([int(score[0])]))
    assert found[0]
    q_start = int(q_end[0]) - int(fi[0])
    t_start = int(t_end[0]) - int(fj[0])
    assert (q_start, t_start) == (4, 2)  # MKVL... begins at q[4], t[2]


def test_banded_traceback_identity(matrix):
    q = encode_aa("MKVLGDEWRK")
    score = int(matrix.sub_int[q, q].sum())
    ops = banded_align(q, q, np.zeros(len(q), np.int8),
                       matrix.sub_int.astype(np.int8), score)
    assert ops == "M" * len(q)


def test_banded_traceback_gap(matrix):
    q = encode_aa("MKVLAAAGDEWRK")
    t = encode_aa("MKVLGDEWRK")
    b = np.zeros(len(q), dtype=np.int8)
    H = ref_sw(q, t, matrix.sub_int, b)
    score = int(H.max())
    ops = banded_align(q, t, b, matrix.sub_int.astype(np.int8), score)
    # q has 3 extra residues -> 3 insertions
    assert ops.count("I") == 3
    assert ops.count("M") == 10
    assert ops.count("D") == 0


def test_cigar_exactly_filling_its_slot_stays_in_it(matrix):
    """A run-length CIGAR of single-op runs ("1M1D1M") is exactly twice
    its op count, the size of its slot: the terminating NUL must not land
    in the next byte (the next record's slot under OpenMP)."""
    import ctypes
    from spacedust_tpu.native import _ptr, get_lib
    q = encode_aa("WW")
    t = encode_aa("WAW")
    out_offs = np.array([0, 3], np.int64)          # ops slot: exactly 3
    ops = ctypes.create_string_buffer(3)
    cigar = ctypes.create_string_buffer(b"#" * 8, 8)  # 6-byte slot + guard
    out_len = np.zeros(1, np.int32)
    out_ident = np.zeros(1, np.int32)
    out_clen = np.zeros(1, np.int32)
    i32 = lambda *v: np.array(v, np.int32)          # noqa: E731
    mat = np.ascontiguousarray(matrix.sub_int, dtype=np.int8)
    bad = get_lib().banded_align_batch(
        _ptr(q, ctypes.c_uint8), _ptr(np.zeros(1, np.int64), ctypes.c_int64),
        _ptr(t, ctypes.c_uint8), _ptr(np.zeros(1, np.int64), ctypes.c_int64),
        _ptr(np.zeros(2, np.int8), ctypes.c_int8),
        _ptr(mat, ctypes.c_int8), mat.shape[0], 1,
        _ptr(i32(0), ctypes.c_int32), _ptr(i32(0), ctypes.c_int32),
        _ptr(i32(0), ctypes.c_int32), _ptr(i32(1), ctypes.c_int32),
        _ptr(i32(0), ctypes.c_int32), _ptr(i32(2), ctypes.c_int32),
        _ptr(i32(11), ctypes.c_int32), 11, 1,
        _ptr(out_offs, ctypes.c_int64), ops,
        _ptr(out_len, ctypes.c_int32), _ptr(out_ident, ctypes.c_int32),
        cigar, _ptr(out_clen, ctypes.c_int32))
    assert bad == 0
    assert ops.raw[:3] == b"MDM"
    assert cigar.raw[:6] == b"1M1D1M" and out_clen[0] == 6
    assert cigar.raw[6:] == b"##"
