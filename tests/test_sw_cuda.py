"""The CUDA Smith-Waterman kernel (ops/cuda/sw_scan.cu) and its wrapper.

CUDA has no interpret mode, so the kernel's decomposition is checked
here by a NumPy emulation that follows it step for step: query stripes
of 32 lanes x R rows, the per-lane R choice, the wavefront with the
shfl_up hand-off of each lane's bottom row (H, F, column maximum and its
row), the stripe-to-stripe carry buffer, the (H << 5) + (31 - k) key,
and the final-stripe trackers.  The emulation must equal the plain
reference scan (sw_scan_core via bucket_sw's XLA path) on every output.
The wrapper's shapes, padding and kernel choice are tested on the CPU;
the kernel itself runs only in the `gpu`-marked test, on the card.
"""

import numpy as np
import pytest

from spacedust_tpu.db.synth import _tables, mutate
from spacedust_tpu.ops import sw_engine
from spacedust_tpu.stats.submat import load_substitution_matrix

NEG = -(1 << 30)
BAD = -(1 << 30)


def emulate(qdata, qbias, tdata, sub, params, Lq, Lt, reverse,
            go=11, ge=1, lanes=32):
    """(6, B) outputs of sw_scan_kernel, computed the kernel's way."""
    B = params.shape[1]
    out = np.zeros((6, B), np.int64)
    sub = sub.astype(np.int64)
    for b in range(B):
        qoff, qlen, toff, tlen, term = (int(x) for x in params[:5, b])
        qlen, tlen = min(qlen, Lq), min(tlen, Lt)
        qidx = np.arange(qlen)
        tidx = np.arange(tlen)
        if reverse:
            qidx, tidx = qlen - 1 - qidx, tlen - 1 - tidx
        qtok = qdata[qoff + qidx].astype(np.int64)
        bias = qbias[qoff + qidx].astype(np.int64)
        ttok = tdata[toff + tidx].astype(np.int64)
        n8 = -(-qlen // (lanes * 8))
        n16 = -(-qlen // (lanes * 16))
        R = 16 if n16 * 11 <= n8 * 6 else 8
        out[:, b] = _pair(qtok, bias, ttok, sub, term, go, ge, lanes, R)
    return out


def _pair(qtok, bias, ttok, sub, term, go, ge, W, R):
    qlen, tlen = len(qtok), len(ttok)
    rows = W * R
    # int8 profile, wrapped as the kernel packs it
    prof_full = ((sub[qtok].T + bias[None, :] + 128) % 256) - 128
    gmax, gj, gi, found, fj, fi = 0, -1, 0, 0, -1, 0
    carry = [np.zeros((tlen, 4), np.int64), np.zeros((tlen, 4), np.int64)]
    lane = np.arange(W)
    nstripes = -(-qlen // rows)
    for s in range(nstripes):
        base = s * rows
        r0 = base + lane * R
        last = min(W - 1, (qlen - 1 - base) // R)
        final = s == nstripes - 1
        rowidx = r0[:, None] + np.arange(R)[None, :]
        valid = rowidx < qlen
        prof = np.zeros((sub.shape[0], W, R), np.int64)
        prof[:, valid] = prof_full[:, rowidx[valid]]
        ck = np.where(valid, 31 - np.arange(R)[None, :], BAD)
        H = np.zeros((W, R), np.int64)
        E = np.full((W, R), NEG, np.int64)
        hdiag = np.zeros(W, np.int64)
        h_out = np.zeros(W, np.int64)
        f_out = np.full(W, NEG, np.int64)
        cm_out = np.full(W, -1, np.int64)
        cr_out = np.zeros(W, np.int64)
        cin, cout = carry[(s + 1) & 1], carry[s & 1]
        for st in range(tlen + last):
            # shfl_up: lane l reads lane l-1's value of the previous step
            h_up, f_up = np.roll(h_out, 1), np.roll(f_out, 1)
            cm_up, cr_up = np.roll(cm_out, 1), np.roll(cr_out, 1)
            j = st - lane
            act = (lane <= last) & (j >= 0) & (j < tlen)
            if act[0]:
                if s == 0:
                    h_up[0], f_up[0], cm_up[0], cr_up[0] = 0, NEG, -1, 0
                else:
                    h_up[0], f_up[0], cm_up[0], cr_up[0] = cin[j[0]]
            t = np.where(act, ttok[np.clip(j, 0, max(tlen - 1, 0))], 0)
            sc = prof[t, lane, :]
            diag = hdiag.copy()
            f = f_up.copy()
            key = np.zeros((W, R), np.int64)
            for k in range(R):
                e = np.maximum(E[:, k] - ge, H[:, k] - go)
                hb = np.maximum(np.maximum(diag + sc[:, k], e), 0)
                h = np.maximum(hb, f)
                f = np.maximum(f - ge, hb - go)
                diag = H[:, k].copy()
                H[:, k] = np.where(act, h, H[:, k])
                E[:, k] = np.where(act, e, E[:, k])
                key[:, k] = h * 32 + ck[:, k]
            best = key.max(axis=1)
            hdiag = np.where(act, h_up, hdiag)
            h_out = np.where(act, H[:, R - 1], h_out)
            f_out = np.where(act, f, f_out)
            lh = best >> 5
            take = lh > cm_up
            cm_new = np.where(take, lh, cm_up)
            cr_new = np.where(take, r0 + 31 - (best & 31), cr_up)
            cm_out = np.where(act, cm_new, cm_out)
            cr_out = np.where(act, cr_new, cr_out)
            if act[last]:
                jl, cm, cr = int(j[last]), int(cm_out[last]), int(cr_out[last])
                if final:
                    if cm > gmax:
                        gmax, gj, gi = cm, jl, cr
                    if not found and cm == term:
                        found, fj, fi = 1, jl, cr
                else:
                    cout[jl] = (h_out[last], f_out[last], cm, cr)
    return gmax, gj, gi, found, fj, fi


def _batch(rng, n, max_len, homolog_every=2):
    """Random and homologous pairs as resident arrays + (6, n) params."""
    back, cum = _tables()
    q, t = [], []
    for i in range(n):
        a = rng.choice(20, size=int(rng.integers(1, max_len + 1)),
                       p=back).astype(np.uint8)
        if i % homolog_every == 0:
            b = mutate(a, 0.3, rng, cum)
            cut = int(rng.integers(0, max(1, len(b) // 4)))
            b = np.concatenate([b[:cut], b[cut + int(rng.integers(0, 4)):]])
            if len(b) == 0:
                b = a
        else:
            b = rng.choice(20, size=int(rng.integers(1, max_len + 1)),
                           p=back).astype(np.uint8)
        q.append(a)
        t.append(b)
    ql = np.array([len(s) for s in q], np.int32)
    tl = np.array([len(s) for s in t], np.int32)
    params = np.zeros((6, n), np.int32)
    params[0] = np.concatenate(([0], np.cumsum(ql)))[:-1]
    params[1] = ql
    params[2] = np.concatenate(([0], np.cumsum(tl)))[:-1]
    params[3] = tl
    params[4] = -1
    qdata = np.concatenate(q).astype(np.int8)
    qbias = rng.integers(-3, 3, len(qdata)).astype(np.int8)
    return qdata, qbias, np.concatenate(t).astype(np.int8), params


def _reference(qdata, qbias, tdata, params, Lq, Lt, reverse):
    import jax.numpy as jnp
    sub = load_substitution_matrix().sub_int.astype(np.int32)
    out = sw_engine._sw_bucket(
        jnp.asarray(qdata), jnp.asarray(qbias), jnp.asarray(tdata),
        jnp.asarray(sub), jnp.asarray(params), Lq=Lq, Lt=Lt, gap_open=11,
        gap_extend=1, reverse=reverse, kernel="xla")
    return np.stack([np.asarray(x).astype(np.int64) for x in out])


@pytest.mark.parametrize("lanes,max_len,Lq,reverse", [
    (32, 200, 256, False),      # one stripe, R = 8
    (32, 200, 256, True),
    (4, 90, 128, False),        # 4-lane warps: several stripes, carry
    (4, 90, 128, True),
])
def test_emulated_kernel_matches_reference(lanes, max_len, Lq, reverse):
    rng = np.random.default_rng([lanes, max_len, reverse])
    qdata, qbias, tdata, params = _batch(rng, 8, max_len)
    sub = load_substitution_matrix().sub_int
    if reverse:
        # terminate = the forward score, as the search sets it
        params[4] = _reference(qdata, qbias, tdata, params, Lq, Lq,
                               False)[0]
    want = _reference(qdata, qbias, tdata, params, Lq, Lq, reverse)
    got = emulate(qdata, qbias, tdata, sub, params, Lq, Lq, reverse,
                  lanes=lanes)
    np.testing.assert_array_equal(got, want)
    if reverse:
        assert got[3].all()          # every terminate column is found


def test_emulated_kernel_r16_and_ties():
    """A 300-row query takes R = 16 (one stripe); identical copies and
    low-complexity repeats put ties on the column maximum and across
    rows."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 20, 300).astype(np.int8)
    rep = np.tile(np.array([3, 3, 7], np.int8), 60)
    q = [a, rep, a[:40]]
    t = [a, rep[:100], np.concatenate([a[:40], a[:40]])]
    params = np.zeros((6, 3), np.int32)
    params[0] = np.cumsum([0] + [len(s) for s in q])[:-1]
    params[1] = [len(s) for s in q]
    params[2] = np.cumsum([0] + [len(s) for s in t])[:-1]
    params[3] = [len(s) for s in t]
    params[4] = -1
    qdata, tdata = np.concatenate(q), np.concatenate(t)
    qbias = np.zeros(len(qdata), np.int8)
    sub = load_substitution_matrix().sub_int
    want = _reference(qdata, qbias, tdata, params, 384, 384, False)
    got = emulate(qdata, qbias, tdata, sub, params, 384, 384, False)
    np.testing.assert_array_equal(got, want)


def test_carry_shape_covers_multi_stripe_rungs():
    from spacedust_tpu.ops.sw_cuda import STRIPE_ROWS, carry_shape
    assert carry_shape(64, 512, 512) == (1,)
    assert carry_shape(64, 768, 256) == (64, 2, 256, 4)
    # a query of at most 512 rows takes one stripe at R = 8 or 16
    for q in range(1, STRIPE_ROWS + 1):
        n8, n16 = -(-q // 256), -(-q // 512)
        assert (n16 if n16 * 11 <= n8 * 6 else n8) == 1


def test_kernel_choice_and_no_gpu_error():
    import jax.numpy as jnp
    from spacedust_tpu.ops.sw_cuda import sw_scan_gpu
    assert sw_engine.select_kernel() == "xla"          # the CPU backend
    z8 = jnp.zeros(8, jnp.int8)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        sw_scan_gpu(z8, z8, z8, jnp.zeros((21, 21), jnp.int32),
                    jnp.zeros((6, 4), jnp.int32), Lq=256, Lt=256,
                    gap_open=11, gap_extend=1, reverse=False)
    with pytest.raises(ValueError, match="unknown SW kernel"):
        sw_engine.bucket_sw(z8, z8, z8, jnp.zeros((21, 21), jnp.int32),
                            jnp.zeros((6, 4), jnp.int32), Lq=256, Lt=256,
                            gap_open=11, gap_extend=1, reverse=False,
                            kernel="pallas")


def test_library_name_keys_source_compiler_and_target(monkeypatch, tmp_path):
    from spacedust_tpu.ops import sw_cuda

    def fake_run(cmd, **kw):
        class R:
            stdout = f"nvcc release {fake_run.version}"
        return R()

    fake_run.version = "12.4"
    monkeypatch.setattr(sw_cuda.subprocess, "run", fake_run)
    a = sw_cuda.library_path("nvcc")
    fake_run.version = "12.8"
    b = sw_cuda.library_path("nvcc")
    monkeypatch.setattr(sw_cuda, "FLAGS", sw_cuda.FLAGS + ("-G",))
    c = sw_cuda.library_path("nvcc")
    assert len({a, b, c}) == 3
    assert a.parent == sw_cuda._BUILD and "sm_90a" in a.name


def test_dispatch_pads_tail_and_sorts_by_target_length():
    """The engine tail-pads a partial batch with qlen = tlen = 1 pairs
    and returns results by position."""
    rng = np.random.default_rng(3)
    qdata, qbias, tdata, params = _batch(rng, 5, 60)
    sub = load_substitution_matrix().sub_int
    db = sw_engine.DeviceAlignDB(
        qdata.view(np.uint8), qbias, tdata.view(np.uint8), sub)
    assert db.kernel == "xla"
    pos = np.arange(5) + 100
    jobs = [((256, 256), params[0], params[1], params[2], params[3],
             params[4], pos)]
    (got_pos, res), = db.run_buckets(jobs, 11, 1, reverse=False)
    want = _reference(qdata, qbias, tdata, params, 256, 256, False)
    order = np.argsort(got_pos)
    assert sorted(got_pos.tolist()) == pos.tolist()
    for i in range(6):
        np.testing.assert_array_equal(np.asarray(res[i])[order], want[i])
    pad = sw_engine.DeviceAlignDB._pad_params(4, True)
    assert pad[1].tolist() == pad[3].tolist() == [1] * 4
    assert pad[4].tolist() == [-1] * 4 and pad[5].tolist() == [1] * 4


@pytest.mark.gpu
def test_cuda_kernel_matches_reference_on_gpu(gpu_device):
    import jax
    rng = np.random.default_rng(11)
    sub = load_substitution_matrix().sub_int.astype(np.int32)
    for Lq, max_len in ((256, 250), (768, 700)):
        qdata, qbias, tdata, params = _batch(rng, 64, max_len)
        for reverse in (False, True):
            if reverse:
                params[4] = _reference(qdata, qbias, tdata, params, Lq, Lq,
                                       False)[0]
            want = _reference(qdata, qbias, tdata, params, Lq, Lq, reverse)
            args = [jax.device_put(x, gpu_device)
                    for x in (qdata, qbias, tdata, sub, params)]
            got = sw_engine._sw_bucket(*args, Lq=Lq, Lt=Lq, gap_open=11,
                                       gap_extend=1, reverse=reverse,
                                       kernel="cuda")
            np.testing.assert_array_equal(
                np.stack([np.asarray(x) for x in got]), want)


def test_gpu_batch_widths_cover_the_ladder():
    """Every rung has a GPU width; widths are powers of two (so the XLA
    reference's chunking divides them) and the multi-stripe rungs' carry
    buffer stays within 1 GiB."""
    from spacedust_tpu.ops.sw_cuda import carry_shape
    widths = sw_engine._BATCH_FOR_RUNG
    assert set(widths) == set(sw_engine.LADDER)
    for r, B in widths.items():
        assert B & (B - 1) == 0
        assert 4 * np.prod(carry_shape(B, r, r)) <= 1 << 30
    # the CPU backend pads tiny test batches to a small width instead
    assert sw_engine.batch_width(256, 256) == 32


def test_warm_compiles_reverse_prefix_rungs():
    """A reverse batch covers prefixes up to the forward end points, which
    fall into any smaller rung, so warm() compiles every ladder rung up to
    the largest forward one in the reverse direction."""
    sub = load_substitution_matrix().sub_int
    z = np.zeros(64, np.uint8)
    db = sw_engine.DeviceAlignDB(z, z.view(np.int8), z, sub)
    db.warm([384], 11, 1, ladder=(256, 384, 512))
    assert set(db._compiled) == {(384, 384, 11, 1, False),
                                 (256, 256, 11, 1, True),
                                 (384, 384, 11, 1, True)}
