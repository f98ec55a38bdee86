"""The model kernels' plain versions, held against the JAX package's
Pallas kernels and oracles.

On the CPU the port's :func:`~repro_torch.kernels.flash_attention.flash_attention`
and :func:`~repro_torch.kernels.ssd_scan.ssd_scan` run their plain
versions (the CUDA kernels are held against those on the card, in
``tests/test_torch_cuda.py``).  Here they meet the reference's Pallas
kernels, run in interpret mode as ``tests/test_kernels.py`` runs them
(``ops.gqa_flash_attention``, ``ops.mamba2_ssd`` and ``ssd_scan``), and
the reference's naive oracles ``ref.attention_ref`` and ``ref.ssd_ref``,
which the port's own ``kernels.ref`` copies are held against too.
Shapes: ``test_kernels.py``'s, plus zamba2's head width of 80, a sliding
window and two SSM groups.  Inputs are numpy arrays from a seed.

Tolerances, as ``tests/test_kernels.py``: attention 2e-5 in f32 and
2e-2 in bf16 (one rounding of the output to bf16, taken at other places),
the scan 1e-4 (f32 sums in another order over up to 70 steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import gqa_flash_attention, mamba2_ssd
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.flash_attention import LAUNCHES as FA_LAUNCHES
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import LAUNCHES as SSD_LAUNCHES
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.convert import to_tensor

RNG = np.random.default_rng(42)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's intra-op threads, and the
    other test files of a parallel run share the cores with this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(dtype):
    return 2e-2 if dtype == jnp.bfloat16 else 2e-5


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _heads_first(t):
    """[B, S, H, d] -> [B*H, S, d] (the Pallas kernel's layout)."""
    B, S, H, d = t.shape
    return t.transpose(0, 2, 1, 3).reshape(B * H, S, d)


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,bq,bk,window", [
    (1, 64, 4, 4, 32, 32, 32, None),      # MHA
    (2, 100, 4, 2, 32, 32, 32, None),     # GQA, ragged seq
    (1, 128, 8, 2, 16, 64, 32, None),     # rep=4
    (2, 37, 2, 1, 64, 16, 16, None),      # odd seq
    (1, 90, 4, 2, 80, 32, 32, None),      # zamba2 / h2o-danube head width
    (1, 96, 2, 2, 80, 32, 16, 33),        # sliding window, hd 80
    (1, 64, 4, 2, 160, 32, 32, None),     # stablelm-12b's head width
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(dtype, B, S, H, Hkv, hd, bq, bk,
                                              window, causal):
    q = np.asarray(RNG.normal(size=(B, S, H, hd)), np.float32)
    k = np.asarray(RNG.normal(size=(B, S, Hkv, hd)), np.float32)
    v = np.asarray(RNG.normal(size=(B, S, Hkv, hd)), np.float32)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    want = gqa_flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=bq, block_k=bk, interpret=True)
    before = FA_LAUNCHES["flash_attention"]
    got = flash_attention(_t(jq), _t(jk), _t(jv), causal=causal, window=window)
    assert FA_LAUNCHES["flash_attention"] == before      # CPU: no kernel launch
    assert got.dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype), rtol=_tol(dtype))
    # and both against the naive oracle, the port's copy against the reference's
    rep = H // Hkv
    qf, kf, vf = (_heads_first(np.repeat(a, r, axis=2)) for a, r in
                  ((_np(jq), 1), (_np(jk), rep), (_np(jv), rep)))
    oracle = jref.attention_ref(jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf),
                                causal=causal, window=window)
    port_oracle = ref.attention_ref(_t(qf), _t(kf), _t(vf), causal=causal, window=window)
    np.testing.assert_allclose(_np(port_oracle), _np(oracle), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_heads_first(_np(got)), _np(oracle),
                               atol=_tol(dtype), rtol=_tol(dtype))


def test_flash_attention_rejects_bad_operands():
    q = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 2, 16)))
    with pytest.raises(TypeError, match="share"):
        flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)
    # the widest v head is 160 (stablelm-12b's), on every device
    with pytest.raises(ValueError, match="hd_v 161 > 160"):
        flash_attention(q, q, torch.zeros((1, 8, 3, 161)))


# -------------------------------------------------------------- ssd scan


def _ssd_inputs(B, S, H, P, G, N):
    return (RNG.normal(size=(B, S, H, P)).astype(np.float32),
            RNG.normal(size=(B, S, G, N)).astype(np.float32),
            RNG.normal(size=(B, S, G, N)).astype(np.float32),
            RNG.uniform(0.01, 0.2, size=(B, S, H)).astype(np.float32),
            np.log(RNG.uniform(0.5, 2, size=(H,))).astype(np.float32),
            RNG.normal(size=(H,)).astype(np.float32))


@pytest.mark.parametrize("BH,S,P,N,chunk",
                         [(2, 64, 8, 4, 16), (3, 70, 16, 8, 32), (1, 17, 4, 2, 8)])
def test_ssd_scan_plain_matches_pallas_kernel(BH, S, P, N, chunk):
    """test_kernels.py's shapes in the kernel's [BH, S, ...] layout: the
    port's scan takes them as one batch row of BH heads, one group each."""
    x, B_, C_, dt, A_log, D = _ssd_inputs(1, S, BH, P, BH, N)
    rows = [np.ascontiguousarray(a[0].swapaxes(0, 1)) for a in (x, B_, C_, dt)]
    want = pallas_ssd_scan(*map(jnp.asarray, rows), jnp.asarray(A_log),
                           jnp.asarray(D), chunk=chunk, interpret=True)
    before = SSD_LAUNCHES["ssd_scan"]
    got = ssd_scan(*map(torch.from_numpy, (x, B_, C_, dt, A_log, D)), chunk=chunk)
    assert SSD_LAUNCHES["ssd_scan"] == before             # CPU: no kernel launch
    got_rows = got[0].transpose(0, 1).numpy()
    np.testing.assert_allclose(got_rows, _np(want), atol=1e-4, rtol=1e-4)
    oracle = jref.ssd_ref(*map(jnp.asarray, rows), jnp.asarray(A_log), jnp.asarray(D))
    port_oracle = ref.ssd_ref(*map(torch.from_numpy, rows), torch.from_numpy(A_log),
                              torch.from_numpy(D))
    np.testing.assert_allclose(port_oracle.numpy(), _np(oracle), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_rows, _np(oracle), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 48, 4, 8, 2, 4, 16),      # test_kernels.py's wrapper case, G 2
    (1, 70, 6, 8, 3, 4, 32),      # G 3, ragged last chunk
    (2, 33, 2, 64, 1, 16, 256),   # zamba2's head, chunk > S
])
def test_ssd_scan_plain_matches_mamba2_ssd(B, S, H, P, G, N, chunk):
    ins = _ssd_inputs(B, S, H, P, G, N)
    want = mamba2_ssd(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
    got = ssd_scan(*map(torch.from_numpy, ins), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-4)


def test_ssd_scan_rejects_bad_operands():
    x, B_, C_, dt, A_log, D = map(torch.from_numpy, _ssd_inputs(1, 8, 4, 4, 2, 3))
    with pytest.raises(ValueError, match="groups"):
        ssd_scan(x, B_[:, :, :1].repeat(1, 1, 3, 1), C_[:, :, :1].repeat(1, 1, 3, 1),
                 dt, A_log, D)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x.double(), B_, C_, dt, A_log, D)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, B_, C_, dt, A_log, D, chunk=0)
    with pytest.raises(ValueError, match="dt"):
        ssd_scan(x, B_, C_, dt[:, :4], A_log, D)


# ------------------------------------------- the scan's phases, plain


def _ssd_chunked_unsplit(x, B_, C_, dt, A_log, D, chunk):
    """The plain scan as one function, before it was split into the
    CUDA kernel's three phases: the split must give the same bits."""
    import torch.nn.functional as F

    Bsz, S, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    A = -torch.exp(A_log)
    xc = x.reshape(Bsz, nc, Q, H, Pd)
    Bc = B_.reshape(Bsz, nc, Q, G, N)
    Cc = C_.reshape(Bsz, nc, Q, G, N)
    dtc = dt.reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(dtc * A, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    ii = torch.arange(Q)
    tri = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    seg = torch.where(tri, seg, 0.0)
    Lmat = torch.where(tri, torch.exp(seg), 0.0)
    Bh = Bc.repeat_interleave(rep, dim=3)
    Ch = Cc.repeat_interleave(rep, dim=3)
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    w = cb * Lmat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    sloc = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", decay_to_end * dtc, Bh, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])
    s = torch.zeros((Bsz, H, N, Pd), dtype=x.dtype)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + sloc[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Ch, s_prevs) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, Pd)
    y = y + x.reshape(Bsz, nc * Q, H, Pd) * D[None, None, :, None]
    return y[:, :S] if pad else y


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 64, 2, 8, 1, 4, 16),      # whole chunks
    (1, 70, 4, 16, 2, 8, 32),     # G 2, ragged last chunk
    (1, 17, 1, 4, 1, 2, 8),       # tiny, odd
    (2, 33, 2, 64, 1, 16, 256),   # chunk > S
    (1, 300, 4, 64, 1, 64, 128),  # zamba2's widths, ragged
])
def test_ssd_phases_compose_to_the_unsplit_scan_bit_for_bit(B, S, H, P, G, N, chunk):
    ins = tuple(map(torch.from_numpy, _ssd_inputs(B, S, H, P, G, N)))
    want = _ssd_chunked_unsplit(*ins, chunk)
    x, B_, C_, dt, A_log, D = ins
    cum, sloc = ss.ssd_chunk_states(x, B_, dt, A_log, chunk)
    s_prev = ss.ssd_state_pass(cum, sloc)
    got = ss.ssd_chunk_outputs(x, B_, C_, dt, D, cum, s_prev, chunk)
    assert torch.equal(got, want)
    assert torch.equal(ss.ssd_chunked(*ins, chunk), want)


@pytest.mark.parametrize("S,chunk", [(70, 16), (64, 16), (23, 8), (9, 32)])
def test_ssd_states_entering_each_chunk_match_the_f64_recurrence(S, chunk):
    """The state entering chunk c is h at position c*Q - 1 of the
    sequential recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, run
    in float64 numpy (G 2, so heads 0-1 read group 0 and heads 2-3 group 1);
    ``sloc`` of a chunk is the same recurrence from a zero start."""
    Bsz, H, P, G, N = 2, 4, 8, 2, 6
    x, B_, C_, dt, A_log, D = _ssd_inputs(Bsz, S, H, P, G, N)
    cum, sloc = ss.ssd_chunk_states(*map(torch.from_numpy, (x, B_, dt, A_log)), chunk)
    s_prev = ss.ssd_state_pass(cum, sloc).numpy()
    Q = min(chunk, S)
    nc = -(-S // Q)
    assert s_prev.shape == sloc.shape == (Bsz, nc, H, N, P)
    A = -np.exp(A_log.astype(np.float64))
    Bh = np.repeat(B_.astype(np.float64), H // G, axis=2)        # [B, S, H, N]
    h = np.zeros((Bsz, H, N, P))
    want_prev, want_loc = [], []
    for c in range(nc):
        want_prev.append(h.copy())
        loc = np.zeros_like(h)
        for t in range(c * Q, min(S, (c + 1) * Q)):
            decay = np.exp(dt[:, t].astype(np.float64) * A)[:, :, None, None]
            inc = (dt[:, t, :, None, None] * Bh[:, t, :, :, None]
                   * x[:, t, :, None, :].astype(np.float64))
            h = decay * h + inc
            loc = decay * loc + inc
        want_loc.append(loc)
    np.testing.assert_allclose(s_prev, np.stack(want_prev, 1), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(sloc.numpy(), np.stack(want_loc, 1), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cum.numpy()[:, -1, -1],
                               (dt[:, (nc - 1) * Q:].astype(np.float64) * A).sum(1),
                               atol=1e-5, rtol=1e-5)
