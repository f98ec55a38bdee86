"""The port's int8 quantized allreduce against the JAX package.

Held bit for bit, on the same numpy inputs from a seed:

  * ``repro_torch.kernels.quant_ops`` against ``jax.jit`` of
    ``repro.kernels.quant_ops``, and ``fma_f32`` against exact rational
    arithmetic (``fractions.Fraction``);
  * ``block_qacc_shuffle_ref`` (and the wrapper on CPU tensors, which
    takes it) against ``jax.jit(repro.kernels.ref.block_qacc_shuffle_ref)``
    and the Pallas kernel in interpret mode through the jitted
    ``repro.kernels.ops.schedule_qacc_shuffle``;
  * ``host_plan("quantized_allreduce")`` against the reference's
    ``host_plan("quantized_allreduce", backend="jnp"|"pallas")``, over two
    error-feedback steps;
  * the compression half against ``repro.optim.compression``.

Why jitted: XLA contracts ``cur + q*s`` and ``x - q*s`` into fused
multiply-adds (one rounding) under ``jit``, and the reference's host
plan runs its steps jitted.  Eager JAX rounds the product first and
differs from the jitted form on many lanes of the error; the port
follows the jitted form.  Tolerance: exact (bits equal, NaN lanes by
position), except the completeness invariant, which is an f64 sum
against f32 sums with the reference test's own tolerance.  Float inputs
are normal or exactly 0: XLA on the CPU flushes denormals.
"""

import collections
import dataclasses
import fractions

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.comm as jcomm
import repro.kernels.ops as jops
import repro.kernels.quant_ops as jq
import repro.kernels.ref as jref
import repro.optim.compression as jcomp
from repro_torch.core import host_plan
from repro_torch.kernels import block_pack as bp
from repro_torch.kernels import quant_ops as tq
from repro_torch.kernels import ref
from repro_torch.optim import compression as tcomp


def _bits_equal(a, b):
    """Equal bits, NaN lanes compared by position only."""
    a = np.asarray(_np(a) if isinstance(a, torch.Tensor) else a)
    b = np.asarray(_np(b) if isinstance(b, torch.Tensor) else b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    if a.dtype.kind != "f" and a.dtype != ml_dtypes.bfloat16:
        return np.array_equal(a, b)
    nan = np.isnan(a)
    if not np.array_equal(nan, np.isnan(b)):
        return False
    ints = {2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize]
    return np.array_equal(a.view(ints)[~nan], b.view(ints)[~nan])


def _hdr(rng, shape, qb):
    """High dynamic range across quantization blocks (as the reference's
    test_compression): normal values times 10^k, k in [-4, 4] per block."""
    x = rng.standard_normal(shape).astype(np.float32)
    lead = shape[:-1] + (shape[-1] // qb, 1)
    k = rng.integers(-4, 5, size=lead)
    return (x.reshape(lead[:-1] + (qb,)) * 10.0 ** k).astype(np.float32).reshape(shape)


# ------------------------------------------------------------- quant_ops


def _tiles(seed, nb=64, qb=256, specials=True):
    rng = np.random.default_rng(seed)
    x = _hdr(rng, (nb, qb), qb)
    x[3] = 0.0                                   # the 1e-12 scale floor
    x[4, :5] = [-0.0, 0.0, 1e-10, -1e-10, 0.0]   # tiny blocks, floored scale
    x[4, 5:] = 0.0
    if specials:
        x[5, 7] = np.nan
        x[6, 0] = np.inf
        x[7, 1], x[7, 2] = -np.inf, np.nan
    return x


@pytest.mark.parametrize("qb", [8, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_blocks_match_jitted_reference(seed, qb):
    x = _tiles(seed, nb=64, qb=qb)
    jqv, jsv = jax.jit(jq.quant_blocks)(x)
    tqv, tsv = tq.quant_blocks(torch.from_numpy(x))
    assert tqv.dtype == torch.int8 and tsv.dtype == torch.float32
    assert _bits_equal(tqv, np.asarray(jqv)) and _bits_equal(tsv, np.asarray(jsv))
    # the flag: exactly the blocks with a non-finite lane
    flagged = ~np.isfinite(x).all(axis=1, keepdims=True)
    assert np.array_equal(tq.block_nonfinite(tsv).numpy(), flagged)
    assert np.array_equal(np.asarray(jq.block_nonfinite(jsv)), flagged)
    assert float(tsv[3, 0]) == np.float32(tq.SCALE_FLOOR)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dequant_and_error_match_jitted_reference(seed):
    x = _tiles(seed)
    q, s = jax.jit(jq.quant_blocks)(x)
    q, s = np.array(q), np.array(s)
    tqv, tsv = torch.from_numpy(q), torch.from_numpy(s)
    assert _bits_equal(tq.dequant_blocks(tqv, tsv),
                       np.asarray(jax.jit(jq.dequant_blocks)(q, s)))
    jerr = np.asarray(jax.jit(jq.quant_error)(x, q, s))
    terr = tq.quant_error(torch.from_numpy(x), tqv, tsv)
    assert _bits_equal(terr, jerr)
    assert np.isfinite(terr.numpy()).all()
    assert (terr.numpy()[~np.isfinite(s).ravel()] == 0).all()
    # The eager (unfused) form rounds q*s first and differs: the port
    # follows the jitted one on purpose.
    eager = np.asarray(jq.quant_error(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(s)))
    assert not _bits_equal(terr, eager)


def _f32_round(exact: fractions.Fraction) -> np.float32:
    """The f32 nearest ``exact``, ties to even, by exact comparison."""
    c = np.float32(float(exact))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        d = abs(fractions.Fraction(float(cand)) - exact)
        key = (d, int(np.float32(cand).view(np.uint32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return np.float32(best[1])


def _fma_exact(a, q, s, sign):
    exact = (fractions.Fraction(float(a))
             + sign * int(q) * fractions.Fraction(float(s)))
    if exact == 0:
        # IEEE: an exact zero sum is -0 only when both terms are -0
        prod_neg = int(q) == 0 and (sign < 0) != bool(np.signbit(s))
        both_neg = a == 0 and np.signbit(a) and prod_neg
        return np.float32(-0.0) if both_neg else np.float32(0.0)
    return _f32_round(exact)


def _double_rounding_cases():
    """(a, q, s, sign) where f32(f64(a) + f64(q*s)) rounds twice and
    misses the correctly rounded result: for each a and q, s is the f32
    nearest to (half an f32 ulp of a, plus a quarter of an f64 ulp) / q,
    so that the exact sum sits just off an f32 midpoint, closer than
    f64 can resolve."""
    cases = []
    for a in (1.0, 1.5, -3.0, 1000.25, 0.0078125, -65536.0):
        a = np.float32(a)
        u32 = float(np.spacing(np.abs(a)))
        u64 = float(np.spacing(np.float64(np.abs(a))))
        for off in (u64 / 4, -u64 / 4):
            target = fractions.Fraction(u32 / 2) + fractions.Fraction(off)
            for q in range(-127, 128):
                if q == 0:
                    continue
                for sign in (1, -1):
                    s = np.float32(float(target / (sign * q)))
                    twice = np.float32(np.float64(a) + sign * np.float64(q)
                                       * np.float64(s))
                    if twice != _fma_exact(a, q, s, sign):
                        cases.append((a, q, s, sign))
    return cases


def test_fma_f32_is_correctly_rounded_where_f64_rounds_twice():
    cases = _double_rounding_cases()
    assert len(cases) >= 50, len(cases)
    a, q, s, sign = (np.array(c, dtype=d) for c, d in zip(
        zip(*cases), (np.float32, np.int8, np.float32, np.int64)))
    for sg in (1, -1):
        pick = sign == sg
        got = tq.fma_f32(torch.from_numpy(a[pick]), torch.from_numpy(q[pick]),
                         torch.from_numpy(s[pick]), sg).numpy()
        want = np.array([_fma_exact(*c) for c in zip(a[pick], q[pick], s[pick],
                                                      sign[pick])], np.float32)
        assert _bits_equal(got, want)
        naive = (a[pick].astype(np.float64) + sg * q[pick].astype(np.float64)
                 * s[pick].astype(np.float64)).astype(np.float32)
        assert not _bits_equal(naive, want)     # the cases are real


@pytest.mark.parametrize("seed", [0, 1])
def test_fma_f32_matches_exact_arithmetic_on_random_inputs(seed):
    rng = np.random.default_rng(seed)
    m = 2000
    a = (rng.standard_normal(m) * 10.0 ** rng.integers(-6, 7, m)).astype(np.float32)
    q = rng.integers(-127, 128, m).astype(np.int8)
    s = (np.abs(rng.standard_normal(m)) * 10.0 ** rng.integers(-8, 5, m)).astype(np.float32)
    a[:20], q[20:40] = 0.0, 0                    # exact zeros and zero products
    a[40:60] = -(q[40:60].astype(np.float32) * s[40:60])   # cancellations
    for sign in (1, -1):
        got = tq.fma_f32(torch.from_numpy(a), torch.from_numpy(q),
                         torch.from_numpy(s), sign).numpy()
        want = np.array([_fma_exact(*c, sign) for c in zip(a, q, s)], np.float32)
        assert _bits_equal(got, want)


def test_fma_f32_passes_non_finite_through():
    a = torch.tensor([np.inf, 1.0, np.nan, 3e38], dtype=torch.float32)
    q = torch.tensor([1, 1, 1, 127], dtype=torch.int8)
    s = torch.tensor([1.0, np.nan, 1.0, 3e38], dtype=torch.float32)
    got = tq.fma_f32(a, q, s).numpy()
    assert got[0] == np.inf and np.isnan(got[1]) and np.isnan(got[2])
    assert got[3] == np.inf                      # overflow rounds to inf


# ----------------------------------------------------- qacc_shuffle step


def _qacc_operands(seed, R, S, qb, nbk):
    rng = np.random.default_rng(seed)
    bs = qb * nbk
    buf = _hdr(rng, (R, S, bs), qb)
    err = (rng.standard_normal((R, S, bs)) * 1e-3).astype(np.float32)
    q, s = jax.jit(jq.quant_blocks)(_hdr(rng, (R * nbk, qb), qb))
    q = np.array(q).reshape(R, bs)
    s = np.array(s).reshape(R, nbk)
    acc = rng.integers(0, S, R).astype(np.int32)
    fwd = rng.integers(0, S, R).astype(np.int32)
    fwd[::3] = acc[::3]                          # coincident rows
    buf[0, :, :qb] = 0.0                         # a zero block: the scale floor
    buf[1, fwd[1], bs - 2] = np.nan              # a non-finite capture
    buf[R - 1, fwd[R - 1], 2] = np.inf
    s[2, 0] = np.nan                             # an incoming flagged block
    return buf, err, q, s, acc, fwd


SHAPES = [(5, 4, 8, 3), (9, 6, 8, 4), (7, 3, 256, 2), (4, 5, 256, 1)]


@pytest.mark.parametrize("R,S,qb,nbk", SHAPES)
def test_qacc_shuffle_matches_jitted_oracle_and_pallas(R, S, qb, nbk):
    buf, err, q, s, acc, fwd = _qacc_operands(R * 100 + qb, R, S, qb, nbk)
    want_j = jax.jit(jref.block_qacc_shuffle_ref)(buf, err, q, s, acc, fwd)
    want_p = jops.schedule_qacc_shuffle(buf, err, q, s, acc, fwd,
                                        interpret=True)
    tb, te = torch.from_numpy(buf.copy()), torch.from_numpy(err.copy())
    args = (torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(acc),
            torch.from_numpy(fwd))
    got = ref.block_qacc_shuffle_ref(tb, te, *args)
    assert got[0] is tb and got[1] is te
    for g, wj, wp in zip(got, want_j, want_p):
        assert _bits_equal(g, np.asarray(wj))
        assert _bits_equal(g, np.asarray(wp))
    # the wrapper on CPU tensors takes the plain version, counting nothing
    before = dict(bp.LAUNCHES)
    wb, we = torch.from_numpy(buf.copy()), torch.from_numpy(err.copy())
    w = bp.block_qacc_shuffle(wb, we, *args)
    assert bp.LAUNCHES == before and w[0] is wb and w[1] is we
    for g, k in zip(got, w):
        assert _bits_equal(g, k)


def test_qacc_shuffle_coincident_row_drains_and_captures_the_sum():
    buf, err, q, s, acc, fwd = _qacc_operands(7, 3, 4, 8, 2)
    fwd[:] = acc
    tb = torch.from_numpy(buf.copy())
    te = torch.from_numpy(err.copy())
    tb, te, oq, os_ = ref.block_qacc_shuffle_ref(
        tb, te, torch.from_numpy(q), torch.from_numpy(s),
        torch.from_numpy(acc), torch.from_numpy(fwd))
    rows = np.arange(3)
    assert (tb.numpy()[rows, acc] == 0).all()
    comb = tq.fma_f32(torch.from_numpy(buf[rows, acc]).view(3, 2, 8),
                      torch.from_numpy(q).view(3, 2, 8),
                      torch.from_numpy(s).view(3, 2, 1)).view(3 * 2, 8)
    q2, s2 = tq.quant_blocks(comb)
    assert _bits_equal(oq, q2.view(3, 16)) and _bits_equal(os_, s2.view(3, 2))


def test_qacc_shuffle_rejects_bad_operands():
    buf = torch.zeros((3, 4, 16))
    err = torch.zeros((3, 4, 16))
    q = torch.zeros((3, 16), dtype=torch.int8)
    s = torch.zeros((3, 2))
    i = torch.zeros(3, dtype=torch.int32)
    bp.block_qacc_shuffle(buf, err, q, s, i, i)
    with pytest.raises(TypeError):
        bp.block_qacc_shuffle(buf.double(), err.double(), q, s, i, i)
    with pytest.raises(ValueError):
        bp.block_qacc_shuffle(buf, err, q.float(), s, i, i)
    with pytest.raises(ValueError):                # nb does not divide bs
        bp.block_qacc_shuffle(buf, err, q, torch.zeros((3, 3)), i, i)
    with pytest.raises(ValueError):
        bp.block_qacc_shuffle(buf, err[:, :3].contiguous(), q, s, i, i)
    with pytest.raises(ValueError):
        bp.block_qacc_shuffle(buf, buf, q, s, i, i)
    with pytest.raises(TypeError):
        bp.block_qacc_shuffle(buf, err, q, s, i.long(), i)


# -------------------------------------------------------- the host plan

GRID = [(p, n, root) for p in (2, 3, 5, 8, 11, 36) for n in (1, 2, 4)
        for root in sorted({0, 1, p - 1})]
QB = 8


def _values(p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(p, n, 3 * QB))
            * 10.0 ** rng.integers(-4, 5, size=(p, n, 1))).astype(np.float32)


def _check_complete(vals, out, err, p):
    exact = vals.astype(np.float64).sum(0)
    recon = out[0].astype(np.float64) + err.astype(np.float64).sum(0)
    tol = 1e-4 * np.maximum(np.abs(exact), np.abs(vals).max(0) * p) + 1e-7
    assert (np.abs(recon - exact) <= tol).all()


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("p,n,root", GRID)
def test_host_plan_matches_reference_over_two_feedback_steps(p, n, root,
                                                             backend):
    jplan = jcomm.host_plan("quantized_allreduce", p, n, root=root,
                            backend=backend, qblock=QB)
    tplan = host_plan("quantized_allreduce", p, n, root=root, qblock=QB,
                      backend="torch", device="cpu")
    g1, g2 = _values(p, n, 100 * p + 10 * n + root), _values(p, n, 7 + p)
    jout, jerr = jplan.run(g1)
    tout, terr = tplan.run(g1)
    assert tuple(tout.shape) == (p, n, 3 * QB) and tout.dtype == torch.float32
    assert _bits_equal(tout, jout) and _bits_equal(terr, jerr)
    for r in range(1, p):
        assert _bits_equal(tout[r], tout[0])
    _check_complete(g1, tout.numpy(), terr.numpy(), p)
    # second step: the first step's error state fed back (the JAX run's
    # own numpy error, so both sides see the same input)
    g2 = (g2 + np.asarray(jerr)).astype(np.float32)
    jout2, jerr2 = jplan.run(g2)
    tout2, terr2 = tplan.run(g2)
    assert _bits_equal(tout2, jout2) and _bits_equal(terr2, jerr2)
    _check_complete(g2, tout2.numpy(), terr2.numpy(), p)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_host_plan_nonfinite_matches_reference(backend):
    p, n = 5, 2
    vals = _values(p, n, 3)
    vals[1, 0, QB + 2] = np.nan
    vals[0, 1, 2 * QB] = np.inf
    jout, jerr = jcomm.host_plan("quantized_allreduce", p, n, root=2,
                                 backend=backend, qblock=QB).run(vals)
    tout, terr = host_plan("quantized_allreduce", p, n, root=2, qblock=QB,
                           backend="torch", device="cpu").run(vals)
    assert _bits_equal(tout, jout) and _bits_equal(terr, jerr)
    assert np.isfinite(terr.numpy()).all()
    for r in range(p):
        assert np.isnan(tout[r, 0, QB:2 * QB].numpy()).all()
        assert np.isnan(tout[r, 1, 2 * QB:].numpy()).all()
        assert np.isfinite(tout[r, 0, :QB].numpy()).all()


def test_host_plan_at_the_default_qblock_matches_reference():
    p, n, root = 11, 3, 4
    rng = np.random.default_rng(5)
    vals = _hdr(rng, (p, n, 512), 256)
    jout, jerr = jcomm.host_plan("quantized_allreduce", p, n, root=root,
                                 backend="jnp").run(vals)
    plan = host_plan("quantized_allreduce", p, n, root=root, backend="torch",
                     device="cpu")
    assert plan.qblock == 256
    tout, terr = plan.run(torch.from_numpy(vals))
    assert _bits_equal(tout, jout) and _bits_equal(terr, jerr)


def test_host_plan_statics_are_the_reference_phases():
    p, n, root = 11, 4, 3
    plan = host_plan("quantized_allreduce", p, n, root=root, qblock=QB,
                     device="cpu")
    jplan = jcomm.host_plan("quantized_allreduce", p, n, root=root,
                            qblock=QB)
    red, bc = plan.statics
    assert (red.kind, bc.kind) == ("reduce", "broadcast")
    for mine, theirs in zip(plan.slots, jplan.slots):
        assert np.array_equal(mine, theirs)
    assert plan.skips == jplan.skips
    assert red.slots[0] is plan.slots[0] and bc.slots[0] is plan.slots[2]
    fwd, acc, recv, send = plan.device_slots
    assert np.array_equal(fwd.numpy()[:-1], plan.slots[0])
    assert (fwd.numpy()[-1] == n).all()
    assert np.array_equal(recv.numpy(), plan.slots[2])


def test_p1_returns_the_values_and_zero_error():
    vals = _values(1, 3, 0)
    plan = host_plan("quantized_allreduce", 1, 3, qblock=QB, device="cpu")
    out, err = plan.run(vals)
    assert np.array_equal(out.numpy(), vals) and (err.numpy() == 0).all()
    # the reference's host plan divides by zero here; its device plan
    # returns (values, zeros), which the port follows
    with pytest.raises(ZeroDivisionError):
        jcomm.host_plan("quantized_allreduce", 1, 3, qblock=QB).run(vals)


def test_cuda_backend_on_cpu_runs_the_plain_step():
    vals = _values(5, 2, 1)
    a = host_plan("quantized_allreduce", 5, 2, root=1, qblock=QB,
                  backend="cuda", device="cpu")
    b = host_plan("quantized_allreduce", 5, 2, root=1, qblock=QB,
                  backend="torch", device="cpu")
    assert a.step.backend == "cuda" and a is not b
    for x, y in zip(a.run(vals), b.run(vals)):
        assert _bits_equal(x, y)


# ------------------------------------------------- the compression half


def _grads(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(dtype)

    # insertion order deliberately not sorted: JAX flattens dicts sorted
    return {
        "wq": leaf(6, 40),
        "bias": leaf(40),
        "layers": [{"z": leaf(3, 5), "a": leaf(7)}, (leaf(2, 2), None)],
        "emb": leaf(300),
        "od": collections.OrderedDict(y=leaf(4), x=leaf(9)),
    }


def _to_torch(tree):
    """The same tree of torch tensors, containers and insertion order
    kept (``jax.tree.map`` would rebuild the dicts sorted)."""
    if isinstance(tree, dict):
        return type(tree)((k, _to_torch(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    if tree is None:
        return None
    x = np.asarray(tree)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("bucket_bytes", [64, 800, 1200, 4 << 20])
def test_bucket_spec_and_flatten_order_match_reference(bucket_bytes):
    tree = _grads(0)
    assert list(tree) != sorted(tree)
    assert list(_to_torch(tree)) == list(tree)
    spec = tcomp.make_bucket_spec(_to_torch(tree), bucket_bytes)
    jspec = jcomp.make_bucket_spec(tree, bucket_bytes)
    assert dataclasses.astuple(spec) == dataclasses.astuple(jspec)
    tleaves, _ = tcomp.tree_flatten(_to_torch(tree))
    jleaves = jax.tree.leaves(tree)
    assert [x.shape for x in jleaves] == [tuple(x.shape) for x in tleaves]
    for t, j in zip(tleaves, jleaves):
        assert np.array_equal(t.numpy(), j)
    tb = tcomp.bucketize(_to_torch(tree), spec)
    jb = jcomp.bucketize(jax.tree.map(jnp.asarray, tree), spec)
    assert len(tb) == len(jb) == spec.num_buckets
    for t, j in zip(tb, jb):
        assert _bits_equal(t, np.asarray(j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_unbucketize_and_cast_with_delta_match_reference(dtype):
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    like = _grads(1, npdt)
    spec = jcomp.make_bucket_spec(like, 1200)
    rng = np.random.default_rng(2)
    flats = [rng.standard_normal(s).astype(np.float32) * 3
             for s in spec.bucket_sizes]
    flats[0][5] = np.nan                         # a non-finite delta is 0
    jtree, jd = jcomp.unbucketize([jnp.asarray(f) for f in flats], spec,
                                  jax.tree.map(jnp.asarray, like))
    ttree, td = tcomp.unbucketize([torch.from_numpy(f) for f in flats], spec,
                                  _to_torch(like))
    for t, j in zip(tcomp.tree_flatten(ttree)[0], jax.tree.leaves(jtree)):
        assert _bits_equal(_np(t), np.asarray(j))
    for t, j in zip(td, jd):
        assert _bits_equal(t, np.asarray(j))
    assert ttree["layers"][1][1] is None
    red = torch.from_numpy(flats[0])
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16),
                     (torch.float32, jnp.float32)):
        tc, tdl = tcomp._cast_with_delta(red, tdt)
        jc, jdl = jcomp._cast_with_delta(jnp.asarray(flats[0]), jdt)
        assert _bits_equal(_np(tc), np.asarray(jc)) and _bits_equal(tdl, np.asarray(jdl))


def test_quantize_int8_and_error_state_match_reference():
    rng = np.random.default_rng(4)
    x = _hdr(rng, (4 * tcomp.BLOCK,), tcomp.BLOCK)
    x[3] = np.nan
    jqv, jsv = jax.jit(jcomp.quantize_int8)(x)
    tqv, tsv = tcomp.quantize_int8(torch.from_numpy(x))
    assert _bits_equal(tqv, np.asarray(jqv)) and _bits_equal(tsv, np.asarray(jsv))
    assert _bits_equal(tcomp.dequantize_int8(tqv, tsv),
                       np.asarray(jax.jit(jcomp.dequantize_int8)(jqv, jsv)))
    assert np.array_equal(tcomp.block_nonfinite(tsv).numpy(),
                          np.asarray(jcomp.block_nonfinite(jsv)))
    tree = _grads(3, ml_dtypes.bfloat16)
    terr = tcomp.init_error_state(_to_torch(tree))
    jerr = jcomp.init_error_state(jax.tree.map(jnp.asarray, tree))
    for t, j in zip(tcomp.tree_flatten(terr)[0], jax.tree.leaves(jerr)):
        assert t.dtype == torch.float32 and _bits_equal(t, np.asarray(j))
    spec = jcomp.make_bucket_spec(tree, 800)
    tstate = tcomp.init_grad_sync_state(spec, 3, device="cpu")
    jstate = jcomp.init_grad_sync_state(spec, 3)
    assert [tuple(t.shape) for t in tstate] == [j.shape for j in jstate]
    assert all((t == 0).all() and t.dtype == torch.float32 for t in tstate)


def test_bucket_through_the_quantized_allreduce_completes():
    """A bucket built as the trainer builds it rides one quantized
    allreduce; sums plus errors give back the exact sum."""
    p, qb = 5, 8
    trees = [_to_torch(_grads(10 + r)) for r in range(p)]
    spec = tcomp.make_bucket_spec(trees[0], 4 << 20)
    (size,) = spec.bucket_sizes
    n = 4
    bs = -(-size // (n * qb)) * qb
    vals = torch.zeros((p, n * bs))
    for r, t in enumerate(trees):
        vals[r, :size] = tcomp.bucketize(t, spec)[0]
    out, err = host_plan("quantized_allreduce", p, n, root=3, qblock=qb,
                         device="cpu").run(vals.view(p, n, bs))
    _check_complete(vals.view(p, n, bs).numpy(), out.numpy(), err.numpy(), p)
    mean, deltas = tcomp.unbucketize([out[0].reshape(-1)[:size] / p], spec,
                                     trees[0])
    assert tcomp.tree_flatten(mean)[0][0].shape == (40,)   # "bias" sorts first
    assert (deltas[0] == 0).all()
