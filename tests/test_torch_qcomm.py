"""The quantized allreduce of the communicator and the group half of
gradient compression, against the JAX package.

``repro_torch``'s ``get_comm(StackedGroup(p, device="cpu")).plan(
"quantized_allreduce", ...)``, ``circulant_qallreduce``,
``compressed_allreduce_tree`` (circulant and ring transports) and
``compressed_grad_sync`` hold the p ranks as the leading axis of every
leaf.  Their oracles are the reference's ``CirculantComm.plan``,
``circulant_qallreduce_body``, ``compressed_allreduce_tree`` and
``compressed_grad_sync``, each run jitted (under ``shard_map`` where it
runs inside one) on a p-device host mesh in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=p`` and
``JAX_PLATFORMS=cpu``, one for each p in {2, 5, 8}, all three started
together, inputs and outputs through a pickle (bf16 as its uint16 bits).

Why jitted: XLA contracts ``cur + q*s`` and ``x - q*s`` into fused
multiply-adds under ``jit``; the port's plain step follows the jitted
form.  Tolerance: none.  Every output is held bit for bit (NaN lanes by
position), in both the port's backends ("torch", and "cuda", whose
wrappers run the plain versions on CPU tensors), and the plan's
``n_blocks``, ``rounds`` and statics must equal the reference's.  Float
inputs are normal or exactly 0: XLA on the CPU flushes denormals.

In-process: the communicator against ``host_plan("quantized_allreduce")``
for one-leaf payloads (bit for bit), the p = 1 identity, the argument
errors, the exact cotangent of ``streamed_sync_params`` (a loss linear in
the parameters gives ``compressed_grad_sync``'s mean and new error bit
for bit) and the completeness of the error feedback.
"""

import contextlib
import fcntl
import os
import pickle
import subprocess
import sys
import tempfile

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.core import collectives as tcoll
from repro_torch.core.comm import StackedGroup, get_comm, host_plan
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.optim import compression as tcomp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PS = (2, 5, 8)
BACKENDS = ("torch", "cuda")
BF16 = ml_dtypes.bfloat16
BLOCK = 256

RUNNER = r'''
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
import ml_dtypes
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core.comm import circulant_qallreduce_body, get_comm
from repro.core.jaxcompat import shard_map
from repro.optim import compression as comp

src, dst = sys.argv[1], sys.argv[2]
with open(src, "rb") as f:
    job = pickle.load(f)
p = job["p"]
mesh = Mesh(np.array(jax.devices()[:p]), ("data",))
comm = get_comm(mesh, "data")


def arr(x, bf16):
    a = jnp.asarray(x.view(ml_dtypes.bfloat16) if bf16 else x)
    return jax.device_put(a, NamedSharding(mesh, P("data")))


def out(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def smap(body, n_in, n_out):
    return jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * n_in,
                             out_specs=(P("data"),) * n_out, check_vma=False))


def run(case):
    names = case["names"]
    xs = [arr(case["leaves"][k], k in case["bf16"]) for k in names]
    kw, call = case["kw"], case["call"]
    if call == "plan":
        payload = dict(zip(names, xs))
        plan = comm.plan("quantized_allreduce", payload, **kw)
        sums, errs = plan(payload)
        meta = {"n_blocks": plan.n_blocks, "rounds": plan.rounds,
                "statics": [dict(kind=s.kind, direction=s.direction, p=s.p,
                                 root=s.root, n=s.n, nslots=s.nslots,
                                 slots=[np.asarray(a) for a in s.slots],
                                 ks=np.asarray(s.ks), shifts=tuple(s.shifts))
                            for s in plan.statics],
                "describe": plan.describe()}
        return [out(sums[k]) for k in names] + [out(errs[k]) for k in names], meta
    L = len(names)
    if call == "body":
        def body(*shards):
            sums, errs = circulant_qallreduce_body(
                [s[0] for s in shards], "data", p, **kw)
            return tuple(v[None] for v in list(sums) + list(errs))
        return [out(v) for v in smap(body, L, 2 * L)(*xs)], {}
    if call == "tree":
        def body(*shards):
            g = {k: s[0] for k, s in zip(names, shards[:L])}
            e = {k: s[0] for k, s in zip(names, shards[L:])}
            red, new_e = comp.compressed_allreduce_tree(g, e, "data", p, **kw)
            return tuple(v[None] for v in [red[k] for k in names]
                         + [new_e[k] for k in names])
        errs = [arr(case["errors"][k], False) for k in names]
        return [out(v) for v in smap(body, 2 * L, 2 * L)(*xs, *errs)], {}
    if call == "gsync":
        spec = comp.make_bucket_spec({k: case["leaves"][k][0] for k in names},
                                     case["bucket_bytes"])
        nb = spec.num_buckets
        second = [arr(case["second"][k], k in case["bf16"]) for k in names]

        def body(*shards):
            g1 = {k: s[0] for k, s in zip(names, shards[:L])}
            g2 = {k: s[0] for k, s in zip(names, shards[L:])}
            e0 = [jnp.zeros((s,), jnp.float32) for s in spec.bucket_sizes]
            m1, e1 = comp.compressed_grad_sync(g1, e0, "data", p, spec, **kw)
            m2, e2 = comp.compressed_grad_sync(g2, e1, "data", p, spec, **kw)
            return tuple(v[None] for v in [m1[k] for k in names] + list(e1)
                         + [m2[k] for k in names] + list(e2))
        return [out(v) for v in smap(body, 2 * L, 2 * (L + nb))(*xs, *second)], \
            {"bucket_sizes": spec.bucket_sizes}
    raise ValueError(call)


results = {case["name"]: run(case) for case in job["cases"]}
with open(dst, "wb") as f:
    pickle.dump(results, f)
'''


def _cases(p):
    """The seeded cases at p: name -> case.  ``leaves`` maps a leaf name
    to a NumPy array with the ranks as its leading axis (bf16 ones, named
    in ``bf16``, as ``ml_dtypes.bfloat16``); ``kw`` are the keyword
    arguments both packages take."""
    rng = np.random.default_rng(3000 + p)
    cases = {}

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def add(name, call, leaves, bf16=(), **extra):
        kw = extra.pop("kw", {})
        cases[name] = dict(name=name, call=call, leaves=leaves,
                           names=sorted(leaves), bf16=tuple(bf16), kw=kw,
                           **extra)

    # adversarial dynamic range (check_compressed_allreduce): per-block
    # magnitudes spanning 12 decades
    mags = 10.0 ** rng.integers(-6, 6, size=(p, 8, 1))
    wide = (rng.normal(size=(p, 8, BLOCK)) * mags).astype(np.float32).reshape(p, -1)
    rag = f32(p, 3 * BLOCK + 17, scale=100.0)
    nan = wide.copy()
    nan[0, BLOCK + 3] = np.nan

    add("plan_tree_q8", "plan", {"w": f32(p, 37, 3), "b": f32(p, 13),
                                 "z": np.zeros((p, 5), np.float32)},
        kw=dict(n_blocks=3, root=p - 1, qblock=8))
    add("plan_auto", "plan", {"g": wide}, kw=dict(root=p // 2))
    add("plan_ragged", "plan", {"g": rag, "h": f32(p, 2, 50)}, kw=dict(qblock=16))
    add("plan_n1", "plan", {"g": f32(p, 40)}, kw=dict(n_blocks=1, qblock=8))
    add("plan_nan_block", "plan", {"g": nan}, kw=dict(n_blocks=2, root=1))
    add("body_two_leaves", "body", {"a": f32(p, 500), "b": f32(p, 77)},
        kw=dict(n_blocks=2, root=1, qblock=8))
    add("body_auto", "body", {"a": wide, "b": rag}, kw={})
    tree = {"w": wide, "r": rag, "t": f32(p, 37).astype(BF16)}
    for transport in ("circulant", "ring"):
        errs = {k: np.zeros(v.shape, np.float32) for k, v in tree.items()}
        add(f"tree_{transport}", "tree", tree, bf16=("t",), errors=errs,
            kw=dict(transport=transport))
        fed = {k: f32(*v.shape, scale=1e-3) for k, v in tree.items()}
        add(f"tree_{transport}_fed_errors", "tree", tree, bf16=("t",),
            errors=fed, kw=dict(transport=transport))
        add(f"tree_{transport}_nan_block", "tree", {"w": nan},
            errors={"w": np.zeros(nan.shape, np.float32)},
            kw=dict(transport=transport))
    add("tree_circulant_q8_n3", "tree", {"w": f32(p, 37, 3), "t": f32(p, 9).astype(BF16)},
        bf16=("t",), errors={"w": np.zeros((p, 37, 3), np.float32),
                             "t": np.zeros((p, 9), np.float32)},
        kw=dict(transport="circulant", n_blocks=3, qblock=8))
    grads = {"emb": f32(p, 64, 24).astype(BF16), "ln": f32(p, 24),
             "pos0": {"wq": f32(p, 2, 24, 24).astype(BF16), "b": f32(p, 2, 24)},
             "head": f32(p, 24, 40)}
    second = {"emb": f32(p, 64, 24).astype(BF16), "ln": f32(p, 24),
              "pos0": {"wq": f32(p, 2, 24, 24).astype(BF16), "b": f32(p, 2, 24)},
              "head": f32(p, 24, 40)}
    flat = {"/".join(k): v for k, v in _walk(grads)}
    flat2 = {"/".join(k): v for k, v in _walk(second)}
    add("gsync_two_steps", "gsync", flat, bf16=("emb", "pos0/wq"),
        second=flat2, bucket_bytes=4 * 2000)
    add("gsync_two_steps_q8", "gsync", flat, bf16=("emb", "pos0/wq"),
        second=flat2, bucket_bytes=4 * 1000, kw=dict(qblock=8, n_blocks=3))
    return cases


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _t(x):
    if x.dtype == BF16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _np(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _same(got, want):
    """Equal bits; NaN lanes by position."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype.kind == "f":
        nan = np.isnan(got)
        if not np.array_equal(nan, np.isnan(want)):
            return False
        got, want = got[~nan], want[~nan]
    width = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
    return np.array_equal(got.view(width[got.dtype.itemsize]),
                          want.view(width[want.dtype.itemsize]))


@contextlib.contextmanager
def _reference_slot():
    """Hold the lock the port's reference-run fixtures share (a file in
    the temporary directory), so that one set of JAX reference processes
    loads the cores at a time when the test files run in parallel."""
    path = os.path.join(tempfile.gettempdir(), "repro_torch_reference_runs.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs for every case at every p: three
    subprocesses, started together -> {p: {name: (leaves, meta)}}."""
    with _reference_slot():
        work = tmp_path_factory.mktemp("qcomm_reference")
        procs = {}
        for p in PS:
            cases = []
            for case in _cases(p).values():
                c = dict(case)
                for key in ("leaves", "second"):
                    if key in c:
                        c[key] = {k: v.view(np.uint16) if v.dtype == BF16 else v
                                  for k, v in c[key].items()}
                cases.append(c)
            src, dst = work / f"in{p}.pkl", work / f"out{p}.pkl"
            with open(src, "wb") as f:
                pickle.dump({"p": p, "cases": cases}, f)
            env = dict(os.environ)
            env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={p}"
            env["JAX_PLATFORMS"] = "cpu"
            env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
            procs[p] = (subprocess.Popen(
                [sys.executable, "-c", RUNNER, str(src), str(dst)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), dst)
        out = {}
        for p, (proc, dst) in procs.items():
            try:
                _, err = proc.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                for q, _ in procs.values():
                    q.kill()
                raise
            assert proc.returncode == 0, f"reference run at p={p} failed:\n{err}"
            with open(dst, "rb") as f:
                out[p] = pickle.load(f)
        return out


def _run_port(case, p, backend):
    """The case through the port -> (output leaves, plan or None)."""
    group = StackedGroup(p, device="cpu")
    names = case["names"]
    xs = [_t(case["leaves"][k]) for k in names]
    kw, call = case["kw"], case["call"]
    if call == "plan":
        payload = dict(zip(names, xs))
        plan = get_comm(group, backend=backend).plan("quantized_allreduce",
                                                     payload, **kw)
        sums, errs = plan(payload)
        return [sums[k] for k in names] + [errs[k] for k in names], plan
    if call == "body":
        sums, errs = tcoll.circulant_qallreduce(group, xs, backend=backend, **kw)
        return list(sums) + list(errs), None
    if call == "tree":
        errors = {k: _t(case["errors"][k]) for k in names}
        red, new_e = tcomp.compressed_allreduce_tree(
            dict(zip(names, xs)), errors, group, backend=backend, **kw)
        return [red[k] for k in names] + [new_e[k] for k in names], None
    if call == "gsync":
        like = {k: torch.empty(case["leaves"][k].shape[1:], device="meta")
                for k in names}
        spec = tcomp.make_bucket_spec(like, case["bucket_bytes"])
        e0 = tcomp.init_grad_sync_state(spec, p, device="cpu")
        m1, e1 = tcomp.compressed_grad_sync(dict(zip(names, xs)), e0, group,
                                            spec, backend=backend, **kw)
        g2 = {k: _t(case["second"][k]) for k in names}
        m2, e2 = tcomp.compressed_grad_sync(g2, e1, group, spec,
                                            backend=backend, **kw)
        return ([m1[k] for k in names] + list(e1) + [m2[k] for k in names]
                + list(e2)), None
    raise ValueError(call)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("p,name", [(p, name) for p in PS for name in _cases(p)])
def test_quantized_paths_match_reference(reference, p, name, backend):
    case = _cases(p)[name]
    want, meta = reference[p][name]
    got, plan = _run_port(case, p, backend)
    assert len(got) == len(want), name
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same(_np(g), w), (name, i, _np(g), w)
    if plan is not None:
        assert (plan.n_blocks, plan.rounds) == (meta["n_blocks"], meta["rounds"])
        assert len(plan.statics) == len(meta["statics"]) == 2
        for s, r in zip(plan.statics, meta["statics"]):
            assert (s.kind, s.direction, s.p, s.root, s.n, s.nslots,
                    tuple(s.shifts)) == (r["kind"], r["direction"], r["p"],
                                         r["root"], r["n"], r["nslots"],
                                         r["shifts"])
            assert all(np.array_equal(a, b) for a, b in zip(s.slots, r["slots"]))
            assert np.array_equal(s.ks, r["ks"])
        # the describe() line names the same plan, the spec in each's terms
        assert plan.describe().split(" spec=")[0] == \
            meta["describe"].split(" spec=")[0].replace("backend=jnp",
                                                        f"backend={backend}")


# -------------------------------------------------------------- in-process


@pytest.mark.parametrize("p,n,qb,size,root", [
    (2, 3, 8, 24 * 3, 1), (5, 4, 8, 100, 2), (8, 2, 16, 33, 7), (37, 5, 256, 1200, 11)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_one_leaf_equals_the_host_plan(p, n, qb, size, root, backend):
    """For a one-leaf payload the communicator's sums and errors are the
    host plan's on the same blocks, bit for bit (the host plan takes the
    blocks zero-padded to n * bs; the communicator pads itself)."""
    rng = np.random.default_rng(p * 100 + n)
    x = torch.from_numpy(rng.normal(size=(p, size)).astype(np.float32))
    plan = get_comm(StackedGroup(p, device="cpu"), backend=backend).plan(
        "quantized_allreduce", [x], n_blocks=n, root=root, qblock=qb)
    (sums,), (errs,) = plan([x])
    bs = -(-(-(-size // n)) // qb) * qb
    vals = torch.zeros((p, n * bs))
    vals[:, :size] = x
    out, err = host_plan("quantized_allreduce", p, n, root=root, qblock=qb,
                         backend=backend, device="cpu").run(vals.view(p, n, bs))
    assert torch.equal(out.reshape(p, -1)[:, :size], sums)
    assert torch.equal(err.reshape(p, -1)[:, :size], errs)
    assert torch.equal(sums, sums[:1].expand_as(sums))


def test_p1_returns_the_payload_and_zero_errors():
    x = {"a": torch.randn(1, 9), "b": torch.randn(1, 3, 2)}
    plan = get_comm(StackedGroup(1, device="cpu"), backend="torch").plan(
        "quantized_allreduce", x, qblock=8)
    sums, errs = plan(x)
    assert sums is x and plan.rounds == 0 and plan.qblock == 8
    assert all(torch.equal(errs[k], torch.zeros_like(x[k])) for k in x)
    sums, errs = tcoll.circulant_qallreduce(StackedGroup(1, device="cpu"),
                                            [x["a"]], backend="torch")
    assert sums[0] is x["a"] and not errs[0].any()


@pytest.mark.parametrize("backend", BACKENDS)
def test_streamed_marker_gives_the_exact_cotangent(backend):
    """A loss linear in the parameters, ``sum_r <out[r], c[r]>``, hands
    each marker exactly ``c`` as its cotangent, so the parameters'
    gradient and the error's are ``compressed_grad_sync(c)``'s mean and
    new error, bit for bit; with accumulated buckets and an accum_scale,
    those of the same sync of ``(acc + c) * scale + err`` by hand."""
    p = 4
    group = StackedGroup(p, device="cpu")
    rng = np.random.default_rng(11)
    params = {"emb": torch.zeros(40, 24, dtype=torch.bfloat16),
              "ln": torch.zeros(24), "pos0": {"w": torch.zeros(3, 24, 24),
                                              "b": torch.zeros(3, 24)}}
    spec = tcomp.make_bucket_spec(params, 4 * 1000)
    assert spec.num_buckets > 2
    leaves, treedef = tree_flatten(params)
    c = tree_unflatten(treedef, [torch.from_numpy(
        rng.normal(size=(p,) + tuple(x.shape)).astype(np.float32)).to(x.dtype)
        for x in leaves])
    errs = tuple(torch.from_numpy(rng.normal(size=(p, s)).astype(np.float32) * 1e-3)
                 for s in spec.bucket_sizes)
    accs = tuple(torch.from_numpy(rng.normal(size=(p, s)).astype(np.float32))
                 for s in spec.bucket_sizes)

    def streamed(acc, scale):
        pin = tree_unflatten(treedef, [x.clone().requires_grad_() for x in leaves])
        ein = tuple(e.clone().requires_grad_() for e in errs)
        out = tcomp.streamed_sync_params(pin, ein, acc, spec, group,
                                         backend=backend, accum_scale=scale)
        loss = sum((o.float() * w.float()).sum() for o, w in
                   zip(tree_flatten(out)[0], tree_flatten(c)[0]))
        got = torch.autograd.grad(loss, tree_flatten(pin)[0] + list(ein))
        return got[:len(leaves)], got[len(leaves):]

    grads, new_errs = streamed(tuple(torch.zeros_like(e) for e in errs), 1.0)
    mean, want_errs = tcomp.compressed_grad_sync(c, errs, group, spec, backend=backend)
    for g, m in zip(grads, tree_flatten(mean)[0]):
        assert g.dtype == m.dtype and torch.equal(g, m[0])
        assert torch.equal(m, m[:1].expand_as(m))
    assert all(torch.equal(g, w) for g, w in zip(new_errs, want_errs))

    grads, new_errs = streamed(accs, 0.5)
    flats = tcomp._bucket_rows(tree_flatten(c)[0], spec)
    want_mean, want_errs = [], []
    for a, f, e in zip(accs, flats, errs):
        (s,), (err,) = tcoll.circulant_qallreduce(group, [(a + f) * 0.5 + e],
                                                  backend=backend)
        want_mean.append(s * tcomp.inv(p))
        want_errs.append(err)
    for x, b, off, n, g in zip(leaves, spec.assignment, spec.offsets,
                               spec.leaf_sizes, grads):
        cast, delta = tcomp._cast_with_delta(want_mean[b][:, off:off + n], x.dtype)
        want_errs[b][:, off:off + n] += delta
        assert torch.equal(g, cast[0].reshape(x.shape))
    assert all(torch.equal(g, w) for g, w in zip(new_errs, want_errs))


def test_error_feedback_is_complete():
    """exact_sum == p * mean + sum_over_ranks(err) to f32 rounding, for
    both transports (check_compressed_allreduce's invariant)."""
    p = 5
    rng = np.random.default_rng(5)
    mags = 10.0 ** rng.integers(-6, 6, size=(p, 8, 1))
    x = torch.from_numpy((rng.normal(size=(p, 8, BLOCK)) * mags)
                         .astype(np.float32).reshape(p, -1))
    for transport in ("circulant", "ring"):
        red, err = tcomp.compressed_allreduce_tree(
            {"w": x}, tcomp.init_error_state({"w": x}), StackedGroup(p, device="cpu"),
            transport=transport, backend="torch")
        exact = x.double().sum(0)
        resid = (red["w"].double() * p + err["w"].double().sum(0) - exact).abs()
        tol = 1e-4 * torch.maximum(exact.abs(), x.double().abs().amax(0) * p) + 1e-6
        assert bool((resid <= tol).all()), transport


@pytest.mark.parametrize("kw,match", [
    ({"overlap": True}, "overlap= is not supported for kind 'quantized_allreduce'"),
    ({"op": "max"}, "quantized_allreduce always sums"),
    ({"qblock": 0}, "qblock must be >= 1"),
])
def test_quantized_plan_argument_errors(kw, match):
    comm = get_comm(StackedGroup(5, device="cpu"), backend="torch")
    with pytest.raises(ValueError, match=match):
        comm.plan("quantized_allreduce", {"g": torch.zeros((5, 512))}, **kw)


def test_quantized_plan_refuses_non_f32_leaves_and_other_kinds_qblock():
    comm = get_comm(StackedGroup(5, device="cpu"), backend="torch")
    with pytest.raises(ValueError, match="requires float32 leaves.*bfloat16"):
        comm.plan("quantized_allreduce", {"g": torch.zeros((5, 8), dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="leading axis == axis size"):
        comm.plan("quantized_allreduce", {"g": torch.zeros((4, 8))})
    with pytest.raises(ValueError, match="qblock= only applies"):
        comm.plan("allreduce", {"g": torch.zeros((5, 8))}, qblock=8)
    with pytest.raises(ValueError, match="unknown transport"):
        tcomp.compressed_allreduce_tree({"g": torch.zeros((5, 8))},
                                        {"g": torch.zeros((5, 8))},
                                        StackedGroup(5, device="cpu"),
                                        transport="tree")


def test_plan_cache_keys_qblock():
    comm = get_comm(StackedGroup(3, device="cpu"), backend="torch")
    x = {"g": torch.zeros((3, 64))}
    a = comm.plan("quantized_allreduce", x, qblock=8)
    assert a is comm.plan("quantized_allreduce", x, qblock=8, n_blocks=a.n_blocks)
    assert a is not comm.plan("quantized_allreduce", x, qblock=16)
    assert "qblock=8" in a.describe() and a.qblock == 8
    assert comm.plan("quantized_allreduce", x).qblock == 256
