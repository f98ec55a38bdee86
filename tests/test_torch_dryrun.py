"""The port's dry run and its op-level cost counter, against the JAX
package's (``repro.launch.dryrun`` and ``hlo_analysis``).

FLOPs: ``repro_torch.launch.op_analysis.weighted_cost`` of the port's
plain ``forward`` and ``decode_step`` on ``meta`` tensors equals, to the
FLOP, the reference's ``hlo_analysis.weighted_cost`` of its compiled
jitted function on the CPU (the compiled text: the uncompiled lowering
counts no dot) at SMOKE, for the dense, hybrid, moe, MLA, vlm and encdec
families, at S = 64 and at S = 1536 (past one 1024-position attention
chunk).  The train step is held equal except for the ops
``test_torch_dryrun_train.py`` names.

Also: ``input_specs`` for every arch x shape cell against the reference's
(one subprocess: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``),
except the pinned encdec memory leaf; ``collective_stats`` of the
compressed gradient sync over ``StackedGroup(p)`` against the
reference's count of its compiled shard_map body on p forced host
devices (a subprocess each, as ``test_torch_qcomm.py`` runs them); one
microbatch counted for all equals the traced loop; per-device bytes
against the specs' arithmetic on both production meshes; the roofline
on records in ``tmp_path``; the kernel wrappers on ``meta``.
"""

import contextlib
import fcntl
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.hlo_analysis import weighted_cost as hlo_weighted_cost
from repro.models import transformer as jt
from repro_torch.configs import all_arch_names, get_config
from repro_torch.core.comm import StackedGroup
from repro_torch.core.tree import tree_flatten
from repro_torch.kernels import _build, block_pack as bp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import (
    OpCounter,
    collective_stats,
    weighted_cost,
)
from repro_torch.models import transformer as tt
from repro_torch.models.common import SHAPES, ShapeConfig
from repro_torch.optim import compression as tcomp
from repro_torch.train.sharding import PartitionSpec as P
from repro_torch.train.trainer import (TrainConfig, _count_step, init_train_state,
                                      make_train_step, train_state_shape)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
H100 = "NVIDIA H100 80GB HBM3"
B = 2
FAMILIES = ["qwen2-0.5b", "zamba2-2.7b", "deepseek-moe-16b", "deepseek-v3-671b",
            "llama-3.2-vision-11b", "whisper-small"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _reference_slot():
    """The lock the port's reference-run fixtures share, so that one set
    of JAX reference processes loads the cores at a time."""
    path = os.path.join(tempfile.gettempdir(), "repro_torch_reference_runs.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _memories(tc, jc, encoded: bool):
    """(port, reference) frontend memory of B rows: the embeddings, or
    for a decode cache the encoded memory (encdec: in the model dtype)."""
    if tc.family == "vlm":
        return (_meta((B, tc.n_image_tokens, tc.d_model)),
                jnp.zeros((B, jc.n_image_tokens, jc.d_model), jnp.float32))
    if tc.family == "encdec":
        dt = tc.torch_dtype if encoded else torch.float32
        return (_meta((B, tc.n_audio_frames, tc.d_model), dt),
                jnp.zeros((B, jc.n_audio_frames, jc.d_model), jnp.float32))
    return None, None


def _ref_flops(fn, *args) -> float:
    return hlo_weighted_cost(jax.jit(fn).lower(*args).compile().as_text())["flops_weighted"]


def _ref_params(jc):
    return jax.eval_shape(lambda k: jt.init_params(jc, k), jax.random.PRNGKey(0))


# ------------------------------------------------------------- FLOPs


@pytest.mark.parametrize("S", [64, 1536])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_flops_equal_reference(arch, S):
    tc, jc = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    mem, jmem = _memories(tc, jc, encoded=False)
    got = weighted_cost(tt.forward, tt.init_params(tc, device="meta"), tc,
                        _meta((B, S), torch.int32), memory_embeds=mem, backend="torch")
    want = _ref_flops(lambda p, t, m: jt.forward(p, jc, t, memory_embeds=m),
                      _ref_params(jc), jax.ShapeDtypeStruct((B, S), jnp.int32), jmem)
    assert want > 0
    assert got["flops_weighted"] == want
    assert got["bytes_weighted"] > 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v3-671b", "whisper-small"])
def test_decode_flops_equal_reference(arch):
    """One decode step over a 96-position cache (MLA: the absorbed form;
    encdec: cross-attention to the encoded memory)."""
    tc, jc = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    mem, jmem = _memories(tc, jc, encoded=True)
    cache = tt.init_cache(tc, B, 96, memory=mem, device="meta")
    got = weighted_cost(tt.decode_step, tt.init_params(tc, device="meta"), tc, cache,
                        _meta((B, 1), torch.int32))
    jcache = jax.eval_shape(lambda: jt.init_cache(jc, B, 96, memory=jmem))
    want = _ref_flops(lambda p, c, t: jt.decode_step(p, jc, c, t), _ref_params(jc),
                      jcache, jax.ShapeDtypeStruct((B, 1), jnp.int32))
    assert want > 0 and got["flops_weighted"] == want


def test_counter_rules_on_real_tensors():
    """A product's FLOPs, an allocating op's 2x result bytes, nothing for
    a view, the slice for a write into a slice, the source for an
    indexed update; the live storages' peak; a repeated body."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    buf = torch.zeros(10, 4)
    idx, vals = torch.tensor([0, 1]), torch.ones(2, 4)
    with OpCounter() as c:
        y = a @ b                       # 2*8*4*16 FLOPs; writes 8*4 f32
        v = y.view(32)                  # a view: nothing
        buf[2:4].copy_(y[:2])           # the [2, 4] slice
        buf.index_put_((idx,), vals)    # the [2, 4] source
    assert c.flops == 2 * 8 * 4 * 16
    assert c.bytes == 2 * (8 * 4 * 4) + 2 * (2 * 4 * 4) + 2 * (2 * 4 * 4)
    assert c.peak_bytes == 8 * 4 * 4 and v.numel() == 32
    del y, v
    assert c.live_bytes == 0
    with OpCounter() as c2:
        with c2.repeat(5):
            a @ b
        a @ b
    assert c2.flops == 6 * 2 * 8 * 4 * 16


# ------------------------------------------------------------ input specs

SPECS_RUNNER = r'''
import json, sys
from repro.configs import all_arch_names
from repro.launch import dryrun
import jax
out = {}
for arch in all_arch_names():
    for shape in dryrun.SHAPES:
        leaves = jax.tree_util.tree_flatten_with_path(dryrun.input_specs(arch, shape))[0]
        out[f"{arch}|{shape}"] = {jax.tree_util.keystr(p): [list(x.shape), str(x.dtype)]
                                  for p, x in leaves}
json.dump(out, open(sys.argv[1], "w"))
'''


@pytest.fixture(scope="module")
def reference_specs(tmp_path_factory):
    dst = tmp_path_factory.mktemp("dryrun_specs") / "specs.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with _reference_slot():
        res = subprocess.run([sys.executable, "-c", SPECS_RUNNER, str(dst)], env=env,
                             capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(dst.read_text())


def _port_specs(arch, shape):
    specs = dryrun.input_specs(arch, shape)
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"['{k}']['{kk}']"] = [list(vv.shape), str(vv.dtype).replace("torch.", "")]
        else:
            out[f"['{k}']"] = [list(v.shape), str(v.dtype).replace("torch.", "")]
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", all_arch_names())
def test_input_specs_match_reference(reference_specs, arch, shape):
    assert all(x.device.type == "meta"
               for x in tree_flatten(dryrun.input_specs(arch, shape))[0])
    got, want = _port_specs(arch, shape), reference_specs[f"{arch}|{shape}"]
    if get_config(arch).family == "encdec" and SHAPES[shape].kind == "decode":
        # the pinned difference: the encoded memory in the model dtype,
        # where the reference holds f32 frontend embeddings
        key = "['cache']['memory']"
        assert got[key] == [want[key][0], "bfloat16"] and want[key][1] == "float32"
        got, want = dict(got), dict(want)
        del got[key], want[key]
    assert got == want


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_decode_memory_is_what_encode_memory_gives(arch):
    """The dry run's cache memory has the shape and dtype of
    ``encode_memory``'s output (vlm: the embeddings as given)."""
    cfg = get_config(arch, smoke=True)
    emb = dryrun.batch_shapes(cfg, ShapeConfig("s", "prefill", 8, B))["memory_embeds"]
    enc = tt.encode_memory(tt.init_params(cfg, device="meta"), cfg, emb)
    mine = dryrun._memory_shape(cfg, ShapeConfig("s", "decode", 8, B))
    assert (tuple(mine.shape), mine.dtype) == (tuple(enc.shape), enc.dtype)


# ------------------------------------------------------------- collectives

COLL_RUNNER = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core.jaxcompat import shard_map
from repro.launch.hlo_analysis import collective_stats
from repro.optim import compression as comp
p = int(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:p]), ("data",))
shapes = json.loads(sys.argv[2])
names = sorted(shapes)
spec = comp.make_bucket_spec({k: np.zeros(shapes[k], np.float32) for k in names},
                             int(sys.argv[3]))
def body(*shards):
    g = {k: s[0] for k, s in zip(names, shards)}
    e0 = [jnp.zeros((s,), jnp.float32) for s in spec.bucket_sizes]
    m, e = comp.compressed_grad_sync(g, e0, "data", p, spec)
    return tuple(v[None] for v in [m[k] for k in names] + list(e))
f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * len(names),
                      out_specs=(P("data"),) * (len(names) + spec.num_buckets),
                      check_vma=False))
xs = [jax.device_put(jnp.zeros([p] + shapes[k], jnp.float32), NamedSharding(mesh, P("data")))
      for k in names]
print(json.dumps(collective_stats(f.lower(*xs).compile().as_text()).as_dict()))
'''

COLL_SHAPES = {"a": [300, 7], "b": [1000], "c": [64, 64]}
COLL_BUCKET = 4096


@pytest.fixture(scope="module")
def reference_collectives():
    procs = {}
    with _reference_slot():
        for p in (2, 4):
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       XLA_FLAGS=f"--xla_force_host_platform_device_count={p}",
                       PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
            procs[p] = subprocess.Popen(
                [sys.executable, "-c", COLL_RUNNER, str(p), json.dumps(COLL_SHAPES),
                 str(COLL_BUCKET)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        out = {}
        for p, proc in procs.items():
            so, se = proc.communicate(timeout=240)
            assert proc.returncode == 0, se
            out[p] = json.loads(so.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("p", [2, 4])
def test_collective_stats_match_reference(reference_collectives, p):
    """Every message of a round of the port's compressed sync is one
    collective-permute of its per-rank bytes, as each array of the
    reference's ppermute is: counts and bytes equal."""
    like = {k: _meta(tuple(s)) for k, s in COLL_SHAPES.items()}
    spec = tcomp.make_bucket_spec(like, COLL_BUCKET)
    grads = {k: torch.zeros((p,) + tuple(s)) for k, s in COLL_SHAPES.items()}
    errs = tcomp.init_grad_sync_state(spec, p, device="cpu")
    got = collective_stats(tcomp.compressed_grad_sync, grads, errs,
                           StackedGroup(p, device="cpu"), spec, backend="torch")
    want = reference_collectives[p]
    assert want["ops_by_kind"]["collective-permute"] > 0
    assert got.as_dict() == want


def test_collective_stats_count_nothing_outside_the_call():
    group = StackedGroup(3, device="cpu")
    x = torch.ones((3, 64))
    from repro_torch.core.comm import EXCHANGE_OBSERVERS, get_comm

    stats = collective_stats(get_comm(group).broadcast, x, n_blocks=2)
    assert stats.ops_by_kind == {"collective-permute": 3}     # n - 1 + q rounds
    assert stats.bytes_by_kind == {"collective-permute": 3 * 32 * 4}
    assert not EXCHANGE_OBSERVERS


# ---------------------------------------------------- microbatches, bytes


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-moe-16b", "zamba2-2.7b"])
def test_one_microbatch_counted_for_all_equals_the_loop(arch):
    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(microbatches=4, remat="full")
    batch = {"tokens": _meta((8, 64), torch.int32), "labels": _meta((8, 64), torch.int32)}
    counts = []
    for once in (False, True):
        state = train_state_shape(cfg, tcfg)
        with OpCounter() as c:
            step = _count_step(cfg, tcfg, c) if once else make_train_step(cfg, tcfg)
            step(state, batch)
        counts.append((c.flops, c.bytes))
    assert counts[0] == counts[1] and counts[0][0] > 0


def test_counted_step_refuses_leaves_with_data():
    """Counting one microbatch for all would update real leaves wrongly."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    tcfg = TrainConfig(microbatches=2)
    state = init_train_state(cfg, tcfg, device="cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.zeros((2, 8), dtype=torch.int32)}
    with OpCounter() as c, pytest.raises(ValueError, match="meta leaves only"):
        _count_step(cfg, tcfg, c)(state, batch)


def _spec_bytes(tree, specs, mesh):
    """Per-device bytes by the specs, counted leaf by leaf: the elements
    over the product of the named axes' sizes (the specs divide)."""
    total = 0
    spec_leaves = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))[0]
    for x, spec in zip(tree_flatten(tree)[0], spec_leaves):
        split = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                split *= mesh.shape[a] if a is not None else 1
        assert x.numel() % split == 0
        total += x.numel() // split * x.element_size()
    return total


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_argument_bytes_follow_the_specs(kind, multi):
    from repro_torch.models.convert import stack_layers
    from repro_torch.train.sharding import cache_pspecs, param_pspecs

    cfg = get_config("qwen2-0.5b", smoke=True)
    mesh = make_production_mesh(multi_pod=multi)
    shape = ShapeConfig("s", kind, 64, 64)
    rec = dryrun.trace_cell(cfg, shape, mesh, microbatches=1)
    by = rec["memory"]["argument_bytes_by_input"]
    if kind == "train":
        state = train_state_shape(cfg, TrainConfig())
        ps = param_pspecs(cfg, state["params"], mesh)
        want = _spec_bytes(state, {"params": ps, "opt": {"mu": ps, "nu": ps, "step": P()}},
                           mesh)
        assert by["state"] == want and rec["memory"]["alias_bytes"] == want
    else:
        tree = stack_layers(tt.init_params(cfg, device="meta"), cfg)
        assert by["params"] == _spec_bytes(tree, param_pspecs(cfg, tree, mesh,
                                                              no_fsdp=True), mesh)
        cache = tt.init_cache(cfg, 64, 64, device="meta")
        assert by["cache"] == _spec_bytes(cache, cache_pspecs(cfg, mesh, cache), mesh)
    assert rec["memory"]["argument_bytes"] == sum(by.values())
    assert rec["devices"] == mesh.size


def test_prefill_cells_trace_the_plain_path():
    """A prefill cell runs ``make_prefill_step(cfg, backend="torch")``:
    stablelm-12b's 160-wide heads trace on the plain path.  The flash
    kernel's wrapper refuses a v head wider than its widest instance's
    160 (here 176) on any device."""
    from dataclasses import replace

    cfg = replace(get_config("stablelm-12b", smoke=True), head_dim=160)
    q = _meta((1, 8, cfg.n_heads, 176))
    with pytest.raises(ValueError, match="hd_v 176 > 160"):
        fa.flash_attention(q, q, q)
    rec = dryrun.trace_cell(cfg, ShapeConfig("s", "prefill", 64, 2), make_production_mesh())
    want = weighted_cost(tt.prefill, tt.init_params(cfg, device="meta"), cfg,
                         _meta((2, 64), torch.int32), backend="torch")
    assert rec["flops_weighted"] * rec["devices"] == want["flops_weighted"] > 0


def test_lower_cell_skips_long_context_full_attention_and_restores_rules():
    from repro_torch.train import sharding

    rec = dryrun.lower_cell("qwen2-0.5b", "long_500k", False)
    assert "skipped" in rec and rec["mesh"] == "single"
    cfg = get_config("deepseek-moe-16b", smoke=True)
    dryrun.trace_cell(cfg, ShapeConfig("s", "decode", 32, 16),
                      make_production_mesh(), ep_mode="full", cache_seq_shard=False)
    assert sharding.EP_MODE == "2d" and sharding.CACHE_SEQ_SHARD is True


# --------------------------------------------------------------- roofline


def _records(tmp_path):
    for arch, shape in (("qwen2-0.5b", ShapeConfig("train_4k", "train", 64, 16)),
                        ("zamba2-2.7b", ShapeConfig("prefill_32k", "prefill", 128, 4))):
        rec = dryrun.trace_cell(get_config(arch, smoke=True), shape,
                                make_production_mesh())
        rec = {"arch": arch, "shape": shape.name, "mesh": "single", "tag": "", **rec}
        path = dryrun.cell_path(arch, shape.name, "single", out_dir=str(tmp_path))
        with open(path, "w") as f:
            json.dump(rec, f)
    skip = dryrun.lower_cell("qwen2-0.5b", "long_500k", False)
    with open(dryrun.cell_path("qwen2-0.5b", "long_500k", "single", out_dir=str(tmp_path)),
              "w") as f:
        json.dump(skip, f)


def test_roofline_terms_and_table(tmp_path, capsys):
    _records(tmp_path)
    card = roofline.card_constants(H100)
    rows = [roofline.terms(d, card) for d in roofline.load_cells("single", "", str(tmp_path))]
    assert len(rows) == 3
    live = [r for r in rows if "skipped" not in r]
    for r in live:
        assert r["collective_s"] is None and r["latency_s"] is None
        assert r["bottleneck"] in ("compute", "memory") and r["fits_hbm"]
        assert 0 < r["roofline_frac"] <= 1
    table = roofline.markdown_table(rows, card)
    assert "| -- | -- |" in table and "No collective was modelled" in table
    assert "fits 85GB" in table and "skipped (full attention)" in table
    roofline.main(["--md", "--gpu", H100, "--dir", str(tmp_path)])
    assert "989 TFLOP/s" in capsys.readouterr().out
    rec = dict(json.load(open(dryrun.cell_path("qwen2-0.5b", "train_4k", "single",
                                               out_dir=str(tmp_path)))))
    rec.update(collective_bytes=3.35e9, collective_rounds=100)
    t = roofline.terms(rec, card)
    assert t["collective_s"] == pytest.approx(2e-3) and t["latency_s"] == 100 * card["alpha"]
    assert "2.0ms" in roofline.markdown_table([t], card)


def test_roofline_needs_a_card_or_a_named_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--gpu"):
        roofline.card_constants()
    with pytest.raises(RuntimeError):
        roofline.main(["--md"])
    with pytest.raises(ValueError, match="unknown card"):
        roofline.card_constants("TPU v5e")


def test_no_tpu_constant_in_the_port():
    src = open(roofline.__file__).read()
    for tpu in ("197e12", "819e9", "50e9", "16e9", "1e-6"):
        assert tpu not in src


# ------------------------------------------------------- kernels on meta


def test_meta_calls_load_no_library(monkeypatch):
    """The model kernels' wrappers run their plain versions on ``meta``
    (the dry run's path); the round-step wrappers refuse a meta operand
    before any kernel is built or loaded.  No launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("a meta call reached the kernel library")

    for name in ("launch", "load", "build"):
        monkeypatch.setattr(_build, name, refuse)
    launches = (dict(bp.LAUNCHES), dict(fa.LAUNCHES), dict(ss.LAUNCHES))
    q = _meta((2, 40, 4, 16), torch.bfloat16)
    out = fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    assert out.shape == (2, 40, 4, 16) and out.device.type == "meta"
    x = _meta((2, 40, 4, 8))
    y = ss.ssd_scan(x, _meta((2, 40, 1, 8)), _meta((2, 40, 1, 8)), _meta((2, 40, 4)),
                    _meta((4,)), _meta((4,)), chunk=16)
    assert y.shape == x.shape and y.device.type == "meta"
    R, nslots, bs = 4, 6, 32
    buf, msg, i = _meta((R, nslots, bs)), _meta((R, bs)), _meta((R,), torch.int32)
    calls = [lambda: bp.block_pack(buf, i), lambda: bp.block_unpack(buf, msg, i),
             lambda: bp.block_shuffle(buf, msg, i, i),
             lambda: bp.block_shuffle_staged(buf, msg, msg, i, i),
             lambda: bp.block_acc_shuffle(buf, msg, i, i),
             lambda: bp.block_acc_shuffle_staged(buf, msg, msg, i, i),
             lambda: bp.block_qacc_shuffle(buf, _meta((R, nslots, bs)),
                                           _meta((R, bs), torch.int8), _meta((R, 1)), i, i)]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert (dict(bp.LAUNCHES), dict(fa.LAUNCHES), dict(ss.LAUNCHES)) == launches
