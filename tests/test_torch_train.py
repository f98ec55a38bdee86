"""The port's training path against the JAX package.

Held on the same inputs (weights from the reference's ``init_params`` or
``init_train_state``, batches from a seed):

  * ``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
    reference's, jitted, on the dense, ssm and hybrid SMOKE configs (and
    the vlm and encdec ones, their batches carrying seeded
    ``memory_embeds``, every vlm cross-attention gate 0.5: the gradients
    reach ``img_proj`` and the encoder stack through the memory) in
    f32 (loss within rtol 1e-5; gradients, in the reference's stacked
    layout, within rtol 1e-4 / atol 1e-6) and in the bf16 default (loss
    within 1e-2 relative: bf16 rounds at other places in the two
    frameworks); the port's remat ``none``, ``full`` and ``dots`` give
    the same loss and gradients bit for bit;
  * ``cross_entropy`` and ``chunked_softmax_xent`` against the
    reference's (rtol 1e-5);
  * ``apply_updates`` against the jitted reference, f32 and bf16 moments,
    within rtol 1e-6 (the port rounds the moment updates once, as XLA's
    fused multiply-adds do; the global norm sums in another order, so
    the clip scale may differ in its last bit, and a moment where
    ``b1*mu`` and ``(1-b1)*g`` cancel is held to 1e-6 of its leaf's
    largest; a bf16 moment may sit one bf16 step away where the two f32
    values straddle a rounding boundary, and is held to that);
  * ``SyntheticLM`` batches bit for bit for (seed, step, shard).

(The trainer's steps against the reference's trainer are in
``tests/test_torch_train_parity.py``.)

Also: the buckets of Qwen2-0.5B's gradient come from the reference's tree
(14 leaves in 10 buckets of 4 MiB), and those of the memory families'
stacked trees (``enc``, ``xattn`` and ``img_proj`` leaves) at SMOKE and
FULL; the CUDA wrappers refuse operands that
require grad (their ``_check`` monkeypatched to claim a card).
"""

import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.optim import adamw as jadamw
from repro.optim.compression import make_bucket_spec as jax_bucket_spec
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (
    bind,
    params_from_jax,
    stack_layers,
    to_tensor,
    unstack_layers,
)
from repro_torch.optim import adamw as tadamw
from repro_torch.train import (
    TrainConfig,
    grad_bucket_spec,
    init_train_state,
    make_eval_step,
    make_train_step,
)

ARCHS = ["qwen2-0.5b", "mamba2-780m", "zamba2-2.7b"]
MEMORY_ARCHS = ["llama-3.2-vision-11b", "whisper-small"]
GATE = 0.5


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _np(t):
    return t.detach().float().numpy()


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    labels[0, 3] = -100
    batch = {"tokens": tokens, "labels": labels}
    T = {"vlm": cfg.n_image_tokens, "encdec": cfg.n_audio_frames}.get(cfg.family)
    if T:
        batch["memory_embeds"] = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    return batch


def _init(jc, seed):
    """The reference's parameters, every vlm cross-attention gate 0.5 (at
    its init value 0 the cross-attention drops out of the loss)."""
    params = jt.init_params(jc, jax.random.PRNGKey(seed))
    for sub in params.values():
        if isinstance(sub, dict) and "gate" in sub:
            sub["gate"] = jnp.full_like(sub["gate"], GATE)
    return params


def _port_loss_and_grads(tc, jparams, batch, remat="none"):
    """The port's loss and its gradients in the stacked layout."""
    model = params_from_jax(_tree_np(jparams), tc, device="cpu")
    tree = stack_layers(model, tc)
    leaves, treedef = tree_flatten(tree)
    ins = [x.detach().clone().requires_grad_() for x in leaves]
    shell = tt.init_params(tc, device="meta")
    bound = bind(shell, unstack_layers(shell, tc, tree_unflatten(treedef, ins)))
    loss, metrics = tt.loss_fn(bound, tc, {k: torch.as_tensor(v) for k, v in batch.items()},
                               remat=remat)
    grads = torch.autograd.grad(loss, ins)
    return loss.detach(), metrics, grads


@pytest.mark.parametrize("arch", ARCHS + MEMORY_ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    jc = replace(jax_config(arch, smoke=True), dtype="float32")
    tc = replace(get_config(arch, smoke=True), dtype="float32")
    jp = _init(jc, 3)
    batch = _batch(tc, 2, 24, seed=1)

    def jloss(params):
        return jt.loss_fn(params, jc, {k: jnp.asarray(v) for k, v in batch.items()})

    (jl_, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    loss, metrics, grads = _port_loss_and_grads(tc, jp, batch)
    np.testing.assert_allclose(float(loss), float(jl_), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]), rtol=1e-5)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_reference(arch):
    jc, tc = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    assert tc.dtype == "bfloat16"
    jp = jt.init_params(jc, jax.random.PRNGKey(4))
    batch = _batch(tc, 2, 24, seed=2)
    jloss, _ = jax.jit(lambda p: jt.loss_fn(p, jc, {k: jnp.asarray(v)
                                                  for k, v in batch.items()}))(jp)
    loss, _, grads = _port_loss_and_grads(tc, jp, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-2 * abs(float(jloss))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


@pytest.mark.parametrize("arch", ARCHS + MEMORY_ARCHS)
def test_remat_modes_are_bit_equal(arch):
    tc = replace(get_config(arch, smoke=True), dtype="float32")
    jp = _init(replace(jax_config(arch, smoke=True), dtype="float32"), 5)
    batch = _batch(tc, 2, 20, seed=3)
    base = _port_loss_and_grads(tc, jp, batch, "none")
    for remat in ("full", "dots"):
        loss, _, grads = _port_loss_and_grads(tc, jp, batch, remat)
        assert torch.equal(loss, base[0]), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, base[2])), remat
    with pytest.raises(ValueError, match="unknown remat"):
        _port_loss_and_grads(tc, jp, batch, "some")


@pytest.mark.parametrize("S,chunk", [(24, 512), (37, 16), (64, 16)])
def test_cross_entropy_matches_reference(S, chunk):
    rng = np.random.default_rng(S)
    hidden = rng.normal(size=(2, S, 32)).astype(np.float32)
    table = rng.normal(size=(50, 32)).astype(np.float32) * 0.3
    labels = rng.integers(0, 50, size=(2, S)).astype(np.int32)
    labels[1, ::5] = -100
    want = jl.chunked_softmax_xent(jnp.asarray(hidden), jnp.asarray(table),
                                   jnp.asarray(labels), chunk=chunk)
    got = tl.chunked_softmax_xent(_t(hidden), _t(table), _t(labels), chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    logits = hidden @ table.T
    np.testing.assert_allclose(
        float(tl.cross_entropy(_t(logits), _t(labels))),
        float(jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-5)


def test_blocked_attention_grads_match_reference():
    from repro.models import attention as ja
    from repro_torch.models import attention as ta

    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    do = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    for causal, window, qc, kc in ((True, None, 16, 8), (True, 12, 8, 16), (False, None, 40, 40)):
        def f(q_, k_, v_):
            return jnp.sum(ja.blocked_attention(q_, k_, v_, causal, window, 0, qc, kc) * do)

        want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
        ins = [_t(x).requires_grad_() for x in (q, k, v)]
        out = ta.blocked_attention(*ins, causal, window, 0, qc, kc)
        got = torch.autograd.grad((out * _t(do)).sum(), ins)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moment_dtype):
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10,
                             moment_dtype=moment_dtype)
    jcfg = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(13)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32),
              "pos0": {"m": rng.normal(size=(3, 4)).astype(np.float32)}}
    jstate = jadamw.init_opt_state(jcfg, params)
    tparams = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    tstate = tadamw.init_opt_state(cfg, tparams)
    step = jax.jit(lambda p, g, s: jadamw.apply_updates(jcfg, p, g, s))
    jparams = params
    for i in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 2).astype(np.float32),
                             params)
        jparams, jstate, jm = step(jparams, grads, jstate)
        _, tstate, tm = tadamw.apply_updates(
            cfg, tparams, jax.tree.map(lambda a: torch.from_numpy(a), grads), tstate)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        for got, want in zip(tree_flatten(tparams)[0], jax.tree.leaves(jparams)):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
        for key in ("mu", "nu"):
            for got, want in zip(tree_flatten(tstate[key])[0], jax.tree.leaves(jstate[key])):
                assert str(got.dtype).endswith(moment_dtype)
                w = np.asarray(want, np.float32)
                if moment_dtype == "float32":
                    # the clip scale carries the global norm's rounding
                    # (its sum runs in another order), and b1*mu + (1-b1)*g
                    # may cancel: held to 1e-6 of the leaf's largest moment
                    np.testing.assert_allclose(_np(got), w, rtol=1e-6,
                                               atol=1e-6 * np.abs(w).max())
                else:
                    # one bf16 step (2^-8 relative) where the f32 values
                    # straddle a bf16 rounding boundary
                    np.testing.assert_allclose(_np(got), w, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("step,shard,shards", [(0, 0, 1), (7, 1, 2), (123, 3, 4)])
def test_synthetic_batches_are_the_references(step, shard, shards):
    kw = dict(vocab=1000, seq_len=33, global_batch=8, seed=5)
    want = JSyntheticLM(JDataConfig(**kw), shard, shards).batch_at(step)
    got = SyntheticLM(DataConfig(**kw), shard, shards).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_qwen2_buckets_follow_the_reference_tree():
    """Qwen2-0.5B's gradient: 14 leaves in 10 buckets of 4 MiB, the
    tied embedding its own bucket; the same spec as the reference's
    make_bucket_spec of its abstract parameters."""
    spec = grad_bucket_spec(get_config("qwen2-0.5b"), TrainConfig())
    shapes = jax.eval_shape(lambda k: jt.init_params(jax_config("qwen2-0.5b"), k),
                            jax.random.PRNGKey(0))
    want = jax_bucket_spec(shapes, 4 << 20)
    assert (spec.leaf_sizes, spec.assignment, spec.offsets, spec.bucket_sizes) == (
        want.leaf_sizes, want.assignment, want.offsets, want.bucket_sizes)
    assert (len(spec.leaf_sizes), spec.num_buckets) == (14, 10)
    assert sum(spec.leaf_sizes) == 494_032_768
    assert max(spec.leaf_sizes) == 136_134_656


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", MEMORY_ARCHS)
def test_memory_family_buckets_follow_the_reference_tree(arch, smoke):
    """The vlm and encdec gradients bucket as the reference's: the same
    leaves (img_proj; the encoder stack ``enc`` and the ``xattn`` blocks)
    in the same buckets."""
    spec = grad_bucket_spec(get_config(arch, smoke=smoke), TrainConfig())
    shapes = jax.eval_shape(lambda k: jt.init_params(jax_config(arch, smoke=smoke), k),
                            jax.random.PRNGKey(0))
    want = jax_bucket_spec(shapes, 4 << 20)
    assert (spec.leaf_sizes, spec.assignment, spec.offsets, spec.bucket_sizes) == (
        want.leaf_sizes, want.assignment, want.offsets, want.bucket_sizes)
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert any("img_proj" in n for n in names) or any("'enc'" in n for n in names)
    assert any("xattn" in n for n in names)


def test_stacked_layout_round_trips_and_binds():
    tc = get_config("zamba2-2.7b", smoke=True)
    model = tt.init_params(tc, torch.Generator().manual_seed(1), device="cpu")
    tree = stack_layers(model, tc)
    names = dict(model.named_parameters())
    back = unstack_layers(model, tc, tree)
    assert sorted(back) == sorted(names)
    assert all(torch.equal(back[n], p) for n, p in names.items())
    bound = bind(tt.init_params(tc, device="meta"), back)
    assert bound.layers[3].ssm.in_proj is back["layers.3.ssm.in_proj"]
    with pytest.raises(ValueError, match="no tensor for parameter"):
        bind(model, {})


def test_model_kernels_refuse_operands_that_need_grad(monkeypatch):
    """On the card a kernel writes its output outside autograd, so an
    operand that requires grad under grad mode is refused before any
    launch (``_check`` claims a card here); under no_grad, or on CPU
    tensors through the plain versions, nothing is refused."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16)
    out = fa.flash_attention(q, k, k)                 # plain version: autograd
    assert out.requires_grad and out.grad_fn is not None
    monkeypatch.setattr(fa, "_check", lambda *a: True)
    with pytest.raises(ValueError, match="flash_attention has no backward"):
        fa.flash_attention(q, k, k)
    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    B_ = torch.randn(1, 8, 1, 4)
    dt = torch.rand(1, 8, 2)
    A, D = torch.zeros(2), torch.ones(2)
    y = ss.ssd_scan(x, B_, B_, dt, A, D, chunk=4)
    assert y.grad_fn is not None
    monkeypatch.setattr(ss, "_check", lambda *a: True)
    with pytest.raises(ValueError, match="ssd_scan has no backward"):
        ss.ssd_scan(x, B_, B_, dt, A, D, chunk=4)
    launched = []
    monkeypatch.setattr("repro_torch.kernels._build.launch",
                        lambda *a, **kw: launched.append(a))
    with torch.no_grad():
        fa.flash_attention(q, k, k)
        ss.ssd_scan(x, B_, B_, dt, A, D, chunk=4)
    assert [a[1] for a in launched] == ["flash_attention", "ssd_scan"]


def test_eval_step_and_plain_step_on_the_cpu():
    tc = get_config("qwen2-0.5b", smoke=True)
    tcfg = TrainConfig(grad_sync="compressed")
    state = init_train_state(tc, tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(e.shape) for e in state["gsync_err"]] == [
        (1, s) for s in grad_bucket_spec(tc, tcfg).bucket_sizes]
    batch = _batch(tc, 2, 16)
    before = make_eval_step(tc)(state["params"], batch)
    err = state["gsync_err"]
    step = make_train_step(tc, tcfg)                  # no group: the plain step
    for _ in range(3):
        state, metrics = step(state, batch)
    assert state["gsync_err"] is err and int(state["opt"]["step"]) == 3
    assert float(make_eval_step(tc)(state["params"], batch)) < float(before)
    assert set(metrics) == {"ce", "aux", "grad_norm", "lr", "loss"}
