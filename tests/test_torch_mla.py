"""The port's deepseek-v3 family (``mla_moe`` and MTP) held against the JAX
package.

On ``deepseek-v3-smoke`` (2 layers, d_model 64, 4 heads; MLA with
q_lora 48, kv_lora 32, nope 16, rope 8, v 16; 8 routed experts top-2
plus 1 shared; MTP on), the reference's weights are carried across with
``params_from_jax`` (``mla_init``'s for the attention alone) and the same
inputs (numpy, from a seed) go through both packages: ``mla_full`` on
both backends, ``mla_decode`` (the absorbed form over the compressed
cache), ``forward``, ``prefill``, ``init_cache`` and decode steps,
``ServeLoop`` against the reference's, ``loss_fn`` with its aux and MTP
terms and its gradient against ``jax.grad``, and the trainer's gradient
buckets.  The reference runs jitted.

The moe layers route discretely, so every whole-model comparison records
each moe layer's input in both packages and asserts, token by token,
that the gap between the K-th and (K+1)-th router logit is more than
twice the largest difference between the two packages' logits
(:func:`_assert_routing_premise`, as ``tests/test_torch_moe.py`` does).
The bf16 seeds are ones for which it holds, and the assertion keeps them
so.

Tolerances: f32 within 1e-5 absolute and relative; bf16 within 2e-2 (as
``tests/test_models.py``); the f32 gradient within rtol 1e-4 / atol
1e-6 (as ``tests/test_torch_train.py``); the absorbed decode against the
materialized attention within 2e-4 (``tests/test_attention_equiv.py``'s
bound for the reference's own pair).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as ja
from repro.models import transformer as jt
from repro.optim.compression import make_bucket_spec as jax_bucket_spec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeLoop as JServeLoop
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.models import attention as ta
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (
    bind,
    cache_from_jax,
    params_from_jax,
    stack_layers,
    to_tensor,
    unstack_layers,
)
from repro_torch.serve.engine import Request, ServeLoop, make_prefill_step
from repro_torch.train import TrainConfig, grad_bucket_spec

ARCH = "deepseek-v3-671b"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: Seeds of the weights (and, one after, of the tokens) for which the
#: routing premise holds, found by trying seeds in order: in bf16 few do
#: (each is the first that held, after 6 to 15 that did not).
FORWARD_SEED = {"float32": 1704, "bfloat16": 1809}
PREFILL_SEED = {"float32": 406, "bfloat16": 427}
DECODE_SEED = {"float32": 508, "bfloat16": 550}
LOSS_SEED = {"float32": 1704, "bfloat16": 1809}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's intra-op threads, and the
    other test files of a parallel run share the cores with this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _close(port, ref, dtype):
    np.testing.assert_allclose(_np(port), _np(ref), atol=TOL[dtype], rtol=TOL[dtype])


def _configs(dtype, **moe):
    jc = replace(jax_config(ARCH, smoke=True), dtype=dtype)
    tc = replace(get_config(ARCH, smoke=True), dtype=dtype)
    if moe:
        jc = replace(jc, moe=replace(jc.moe, **moe))
        tc = replace(tc, moe=replace(tc.moe, **moe))
    return jc, tc


def _models(dtype, seed=1, **moe):
    jc, tc = _configs(dtype, **moe)
    jp = jt.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape)


# ----------------------------------------------------------- the premise


@pytest.fixture
def moe_inputs(monkeypatch):
    """Records each ``moe_apply`` call's input, in call order, in both
    packages: ``(port, ref)`` lists of f32 arrays [B*S, d] (the reference
    through an ordered ``jax.debug.callback``, so its jitted scans record
    every layer of every call)."""
    port, ref = [], []
    port_apply, ref_apply = tt.moe_apply, jt.moe_apply

    def port_rec(p, x, cfg):
        port.append(_np(x).reshape(-1, x.shape[-1]))
        return port_apply(p, x, cfg)

    def ref_rec(p, x, cfg, ep_spec=None):
        jax.debug.callback(lambda a: ref.append(np.asarray(a, np.float32).reshape(
            -1, a.shape[-1])), x, ordered=True)
        return ref_apply(p, x, cfg, ep_spec)

    monkeypatch.setattr(tt, "moe_apply", port_rec)
    monkeypatch.setattr(jt, "moe_apply", ref_rec)
    return port, ref


def _assert_routing_premise(port_x, ref_x, tp, cfg):
    """Each recorded moe input routes alike in both packages: for every
    token, the gap between its K-th and (K+1)-th router logit (from the
    port's input) exceeds twice the largest gap between the two
    packages' logits."""
    assert len(port_x) == len(ref_x) > 0
    routers = [np.asarray(layer.moe.router, np.float64) for layer in tp.layers]
    K = cfg.moe.top_k
    for c, (xp, xr) in enumerate(zip(port_x, ref_x)):
        w = routers[c % len(routers)]
        lp, lr = xp.astype(np.float64) @ w, xr.astype(np.float64) @ w
        top = -np.sort(-lp, axis=-1)
        margin = top[:, K - 1] - top[:, K]
        pert = np.abs(lp - lr).max(axis=-1)
        assert (margin > 2 * pert).all(), (
            f"routing premise: moe call {c} has a token whose top-{K} margin "
            f"{margin.min()} is within twice the two packages' logit gap "
            f"{pert[np.argmin(margin - 2 * pert)]}")


# ------------------------------------------------------------ attention


def _mla_pair(dtype, seed):
    """The reference's ``mla_init`` weights, and the port's MLA holding
    them."""
    jc, tc = _configs(dtype)
    jp = ja.mla_init(jax.random.PRNGKey(seed), jc, jc.jdtype)
    port = ta.MLA(torch.Generator().manual_seed(0), tc, tc.torch_dtype)
    names = {n for n, _ in port.named_parameters()}
    assert names == set(jp)
    for name, p in port.named_parameters():
        value = _t(jp[name])
        assert value.shape == p.shape and value.dtype == p.dtype, name
        p.data.copy_(value)
    assert port.q_norm.dtype == port.kv_norm.dtype == torch.float32
    return jc, tc, jp, port


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_full_matches_reference(dtype, backend, causal):
    jc, tc, jp, port = _mla_pair(dtype, seed=2)
    rng = np.random.default_rng(3)
    B, S = 2, 13
    x = jnp.asarray(rng.standard_normal((B, S, jc.d_model)), jc.jdtype)
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    want, (w_ckv, w_kr) = jax.jit(lambda p, x: ja.mla_full(
        p, x, jc, positions, causal=causal))(jp, x)
    got, (ckv, kr) = ta.mla_full(port, _t(x), tc, _t(positions), causal=causal,
                                 backend=backend)
    m = tc.mla
    assert got.shape == (B, S, tc.d_model) and got.dtype == tc.torch_dtype
    assert ckv.shape == (B, S, m.kv_lora_rank) and kr.shape == (B, S, m.qk_rope_dim)
    _close(got, want, dtype)
    _close(ckv, w_ckv, dtype)
    _close(kr, w_kr, dtype)


def _decode_inputs(jc, rng, B=3, S=10):
    m = jc.mla
    x = jnp.asarray(rng.standard_normal((B, 1, jc.d_model)), jc.jdtype)
    ckv = jnp.asarray(rng.standard_normal((B, S, m.kv_lora_rank)), jc.jdtype)
    kr = jnp.asarray(rng.standard_normal((B, S, m.qk_rope_dim)), jc.jdtype)
    return x, ckv, kr


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_matches_reference(dtype):
    """The absorbed decode of 3 slots at positions 0, 4 and 9 (the last
    row of the cache) over a cache of random rows: the output and both
    caches with their new rows."""
    jc, tc, jp, port = _mla_pair(dtype, seed=4)
    x, ckv, kr = _decode_inputs(jc, np.random.default_rng(5))
    pos = jnp.asarray([0, 4, 9], jnp.int32)
    want, w_ckv, w_kr = jax.jit(lambda p, x, a, b, q: ja.mla_decode(p, x, jc, a, b, q))(
        jp, x, ckv, kr, pos)
    t_ckv, t_kr = _t(ckv).clone(), _t(kr).clone()
    got, g_ckv, g_kr = ta.mla_decode(port, _t(x), tc, t_ckv, t_kr, _t(pos))
    assert g_ckv is t_ckv and g_kr is t_kr          # written in place
    assert got.shape == (3, 1, tc.d_model) and got.dtype == tc.torch_dtype
    _close(got, want, dtype)
    _close(g_ckv, w_ckv, dtype)
    _close(g_kr, w_kr, dtype)
    # the step wrote its rows: the caches moved at (slot, pos) only
    moved = (_np(g_ckv) != _np(ckv)).any(-1)
    assert moved.sum() == 3 and moved[[0, 1, 2], [0, 4, 9]].all()


def test_mla_decode_drops_a_write_past_the_cache():
    """A slot at pos >= S writes nothing (JAX drops an out-of-range
    scatter row) and still attends every row of its cache."""
    jc, tc, jp, port = _mla_pair("float32", seed=6)
    x, ckv, kr = _decode_inputs(jc, np.random.default_rng(7), B=2, S=6)
    pos = jnp.asarray([2, 6], jnp.int32)
    want, w_ckv, w_kr = jax.jit(lambda p, x, a, b, q: ja.mla_decode(p, x, jc, a, b, q))(
        jp, x, ckv, kr, pos)
    got, g_ckv, g_kr = ta.mla_decode(port, _t(x), tc, _t(ckv).clone(), _t(kr).clone(),
                                     _t(pos))
    np.testing.assert_array_equal(_np(g_ckv)[1], np.asarray(ckv)[1])
    np.testing.assert_array_equal(_np(g_kr)[1], np.asarray(kr)[1])
    _close(g_ckv, w_ckv, "float32")
    _close(g_kr, w_kr, "float32")
    _close(got, want, "float32")


@pytest.mark.parametrize("seq", [1, 10])
def test_absorbed_decode_matches_materialized_prefill(seq):
    """Step-by-step absorbed decode over the compressed cache equals the
    materialized causal attention at every position (the port's own pair,
    as ``tests/test_attention_equiv.py`` holds the reference's)."""
    _, tc, _, port = _mla_pair("float32", seed=8)
    B = 2
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, seq, tc.d_model)).astype(np.float32))
    positions = torch.arange(seq).expand(B, seq)
    full, (ckv_full, kr_full) = ta.mla_full(port, x, tc, positions)
    ckv = torch.zeros((B, seq, tc.mla.kv_lora_rank))
    kr = torch.zeros((B, seq, tc.mla.qk_rope_dim))
    outs = []
    for t in range(seq):
        o, ckv, kr = ta.mla_decode(port, x[:, t:t + 1], tc, ckv, kr,
                                   torch.full((B,), t, dtype=torch.int32))
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full), atol=2e-4, rtol=2e-4)
    # the cache the decode built is the one mla_full returns
    np.testing.assert_allclose(_np(ckv), _np(ckv_full), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(kr), _np(kr_full), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------ parameters


@pytest.mark.parametrize("dtype", DTYPES)
def test_params_from_jax_carries_every_leaf(dtype):
    """Every leaf of the reference's tree (the MLA weights, the f32 norms,
    the ``mtp`` block and ``mtp_proj``), nothing left over;
    ``stack_layers`` gives the tree back leaf for leaf (``mtp.*`` and
    ``mtp_proj`` not stacked) and ``unstack_layers`` every parameter."""
    jc, tc, jp, tp = _models(dtype, seed=3)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert sum(p.numel() for p in tp.parameters()) == sum(x.size for _, x in leaves)
    tree = stack_layers(tp, tc)
    assert len(jax.tree.leaves(tree)) == len(leaves)
    for path, ref in leaves:
        node = tree
        for key in path:
            node = node[key.key]
        assert str(node.dtype)[6:] == str(ref.dtype), path
        assert tuple(node.shape) == ref.shape, path
        np.testing.assert_array_equal(_np(node), np.asarray(ref, np.float32))
    assert tree["mtp_proj"].shape == (2 * tc.d_model, tc.d_model)
    assert tree["mtp"]["attn"]["wq"].shape == (tc.d_model, tc.n_heads * tc.hd)
    assert tree["pos0"]["attn"]["q_norm"].dtype == torch.float32
    back = unstack_layers(tp, tc, tree)
    for name, p in tp.named_parameters():
        assert torch.equal(back[name], p), name
    bound = bind(tp, back)
    assert bound.mtp_proj is back["mtp_proj"] and bound.mtp.attn.wq is back["mtp.attn.wq"]


def test_layer_block_names_and_size():
    """The ``mla_moe`` block's names, and deepseek-v3-671b as built: its
    ``param_count()`` leaves out ``ln_f``, the ``mtp`` block and
    ``mtp_proj``."""
    tc = get_config(ARCH, smoke=True)
    assert tt.layer_pattern(tc) == (["mla_moe"], tc.n_layers, False)
    tp = tt.init_params(tc, device="meta")
    names = {n.split(".", 2)[2] for n, _ in tp.named_parameters()
             if n.startswith("layers.0.")}
    mla = {"w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk", "w_uv", "wo"}
    assert names == {"ln1", "ln2"} | {f"attn.{n}" for n in mla} | {
        "moe.router", "moe.w_gate", "moe.w_up", "moe.w_down",
        "moe.shared.w_gate", "moe.shared.w_up", "moe.shared.w_down"}
    full = get_config(ARCH)
    model = tt.init_params(full, device="meta")
    n = sum(p.numel() for p in model.parameters())
    mtp = sum(p.numel() for p in model.mtp.parameters()) + model.mtp_proj.numel()
    d = full.d_model
    assert mtp == 4 * d * d + 3 * d * full.d_ff + 2 * d + 2 * d * d == 352_335_872
    assert n == full.param_count() + d + mtp == 704_150_148_096


# ---------------------------------------------------------- the model


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype, moe_inputs):
    jc, tc, jp, tp = _models(dtype, seed=FORWARD_SEED[dtype])
    tok = _tokens(jc.vocab, (2, 13), seed=FORWARD_SEED[dtype] + 1)
    want, waux = jax.jit(lambda p, t: jt.forward(p, jc, t))(jp, jnp.asarray(tok))
    for backend in ("cuda", "torch"):
        got, aux = tt.forward(tp, tc, torch.from_numpy(tok), backend=backend)
        _assert_routing_premise(*moe_inputs, tp, tc)
        del moe_inputs[0][:]
        assert got.shape == (2, 13, tc.vocab) and got.dtype == tc.torch_dtype
        _close(got, want, dtype)
        assert aux.dtype == torch.float32 and float(aux) > 0
        np.testing.assert_allclose(float(aux), float(waux), rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_reference(dtype, moe_inputs):
    jc, tc, jp, tp = _models(dtype, seed=PREFILL_SEED[dtype])
    tok = _tokens(jc.vocab, (2, 12), seed=PREFILL_SEED[dtype] + 1)
    want = jax.jit(lambda p, t: jt.prefill(p, jc, t))(jp, jnp.asarray(tok))
    got = make_prefill_step(tc)(tp, torch.from_numpy(tok))
    _assert_routing_premise(*moe_inputs, tp, tc)
    assert got.shape == (2, 1, tc.vocab) and got.dtype == tc.torch_dtype
    _close(got, want, dtype)
    plain = make_prefill_step(tc, backend="torch")(tp, torch.from_numpy(tok))
    assert torch.equal(plain, got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_cache_matches_reference(dtype):
    jc, tc = _configs(dtype)
    want = jt.init_cache(jc, 3, 10)
    got = tt.init_cache(tc, 3, 10, device="cpu")
    assert list(got) == list(want) == ["pos_idx", "pos0_ckv", "pos0_kr"]
    for key, ref in want.items():
        assert tuple(got[key].shape) == ref.shape, key
        assert str(got[key].dtype)[6:] == str(ref.dtype), key
    m = tc.mla
    assert got["pos0_ckv"].shape == (tc.n_layers, 3, 10, m.kv_lora_rank)
    assert got["pos0_kr"].shape == (tc.n_layers, 3, 10, m.qk_rope_dim)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference(dtype, moe_inputs):
    """Three steps over 4 slots at different positions, one of them
    running past the cache (its writes dropped): each step routes 4
    tokens with C = 1, so the slots compete for their experts."""
    jc, tc, jp, tp = _models(dtype, seed=DECODE_SEED[dtype])
    B, S = 4, 8
    assert tm.capacity(tc, B) == 1
    jcache = jt.init_cache(jc, B, S)
    jcache["pos_idx"] = jnp.asarray([0, 3, 1, 7], jnp.int32)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    tok = _tokens(jc.vocab, (B, 3), seed=DECODE_SEED[dtype] + 1)
    step = jax.jit(lambda p, c, t: jt.decode_step(p, jc, c, t))
    for i in range(3):
        jl_, jcache = step(jp, jcache, jnp.asarray(tok[:, i:i + 1]))
        tl_, tcache = tt.decode_step(tp, tc, tcache, torch.from_numpy(tok[:, i:i + 1]))
        _close(tl_, jl_, dtype)
    _assert_routing_premise(*moe_inputs, tp, tc)
    assert tcache["pos_idx"].tolist() == [3, 6, 4, 10]
    for key, ref in jax.tree.map(np.asarray, jcache).items():
        _close(tcache[key], ref, dtype)


def test_serve_loop_matches_reference(moe_inputs):
    """``ServeLoop`` over 2 slots (C = 1 a step, idle slots routed too)
    against the reference's: the same greedy tokens and caches."""
    jc, tc, jp, tp = _models("float32", seed=10)
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(0, jc.vocab, n)) for n in (5, 3, 7, 4)]
    jloop = JServeLoop(jc, jp, batch_slots=2, max_seq=32)
    loop = ServeLoop(tc, tp, batch_slots=2, max_seq=32, device="cpu")
    for i, pr in enumerate(prompts):
        jloop.submit(JRequest(i, [int(t) for t in pr], max_new=5))
        loop.submit(Request(i, [int(t) for t in pr], max_new=5))
    jreqs, reqs = list(jloop.queue), list(loop.queue)
    assert jloop.run() == [] and loop.run() == []
    _assert_routing_premise(*moe_inputs, tp, tc)
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    for key, ref in jax.tree.map(np.asarray, jloop.cache).items():
        np.testing.assert_allclose(loop.cache[key].numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_decode_without_drops(dtype):
    """With ``capacity_factor = E / K`` (C = T: no slot dropped) the
    prefill's next-token logits (materialized MLA) equal step-by-step
    decode's (absorbed MLA over the compressed cache)."""
    jc, tc = _configs(dtype)
    E, K = tc.moe.n_experts, tc.moe.top_k
    _, tc, _, tp = _models(dtype, seed=12, capacity_factor=E / K)
    tok = torch.from_numpy(_tokens(tc.vocab, (1, 12), seed=13))
    assert tm.capacity(tc, 12) == 12 and tm.capacity(tc, 1) == 1
    last = tt.prefill(tp, tc, tok)
    cache = tt.init_cache(tc, 1, 16, device="cpu")
    for i in range(tok.shape[1]):
        logits, cache = tt.decode_step(tp, tc, cache, tok[:, i:i + 1])
    _close(last[:, 0], logits[:, 0], dtype)


# ------------------------------------------------------------------- loss


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    labels[0, 3] = -100
    return {"tokens": tokens, "labels": labels}


def _port_loss_and_grads(tc, jp, batch, remat="none"):
    """The port's loss, metrics and gradients in the stacked layout."""
    model = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    leaves, treedef = tree_flatten(stack_layers(model, tc))
    ins = [x.detach().clone().requires_grad_() for x in leaves]
    shell = tt.init_params(tc, device="meta")
    bound = bind(shell, unstack_layers(shell, tc, tree_unflatten(treedef, ins)))
    loss, metrics = tt.loss_fn(bound, tc, {k: torch.as_tensor(v) for k, v in batch.items()},
                               remat=remat)
    return loss.detach(), metrics, torch.autograd.grad(loss, ins)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_fn_with_mtp_matches_reference(dtype, moe_inputs):
    """ce, aux and the MTP term, and the loss ce + 0.3 mtp + 0.01 aux."""
    jc, tc, jp, tp = _models(dtype, seed=LOSS_SEED[dtype])
    batch = _batch(tc, 2, 13, seed=LOSS_SEED[dtype] + 1)
    want, wm = jax.jit(lambda p, b: jt.loss_fn(p, jc, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_loss_and_grads(tc, jp, batch)
    _assert_routing_premise(*moe_inputs, tp, tc)
    assert set(metrics) == set(wm) == {"ce", "aux", "mtp"}
    for key in ("ce", "aux", "mtp"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(wm[key]),
                                   rtol=TOL[dtype])
    np.testing.assert_allclose(float(loss), float(want), rtol=TOL[dtype])
    np.testing.assert_allclose(
        float(loss), float((metrics["ce"] + 0.3 * metrics["mtp"] + 0.01 * metrics["aux"]).detach()),
        rtol=1e-6)
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


def test_loss_gradient_matches_reference_f32(moe_inputs):
    jc, tc, jp, tp = _models("float32", seed=16)
    batch = _batch(tc, 2, 24, seed=17)

    def jloss(params):
        return jt.loss_fn(params, jc, {k: jnp.asarray(v) for k, v in batch.items()})

    (jl_, jm_), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    loss, metrics, grads = _port_loss_and_grads(tc, jp, batch)
    _assert_routing_premise(*moe_inputs, tp, tc)
    np.testing.assert_allclose(float(loss), float(jl_), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["mtp"].detach()), float(jm_["mtp"]), rtol=1e-5)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for path, g, w in zip(paths, grads, jleaves):
        assert tuple(g.shape) == tuple(w.shape), path
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=path)
    # the MTP term reaches its own leaves and the MLA ones
    for part in ("['mtp_proj']", "['mtp']['attn']['wq']", "['attn']['w_uk']",
                 "['attn']['kv_norm']", "['attn']['w_kr']"):
        (g,) = [g for path, g in zip(paths, grads) if path.endswith(part)]
        assert float(g.abs().max()) > 0, part


def test_remat_routes_the_same():
    """``remat`` none, full and dots give the same loss and gradients bit
    for bit."""
    _, tc, jp, _ = _models("float32", seed=18)
    batch = _batch(tc, 2, 24, seed=19)
    base = _port_loss_and_grads(tc, jp, batch, "none")
    for remat in ("full", "dots"):
        loss, _, grads = _port_loss_and_grads(tc, jp, batch, remat)
        assert torch.equal(loss, base[0]), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, base[2])), remat


@pytest.mark.parametrize("smoke", [True, False])
def test_grad_buckets_follow_the_reference_tree(smoke):
    """The gradient buckets of the MLA, moe and MTP leaves in the
    reference's order: the same spec as the reference's
    ``make_bucket_spec`` of its abstract parameters."""
    cfg = get_config(ARCH, smoke=smoke)
    spec = grad_bucket_spec(cfg, TrainConfig())
    shapes = jax.eval_shape(lambda k: jt.init_params(jax_config(ARCH, smoke=smoke), k),
                            jax.random.PRNGKey(0))
    want = jax_bucket_spec(shapes, 4 << 20)
    assert (spec.leaf_sizes, spec.assignment, spec.offsets, spec.bucket_sizes) == (
        want.leaf_sizes, want.assignment, want.offsets, want.bucket_sizes)
    assert len(spec.leaf_sizes) == 4 + 2 + 9 + 7 + 9

