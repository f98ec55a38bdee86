"""The port's memory families (vlm, encdec) held against the JAX package.

On the SMOKE configs of llama-3.2-vision-11b (``llama-vision-smoke``: 5
layers, the 5th a gated cross-attention layer, 17 image tokens) and
whisper-small (``whisper-smoke``: 2 encoder and 2 decoder layers, 30
audio frames), the reference's ``init_params`` weights are carried
across with ``params_from_jax`` and the same token ids and frontend
embeddings (numpy, from a seed) go through both packages:
``gelu_mlp_apply``, ``cross_attn_apply`` with fewer queries than memory
rows and more, ``encode_memory``, ``forward`` and ``prefill`` with
``memory_embeds``, ``init_cache(memory=)``, decode steps with a memory
cache, and ``loss_fn`` with ``memory_embeds``.  The reference runs
jitted.

The vlm cross-attention gate is zero at init, so ``tanh(gate) * h``
makes the cross-attention layers add exactly nothing: every vlm
comparison sets each ``xattn`` gate to 0.5 in the reference's tree
before it is carried across, so both packages run the same non-zero
gate, and one test pins that with the gate at 0 the cross-attention
weights do not reach the logits.

Tolerances: f32 within 1e-5 absolute and relative (the two packages
differ only in the order of f32 sums and libm's last bits); bf16 within
2e-2 (as ``tests/test_models.py``): JAX computes the tanh GELU op by op
in bf16 where torch computes it in f32 and rounds once, and bf16
rounding falls at other places in the two frameworks.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.models import attention as ta
from repro_torch.models import encode_memory
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (
    cache_from_jax,
    params_from_jax,
    stack_layers,
    to_tensor,
    unstack_layers,
)
from repro_torch.serve.engine import ServeLoop, make_prefill_step

ARCHS = ["llama-3.2-vision-11b", "whisper-small"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GATE = 0.5
RNG = np.random.default_rng(25)


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
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _close(port, ref, dtype):
    np.testing.assert_allclose(_np(port), _np(ref), atol=TOL[dtype], rtol=TOL[dtype])


def _set_gates(tree, value):
    """Every ``xattn`` position's gate (stacked [R, 1]) set to ``value``."""
    for key, sub in tree.items():
        if isinstance(sub, dict) and "gate" in sub:
            sub["gate"] = jnp.full_like(sub["gate"], value)
    return tree


def _models(arch, dtype, seed=1, gate=GATE):
    jc = replace(jax_config(arch, smoke=True), dtype=dtype)
    tc = replace(get_config(arch, smoke=True), dtype=dtype)
    jp = _set_gates(jt.init_params(jc, jax.random.PRNGKey(seed)), gate)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _memory_len(cfg):
    return cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames


def _inputs(cfg, B, S, seed=0):
    """Token ids [B, S] and frontend embeddings [B, T, d] f32."""
    rng = np.random.default_rng(seed)
    mem = rng.standard_normal((B, _memory_len(cfg), cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (B, S)), mem


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_apply(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    p = jl.gelu_mlp_init(jax.random.PRNGKey(5), 32, 72, jdt)
    x = jnp.asarray(RNG.normal(size=(2, 7, 32)) * 2, jdt)
    port = tl.GeluMLP(torch.Generator().manual_seed(0), 32, 72, torch.float32)
    for name in ("w_in", "w_out"):
        setattr(port, name, tl.param(to_tensor(np.asarray(p[name]), "cpu")))
    got = tl.gelu_mlp_apply(port, to_tensor(np.asarray(x), "cpu"))
    assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    _close(got, jl.gelu_mlp_apply(p, x), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,T", [(9, 17), (23, 5), (1, 30)])
def test_cross_attn_apply(S, T, dtype):
    """Queries [B, S] over a memory of T rows, S != T, GQA rep 2."""
    jc = replace(jax_config("llama-3.2-vision-11b", smoke=True), dtype=dtype)
    tc = replace(get_config("llama-3.2-vision-11b", smoke=True), dtype=dtype)
    p = ja.cross_attn_init(jax.random.PRNGKey(6), jc, jc.jdtype)
    port = ta.CrossAttention(torch.Generator().manual_seed(0), tc, tc.torch_dtype)
    for name, value in p.items():
        getattr(port, name).data.copy_(to_tensor(np.asarray(value), "cpu"))
    x = jnp.asarray(RNG.normal(size=(2, S, jc.d_model)), jc.jdtype)
    mem = jnp.asarray(RNG.normal(size=(2, T, jc.d_model)), jc.jdtype)
    want = jax.jit(lambda p, x, m: ja.cross_attn_apply(p, x, m, jc))(p, x, mem)
    tx, tm = (to_tensor(np.asarray(a), "cpu") for a in (x, mem))
    for backend in ("cuda", "torch"):
        got = ta.cross_attn_apply(port, tx, tm, tc, backend=backend)
        assert got.shape == (2, S, tc.d_model) and got.dtype == tc.torch_dtype
        _close(got, want, dtype)


# ------------------------------------------------------------ parameters


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_the_stacked_layout(arch):
    """``stack_layers`` gives back the reference's tree, leaf for leaf
    (``enc`` stacked over the encoder's depth), and ``unstack_layers``
    gives back every parameter."""
    jc, tc, jp, tp = _models(arch, "float32", seed=3)
    tree = stack_layers(tp, tc)
    flat_ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_ref) == len(jax.tree.leaves(tree))
    for path, ref in flat_ref:
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(_np(node), np.asarray(ref, np.float32))
    back = unstack_layers(tp, tc, tree)
    for name, p in tp.named_parameters():
        assert torch.equal(back[name], p), name


# ---------------------------------------------------------------- memory


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_encode_memory(arch, dtype):
    jc, tc, jp, tp = _models(arch, dtype, seed=4)
    _, mem = _inputs(jc, 2, 1, seed=5)
    want = jax.jit(lambda p, m: jt.encode_memory(p, jc, m))(jp, jnp.asarray(mem))
    got = encode_memory(tp, tc, torch.from_numpy(mem))
    assert got.shape == want.shape and str(got.dtype)[6:] == str(want.dtype)
    _close(got, want, dtype)
    if tc.family == "vlm":          # the embeddings as given, projected per call
        assert torch.equal(encode_memory(tp, tc, torch.from_numpy(mem)),
                           torch.from_numpy(mem))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    jc, tc, jp, tp = _models(arch, dtype, seed=6)
    tok, mem = _inputs(jc, 2, 13, seed=7)
    want, _ = jax.jit(lambda p, t, m: jt.forward(p, jc, t, memory_embeds=m))(
        jp, jnp.asarray(tok), jnp.asarray(mem))
    for backend in ("cuda", "torch"):
        got, aux = tt.forward(tp, tc, torch.from_numpy(tok),
                              memory_embeds=torch.from_numpy(mem), backend=backend)
        assert got.shape == (2, 13, tc.vocab) and got.dtype == tc.torch_dtype
        assert float(aux) == 0.0
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype):
    jc, tc, jp, tp = _models(arch, dtype, seed=8)
    tok, mem = _inputs(jc, 3, 21, seed=9)
    want = jax.jit(lambda p, t, m: jt.prefill(p, jc, t, memory_embeds=m))(
        jp, jnp.asarray(tok), jnp.asarray(mem))
    got = make_prefill_step(tc)(tp, torch.from_numpy(tok), torch.from_numpy(mem))
    assert got.shape == (3, 1, tc.vocab) and got.dtype == tc.torch_dtype
    _close(got, want, dtype)
    # the plain backend is the same function on the CPU
    plain = make_prefill_step(tc, backend="torch")(tp, torch.from_numpy(tok),
                                                   torch.from_numpy(mem))
    assert torch.equal(plain, got)


def test_zero_gate_keeps_cross_attention_out_of_the_logits():
    """With the reference's init gate (0), the vlm cross-attention weights
    and the image embeddings do not reach the logits; with gate 0.5 they
    do.  So a vlm comparison must set the gate."""
    arch = "llama-3.2-vision-11b"
    jc, tc, jp, tp = _models(arch, "float32", seed=10, gate=0.0)
    tok, mem = _inputs(jc, 2, 11, seed=11)
    want = jax.jit(lambda p, t, m: jt.prefill(p, jc, t, memory_embeds=m))(
        jp, jnp.asarray(tok), jnp.asarray(mem))
    base = tt.prefill(tp, tc, torch.from_numpy(tok), memory_embeds=torch.from_numpy(mem))
    _close(base, want, "float32")
    xattn = tp.layers[4].xattn
    for w in (xattn.wq, xattn.wk, xattn.wv, xattn.wo):
        w.data.mul_(-3.0)
    other = tt.prefill(tp, tc, torch.from_numpy(tok),
                       memory_embeds=torch.from_numpy(2 * mem + 1))
    assert torch.equal(other, base)
    tp.layers[4].gate.data.fill_(GATE)
    gated = tt.prefill(tp, tc, torch.from_numpy(tok),
                       memory_embeds=torch.from_numpy(mem))
    assert float((gated - base).abs().max()) > 1e-3


# ----------------------------------------------------------------- decode


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    jc, tc, jp, tp = _models(arch, "bfloat16", seed=12)
    _, mem = _inputs(jc, 3, 1, seed=13)
    jmem = jax.jit(lambda p, m: jt.encode_memory(p, jc, m))(jp, jnp.asarray(mem))
    want = jt.init_cache(jc, 3, 10, memory=jmem)
    tmem = encode_memory(tp, tc, torch.from_numpy(mem))
    got = tt.init_cache(tc, 3, 10, memory=tmem, device="cpu")
    assert list(got) == list(want)
    assert got["memory"] is tmem                # stored as given
    for key, ref in want.items():
        assert tuple(got[key].shape) == ref.shape, key
        assert str(got[key].dtype)[6:] == str(ref.dtype), key
    pattern, _, _ = tt.layer_pattern(tc)
    for i, typ in enumerate(pattern):           # no cache for xattn positions
        assert (f"pos{i}_k" in got) == (typ != "xattn")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, dtype):
    jc, tc, jp, tp = _models(arch, dtype, seed=14)
    B, S = 2, 16
    tok, mem = _inputs(jc, B, 7, seed=15)
    jmem = jax.jit(lambda p, m: jt.encode_memory(p, jc, m))(jp, jnp.asarray(mem))
    jcache = jt.init_cache(jc, B, S, memory=jmem)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    step = jax.jit(lambda p, c, t: jt.decode_step(p, jc, c, t))
    for i in range(tok.shape[1]):
        jl_, jcache = step(jp, jcache, jnp.asarray(tok[:, i:i + 1]))
        tl_, tcache = tt.decode_step(tp, tc, tcache, torch.from_numpy(tok[:, i:i + 1]))
        _close(tl_, jl_, dtype)
    assert tcache["pos_idx"].tolist() == [7, 7]
    if dtype == "float32":   # in bf16 a cached key may sit an ulp away
        for key, ref in jax.tree.map(np.asarray, jcache).items():
            _close(tcache[key], ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode(arch, dtype):
    """Next-token logits from prefill == from step-by-step decode over a
    cache holding the same memory (``encode_memory``)."""
    _, tc, _, tp = _models(arch, dtype, seed=16)
    tok, mem = _inputs(tc, 1, 12, seed=17)
    tok, mem = torch.from_numpy(tok), torch.from_numpy(mem)
    last = tt.prefill(tp, tc, tok, memory_embeds=mem)
    cache = tt.init_cache(tc, 1, 16, memory=encode_memory(tp, tc, mem), device="cpu")
    for i in range(tok.shape[1]):
        logits, cache = tt.decode_step(tp, tc, cache, tok[:, i:i + 1])
    _close(last[:, 0], logits[:, 0], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_without_memory_raises(arch):
    """A deliberate difference: the reference fails on ``None`` with an
    AttributeError; the port names the missing memory."""
    _, tc, _, tp = _models(arch, "float32", seed=18)
    cache = tt.init_cache(tc, 2, 8, device="cpu")
    assert "memory" not in cache
    with pytest.raises(ValueError, match='no "memory"'):
        tt.decode_step(tp, tc, cache, torch.zeros((2, 1), dtype=torch.long))
    with pytest.raises(ValueError, match="memory_embeds"):
        tt.prefill(tp, tc, torch.zeros((2, 3), dtype=torch.long))


def test_reset_slot_keeps_the_memory():
    """A memory of [B, T, d] with T == B is not a stacked cache: admitting
    a request into slot i leaves its column i alone (the reference's
    ``_reset_slot`` skips "memory")."""
    tc = replace(get_config("whisper-small", smoke=True), dtype="float32",
                 n_audio_frames=3)
    tp = tt.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    loop = ServeLoop(tc, tp, batch_slots=3, max_seq=8, device="cpu")
    mem = torch.randn((3, 3, tc.d_model), generator=torch.Generator().manual_seed(1))
    loop.cache = tt.init_cache(tc, 3, 8, memory=mem.clone(), device="cpu")
    loop.cache["pos0_k"].fill_(1.0)
    loop._reset_slot(1)
    assert torch.equal(loop.cache["memory"], mem)
    assert not loop.cache["pos0_k"][:, 1].any() and loop.cache["pos0_k"][:, 0].all()


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    jc, tc, jp, tp = _models(arch, "float32", seed=19)
    tok, mem = _inputs(jc, 2, 15, seed=20)
    labels = np.where(RNG.random(tok.shape) < 0.2, -100, np.roll(tok, -1, axis=1))
    batch = {"tokens": tok, "labels": labels, "memory_embeds": mem}
    want, wm = jax.jit(lambda p, b: jt.loss_fn(p, jc, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, gm = tt.loss_fn(tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got, want, "float32")
    _close(gm["ce"], wm["ce"], "float32")
