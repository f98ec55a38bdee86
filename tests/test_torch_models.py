"""The port's model modules, held against the JAX package piece by piece.

Configs field by field with their parameter counts; ``params_from_jax``
on the reference's ``init_params``; ``rms_norm``, ``apply_rope`` and
``swiglu_apply``; ``gqa_full`` and ``gqa_decode`` (qkv bias, GQA rep 2, a
sliding window); ``ssm_block`` on both branches; the plain
``ssd_chunked`` against the reference's and against both packages'
sequential ``ssd_reference``.  Inputs and weights are numpy arrays from a
seed (or the reference's own initializer), handed to both packages.

Tolerances: f32 pieces within 1e-5 absolute and relative (the two
packages differ only in the order of f32 sums and in libm's last bits),
the SSD scans within 1e-4 (as ``tests/test_kernels.py``), bf16 within
2e-2 (as ``tests/test_models.py``).
"""

import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_names
from repro.configs import get_config as jax_config
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import ssm as js
from repro.models import transformer as jt
from repro_torch.configs import all_arch_names as port_arch_names
from repro_torch.configs import get_config
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import ssm as ts
from repro_torch.models import transformer as tt
from repro_torch.models.common import SHAPES
from repro_torch.models.convert import params_from_jax, to_tensor

ARCHS = all_arch_names()
SERVED = ["qwen2-0.5b", "h2o-danube-1.8b", "mamba2-780m", "zamba2-2.7b", "deepseek-moe-16b",
          "llama-3.2-vision-11b", "whisper-small", "deepseek-v3-671b"]
RNG = np.random.default_rng(11)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's intra-op threads, and the
    other test files of a parallel run share the cores with this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(port, ref, tol=1e-5):
    np.testing.assert_allclose(_np(port), _np(ref), atol=tol, rtol=tol)


def _pair(arch, dtype="float32", seed=0):
    jc = replace(jax_config(arch, smoke=True), dtype=dtype)
    tc = replace(get_config(arch, smoke=True), dtype=dtype)
    jp = jt.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


# ------------------------------------------------------------- configs


def test_arch_names_match():
    assert port_arch_names() == ARCHS


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_field_by_field(arch, smoke):
    ref, port = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    if port.n_heads:
        assert port.hd == ref.hd
    assert port.torch_dtype == {"bfloat16": torch.bfloat16,
                                "float32": torch.float32}[port.dtype]


def test_shapes_match():
    from repro.models.common import SHAPES as JSHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_pattern(arch):
    cfg = get_config(arch, smoke=True)
    assert tt.layer_pattern(cfg) == jt.layer_pattern(jax_config(arch, smoke=True))


def test_full_zamba2_is_two_point_four_billion_parameters():
    cfg = get_config("zamba2-2.7b")
    assert cfg.param_count() == jax_config("zamba2-2.7b").param_count()
    assert 2.4e9 < cfg.param_count() < 2.45e9


# ---------------------------------------------------------- parameters


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVED)
def test_params_from_jax(arch, dtype):
    jc, tc, jp, tp = _pair(arch, dtype, seed=3)
    pattern, R, shared = tt.layer_pattern(tc)
    leaves = jax.tree.leaves(jp)
    assert sum(p.numel() for p in tp.parameters()) == sum(x.size for x in leaves)
    k = len(pattern)
    for name, p in tp.named_parameters():
        parts = name.split(".")
        if parts[0] in ("layers", "enc"):       # stacked over R, or the encoder
            r, i = divmod(int(parts[1]), k)
            ref, r = (jp[f"pos{i}"], r) if parts[0] == "layers" else (
                jp["enc"], int(parts[1]))
            for key in parts[2:]:
                ref = ref[key]
            ref = ref[r]
        else:
            ref = jp
            for key in parts:
                ref = ref[key]
        assert p.dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            str(ref.dtype)], name
        assert np.array_equal(_np(p), np.asarray(ref, np.float32)), name
        assert not p.requires_grad
    # the port's own initializer lays out the same shapes and dtypes
    own = tt.init_params(tc, device="cpu")
    assert [(n, p.shape, p.dtype) for n, p in own.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in tp.named_parameters()]


def test_params_from_jax_rejects_a_wrong_tree():
    jc, tc, jp, _ = _pair("qwen2-0.5b")
    tree = jax.tree.map(np.asarray, jp)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="not carried across"):
        params_from_jax(tree, tc, device="cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["ln_f"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="ln_f"):
        params_from_jax(tree, tc, device="cpu")


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rms_norm(dtype):
    x = jnp.asarray(RNG.normal(size=(3, 5, 48)) * 3, dtype)
    w = jnp.asarray(RNG.normal(size=(48,)), jnp.float32)
    tol = 1e-5 if dtype == np.float32 else 2e-2
    _close(tl.rms_norm(_t(x), _t(w), 1e-5), jl.rms_norm(x, w, 1e-5), tol)


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (80, 1e6), (64, 5e5)])
def test_apply_rope(hd, theta):
    x = jnp.asarray(RNG.normal(size=(2, 11, 3, hd)), jnp.float32)
    pos = jnp.asarray(RNG.integers(0, 4000, size=(2, 11)), jnp.int32)
    _close(tl.apply_rope(_t(x), _t(pos), theta), jl.apply_rope(x, pos, theta), 1e-4)
    np.testing.assert_array_equal(tl.rope_freqs(hd, theta), jl.rope_freqs(hd, theta))


def test_swiglu_apply():
    key = jax.random.PRNGKey(5)
    p = jl.swiglu_init(key, 32, 72, jnp.float32)
    x = jnp.asarray(RNG.normal(size=(2, 7, 32)), jnp.float32)
    port = tl.SwiGLU(torch.Generator().manual_seed(0), 32, 72, torch.float32)
    for name in ("w_gate", "w_up", "w_down"):
        getattr(port, name).data.copy_(_t(p[name]))
    _close(tl.swiglu_apply(port, _t(x)), jl.swiglu_apply(p, x))


# ------------------------------------------------------------- attention


def _gqa_pair(jc, tc, seed):
    p = ja.gqa_init(jax.random.PRNGKey(seed), jc, jc.jdtype)
    if jc.qkv_bias:              # nonzero biases, so they count
        for b in ("bq", "bk", "bv"):
            p[b] = jnp.asarray(RNG.normal(size=p[b].shape) * 0.5, p[b].dtype)
    port = ta.GQA(torch.Generator().manual_seed(0), tc, tc.torch_dtype)
    for name, value in p.items():
        getattr(port, name).data.copy_(_t(value))
    return p, port


ATTN_CASES = {
    "qkv_bias_gqa2": dict(n_heads=4, n_kv_heads=2),
    "window": dict(n_heads=4, n_kv_heads=2, sliding_window=9),
    "hd80_mha": dict(d_model=160, n_heads=2, n_kv_heads=2, head_dim=80),
}


def _attn_configs(case, dtype):
    over = {"dtype": dtype, "d_model": 64, "qkv_bias": case == "qkv_bias_gqa2",
            **ATTN_CASES[case]}
    return (replace(jax_config("qwen2-0.5b", smoke=True), **over),
            replace(get_config("qwen2-0.5b", smoke=True), **over))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_gqa_full(case, dtype):
    jc, tc = _attn_configs(case, dtype)
    p, port = _gqa_pair(jc, tc, seed=7)
    B, S = 2, 37
    x = jnp.asarray(RNG.normal(size=(B, S, jc.d_model)), jc.jdtype)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    want, (wk, wv) = jax.jit(lambda p, x, pos: ja.gqa_full(p, x, jc, pos))(p, x, pos)
    for backend in ("cuda", "torch"):
        got, (gk, gv) = ta.gqa_full(port, _t(x), tc, _t(pos), backend=backend)
        tol = 1e-5 if dtype == "float32" else 2e-2
        _close(got, want, tol)
        _close(gk, wk, tol)
        _close(gv, wv, tol)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_gqa_decode(case):
    jc, tc = _attn_configs(case, "float32")
    p, port = _gqa_pair(jc, tc, seed=8)
    B, S = 3, 12
    ck = jnp.asarray(RNG.normal(size=(B, S, jc.n_kv_heads, jc.hd)), jnp.float32)
    cv = jnp.asarray(RNG.normal(size=(B, S, jc.n_kv_heads, jc.hd)), jnp.float32)
    x = jnp.asarray(RNG.normal(size=(B, 1, jc.d_model)), jnp.float32)
    pos = jnp.asarray([3, 11, 12], jnp.int32)       # the last one past the cache
    want, wk, wv = ja.gqa_decode(p, x, jc, ck, cv, pos)
    tk, tv = _t(ck), _t(cv)
    got, gk, gv = ta.gqa_decode(port, _t(x), tc, tk, tv, _t(pos))
    assert gk is tk and gv is tv                     # updated in place
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    np.testing.assert_array_equal(_np(gk[2]), np.asarray(ck[2]))   # write dropped


# ------------------------------------------------------------------ ssm


def _ssm_pair(arch, seed, **ssm_over):
    jc = jax_config(arch, smoke=True)
    tc = get_config(arch, smoke=True)
    jc = replace(jc, dtype="float32", ssm=replace(jc.ssm, **ssm_over))
    tc = replace(tc, dtype="float32", ssm=replace(tc.ssm, **ssm_over))
    p = js.ssm_init(jax.random.PRNGKey(seed), jc, jnp.float32)
    p["dt_bias"] = jnp.asarray(RNG.normal(size=p["dt_bias"].shape) * 0.5, jnp.float32)
    p["D"] = jnp.asarray(RNG.normal(size=p["D"].shape), jnp.float32)
    port = ts.Mamba2(torch.Generator().manual_seed(0), tc, torch.float32)
    for name, value in p.items():
        getattr(port, name).data.copy_(_t(value))
    return jc, tc, p, port


@pytest.mark.parametrize("arch,ssm_over", [
    ("mamba2-780m", {}), ("zamba2-2.7b", {}),
    ("mamba2-780m", {"n_groups": 2, "chunk": 16})])    # two groups, ragged chunk
def test_ssm_block_full_sequence(arch, ssm_over):
    jc, tc, p, port = _ssm_pair(arch, 12, **ssm_over)
    x = jnp.asarray(RNG.normal(size=(2, 45, jc.d_model)), jnp.float32)
    want = jax.jit(lambda p, x: js.ssm_block(p, x, jc))(p, x)
    for backend in ("cuda", "torch"):
        _close(ts.ssm_block(port, _t(x), tc, backend=backend), want, 1e-4)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_block_decode(arch):
    jc, tc, p, port = _ssm_pair(arch, 13)
    s, B = jc.ssm, 3
    d_in = s.expand * jc.d_model
    nh = d_in // s.head_dim
    conv = jnp.asarray(RNG.normal(size=(B, s.d_conv - 1, d_in + 2 * s.n_groups * s.d_state)),
                       jnp.float32)
    state = jnp.asarray(RNG.normal(size=(B, nh, s.d_state, s.head_dim)), jnp.float32)
    x = jnp.asarray(RNG.normal(size=(B, 1, jc.d_model)), jnp.float32)
    want, wconv, wstate = js.ssm_block(p, x, jc, conv_state=conv, ssd_state=state)
    tconv, tstate = _t(conv), _t(state)
    got, gconv, gstate = ts.ssm_block(port, _t(x), tc, conv_state=tconv, ssd_state=tstate)
    assert gconv is tconv and gstate is tstate       # updated in place
    _close(got, want)
    _close(gconv, wconv)
    _close(gstate, wstate)


def _ssd_inputs(B, S, H, P, G, N):
    return (RNG.normal(size=(B, S, H, P)).astype(np.float32),
            RNG.normal(size=(B, S, G, N)).astype(np.float32),
            RNG.normal(size=(B, S, G, N)).astype(np.float32),
            RNG.uniform(0.01, 0.2, size=(B, S, H)).astype(np.float32),
            np.log(RNG.uniform(0.5, 2, size=(H,))).astype(np.float32),
            RNG.normal(size=(H,)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 48, 4, 8, 2, 4, 16), (1, 70, 2, 16, 1, 8, 32), (1, 17, 3, 4, 3, 2, 8),
    (2, 40, 4, 8, 2, 4, 64)])
def test_ssd_chunked(B, S, H, P, G, N, chunk):
    ins = _ssd_inputs(B, S, H, P, G, N)
    want = jax.jit(js.ssd_chunked, static_argnums=6)(*map(jnp.asarray, ins), chunk)
    got = ts.ssd_chunked(*map(torch.from_numpy, ins), chunk)
    _close(got, want, 1e-4)
    seq = ts.ssd_reference(*map(torch.from_numpy, ins))
    _close(seq, jax.jit(js.ssd_reference)(*map(jnp.asarray, ins)), 1e-4)
    _close(got, seq, 1e-4)
