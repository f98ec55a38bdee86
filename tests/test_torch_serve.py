"""The port's serving slice as a whole, held against the JAX package.

On the SMOKE configs of qwen2-0.5b (GQA, qkv bias, tied embeddings),
granite-3-2b (tied embeddings, a vocab no mesh axis divides),
h2o-danube-1.8b (sliding window), mamba2-780m (ssm), stablelm-12b (as
published, and with its FULL config's heads of 160, the flash kernel's
widest) and zamba2-2.7b (hybrid: mamba layers plus one shared attention
block), the reference's
``init_params`` weights are carried across with ``params_from_jax`` and
the same token ids (numpy, from a seed) go through both packages:
``prefill`` logits, eight ``decode_step``s from the same cache, and
``ServeLoop`` against the reference's ``ServeLoop``.  Inside the port,
prefill is held against step-by-step decode (as
``tests/test_models.py::test_prefill_matches_decode``), and a decode
write at ``pos >= max_seq`` is dropped as JAX drops it.

Tolerances: with ``dtype="float32"`` logits agree within 1e-4 and greedy
token ids are equal (the two packages differ only in the order of f32
sums); with the bf16 default within 2e-2 (absolute and relative, as
``test_models.py``), bf16 rounding falling at other places in the two
frameworks.  The caches themselves are compared in f32: in bf16 an
input cached raw (the conv state) can land one bf16 step (up to 0.03 at
|x| near 4) away after a few layers of such drift.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jt
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeLoop as JServeLoop
from repro_torch.configs import get_config
from repro_torch.models import transformer as tt
from repro_torch.models.attention import write_rows
from repro_torch.models.layers import embed_apply
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.serve.engine import Request, ServeLoop, make_prefill_step

ARCHS = ["qwen2-0.5b", "granite-3-2b", "h2o-danube-1.8b", "mamba2-780m",
         "stablelm-12b", "stablelm-12b-hd160", "zamba2-2.7b"]
#: SMOKE variants: name -> (arch, fields replaced in both packages' config).
VARIANTS = {"stablelm-12b-hd160": ("stablelm-12b", {"head_dim": 160})}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's intra-op threads, and the
    other test files of a parallel run share the cores with this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype):
    arch, fields = VARIANTS.get(arch, (arch, {}))
    return (replace(jax_config(arch, smoke=True), dtype=dtype, **fields),
            replace(get_config(arch, smoke=True), dtype=dtype, **fields))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch, dtype, seed=1):
    jc, tc = _configs(arch, dtype)
    jp = jt.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_jax(_numpy(jp), tc, device="cpu")


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype):
    jc, tc, jp, tp = _models(arch, dtype)
    tok = _tokens(jc.vocab, (2, 40))
    want = jax.jit(lambda p, t: jt.prefill(p, jc, t))(jp, jnp.asarray(tok))
    got = make_prefill_step(tc)(tp, torch.from_numpy(tok))
    assert got.shape == (2, 1, tc.vocab) and got.dtype == tc.torch_dtype
    _close(got, want, dtype)
    # the plain backend is the same function on the CPU
    assert torch.equal(make_prefill_step(tc, backend="torch")(tp, torch.from_numpy(tok)), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, dtype):
    jc, tc, jp, tp = _models(arch, dtype, seed=2)
    B, S = 2, 24
    tok = _tokens(jc.vocab, (B, 8), seed=3)
    jcache = jt.init_cache(jc, B, S)
    tcache = cache_from_jax(_numpy(jcache), device="cpu")
    step = jax.jit(lambda p, c, t: jt.decode_step(p, jc, c, t))
    for i in range(8):
        jl, jcache = step(jp, jcache, jnp.asarray(tok[:, i:i + 1]))
        tl, tcache = tt.decode_step(tp, tc, tcache, torch.from_numpy(tok[:, i:i + 1]))
        _close(tl, jl, dtype)
    assert int(tcache["pos_idx"][0]) == 8
    if dtype == "float32":   # in bf16 a raw cached input may sit an ulp away
        for key, ref in _numpy(jcache).items():
            _close(tcache[key], ref, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_matches_reference(arch):
    jc, tc, jp, tp = _models(arch, "float32", seed=4)
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(0, jc.vocab, n)) for n in (5, 3, 7, 4, 6)]
    jloop = JServeLoop(jc, jp, batch_slots=2, max_seq=32)
    loop = ServeLoop(tc, tp, batch_slots=2, max_seq=32, device="cpu")
    for i, pr in enumerate(prompts):
        jloop.submit(JRequest(i, [int(t) for t in pr], max_new=6))
        loop.submit(Request(i, [int(t) for t in pr], max_new=6))
    jreqs, reqs = list(jloop.queue), list(loop.queue)
    assert jloop.run() == [] and loop.run() == []     # the reference's quirk
    assert all(r.done and len(r.out) == 6 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    for key, ref in _numpy(jloop.cache).items():
        np.testing.assert_allclose(loop.cache[key].numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode(arch, dtype):
    """Greedy next-token logits from prefill == from step-by-step decode."""
    _, tc, _, tp = _models(arch, dtype, seed=6)
    tok = torch.from_numpy(_tokens(tc.vocab, (1, 20), seed=7))
    last = tt.prefill(tp, tc, tok)
    cache = tt.init_cache(tc, 1, 24, device="cpu")
    for i in range(tok.shape[1]):
        logits, cache = tt.decode_step(tp, tc, cache, tok[:, i:i + 1])
    _close(last[:, 0], logits[:, 0].float().numpy(), dtype)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-2.7b"])
def test_decode_past_the_cache_drops_the_write(arch):
    """Slots decode past max_seq (ServeLoop advances idle slots too): the
    key and value at pos >= max_seq are dropped, as JAX drops an
    out-of-range scatter row, and every step still matches."""
    jc, tc, jp, tp = _models(arch, "float32", seed=8)
    B, S = 2, 4
    jcache = jt.init_cache(jc, B, S)
    tcache = cache_from_jax(_numpy(jcache), device="cpu")
    tcache["pos_idx"][1] = 2                   # slot 1 runs ahead
    jcache["pos_idx"] = jnp.asarray(tcache["pos_idx"].numpy())
    tok = _tokens(jc.vocab, (B, 6), seed=9)
    step = jax.jit(lambda p, c, t: jt.decode_step(p, jc, c, t))
    for i in range(6):                          # slot 1 reaches pos 7
        jl, jcache = step(jp, jcache, jnp.asarray(tok[:, i:i + 1]))
        tl, tcache = tt.decode_step(tp, tc, tcache, torch.from_numpy(tok[:, i:i + 1]))
        _close(tl, jl, "float32")
    assert tcache["pos_idx"].tolist() == [6, 8]
    for key, ref in _numpy(jcache).items():
        np.testing.assert_allclose(tcache[key].numpy(), ref, atol=1e-4, rtol=1e-4)


def test_write_rows_drops_out_of_range_rows():
    cache = torch.arange(2 * 4 * 3, dtype=torch.float32).view(2, 4, 3)
    want = np.asarray(jnp.asarray(cache.numpy()).at[jnp.arange(2), jnp.asarray([1, 4])]
                      .set(-jnp.ones((2, 3))))
    write_rows(cache, torch.tensor([1, 4], dtype=torch.int32), -torch.ones(2, 3))
    np.testing.assert_array_equal(cache.numpy(), want)
    assert (cache[0, 1] == -1).all() and (cache[1] >= 0).all()


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_embed_apply_fills_out_of_range_ids_as_jnp_take(dtype):
    """A token id outside [-vocab, vocab) gives a NaN row, as the
    reference's ``jnp.take`` (fill mode); ids inside gather, negatives
    wrapping."""
    vocab, d = 11, 5
    table = np.random.default_rng(3).normal(size=(vocab, d)).astype(np.float32)
    ids = np.asarray([[vocab, vocab + 7, -vocab - 1], [-1, 0, -vocab]])
    want = np.asarray(jnp.take(jnp.asarray(table, dtype), jnp.asarray(ids), axis=0),
                      np.float32)
    got = embed_apply(torch.from_numpy(np.asarray(jnp.asarray(table, dtype),
                                                  np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32),
        torch.from_numpy(ids)).float().numpy()
    assert np.isnan(want[0]).all() and not np.isnan(want[1]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[1], want[1])
