"""The port's sharding rules, mesh and train-state shapes against the JAX
package's.

``param_pspecs`` (with and without ``no_fsdp``, both EP modes),
``batch_pspecs`` and ``cache_pspecs`` (both ``CACHE_SEQ_SHARD`` values)
give the reference's spec for every leaf, by its key path, for all ten
configs at FULL and SMOKE on 16 x 16, 2 x 16 x 16, 4 x 2 and 8 x 1
meshes.  The reference runs on ``jax.sharding.AbstractMesh``, which needs
no devices, over ``jax.eval_shape`` trees; the port over ``meta``
tensors.  ``train_state_shape`` gives the reference's shapes and dtypes,
leaf for leaf, with auto and compressed sync (``gsync_err`` ``[dp,
bucket]``).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import all_arch_names
from repro.configs import get_config as jax_config
from repro.models import transformer as jt
from repro.train import sharding as js
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config
from repro_torch.core.tree import path_key, tree_flatten_with_path
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tt
from repro_torch.models.convert import stack_layers
from repro_torch.train import TrainConfig, train_state_shape
from repro_torch.train import sharding as ts

ARCHS = all_arch_names()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}


@pytest.fixture(autouse=True)
def _default_modes():
    """Both packages' module-wide modes back at their defaults after a
    test, whatever it set."""
    yield
    for mod in (js, ts):
        mod.set_ep_mode("2d")
        mod.set_cache_seq_shard(True)


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), tmesh.Mesh(sizes, names)


def _jkey(path) -> str:
    return "/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)


def _ref_specs(tree):
    pairs = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(_jkey(p), tuple(s)) for p, s in pairs]


def _port_specs(tree):
    pairs = tree_flatten_with_path(tree)[0]
    assert all(isinstance(s, ts.PartitionSpec) for _, s in pairs)
    return [(path_key(p), tuple(s)) for p, s in pairs]


@functools.lru_cache(maxsize=None)
def _ref_params(arch, smoke):
    cfg = jax_config(arch, smoke=smoke)
    return cfg, jax.eval_shape(lambda k: jt.init_params(cfg, k), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch, smoke):
    cfg = get_config(arch, smoke=smoke)
    return cfg, stack_layers(tt.init_params(cfg, device="meta"), cfg)


def test_production_and_host_meshes():
    """The reference's production meshes need 256 or 512 devices, so
    their shapes are held against an AbstractMesh of the same sizes."""
    for multi in (False, True):
        got = tmesh.make_production_mesh(multi_pod=multi)
        sizes, names = MESHES["2x16x16" if multi else "16x16"]
        ref = AbstractMesh(sizes, names)
        assert got.shape == ref.shape and got.axis_names == ref.axis_names
        assert got.size == (512 if multi else 256)
    # a deliberate difference: one card has no ambient mesh to set
    assert not hasattr(tmesh, "set_global_mesh")
    host = tmesh.make_host_mesh(5, "x")
    assert dict(host.shape) == {"x": 5} and host.axis_names == ("x",)
    with pytest.raises(ValueError, match="does not match"):
        tmesh.Mesh((2, 2), ("data",))
    for name in MESHES:
        jm, tm = _meshes(name)
        assert ts.mesh_axes(tm) == js.mesh_axes(jm)
        assert ts.ep_axes(tm) == js.ep_axes(jm)


def test_partition_spec_entries_normalise_as_jax():
    cases = [("a", None), (("a",), "b"), ((), None), (("a", "b"), None), ()]
    for case in cases:
        assert tuple(ts.P(*case)) == tuple(JP(*case)), case
    assert ts.P("a") == ("a",) and ts.P() == ()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, smoke, mesh):
    jcfg, jshapes = _ref_params(arch, smoke)
    tcfg, tshapes = _port_params(arch, smoke)
    jm, tm = _meshes(mesh)
    for ep in ("2d", "full"):
        js.set_ep_mode(ep)
        ts.set_ep_mode(ep)
        for no_fsdp in (False, True):
            want = _ref_specs(js.param_pspecs(jcfg, jshapes, jm, no_fsdp=no_fsdp))
            got = _port_specs(ts.param_pspecs(tcfg, tshapes, tm, no_fsdp=no_fsdp))
            assert got == want, (ep, no_fsdp)


def _batch_shapes(cfg, B, S):
    out = {"tokens": (B, S), "labels": (B, S)}
    if cfg.family in ("vlm", "encdec"):
        T = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
        out["memory_embeds"] = (B, T, cfg.d_model)
    return out


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspecs_match_reference(arch, smoke):
    cfg = get_config(arch, smoke=smoke)
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for B, S in ((32, 64), (8, 16), (1, 7)):
            shapes = _batch_shapes(cfg, B, S)
            want = js.batch_pspecs(jax_config(arch, smoke=smoke), jm, {
                k: jax.ShapeDtypeStruct(v, np.int32) for k, v in shapes.items()})
            got = ts.batch_pspecs(cfg, tm, {k: torch.empty(v, device="meta")
                                            for k, v in shapes.items()})
            assert sorted(got) == sorted(want)
            assert {k: tuple(v) for k, v in got.items()} == {
                k: tuple(v) for k, v in want.items()}, (mesh, B)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch, smoke):
    jcfg, tcfg = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    memory = tcfg.family in ("vlm", "encdec")
    for B, S in ((32, 256), (3, 40)):
        T = tcfg.n_image_tokens if tcfg.family == "vlm" else tcfg.n_audio_frames
        mem_shape = (B, T, tcfg.d_model) if memory else None

        def ref_cache(mem):
            return jt.init_cache(jcfg, B, S, memory=mem)

        jshapes = jax.eval_shape(ref_cache, jax.ShapeDtypeStruct(mem_shape, np.float32)
                                 if memory else None)
        tshapes = tt.init_cache(tcfg, B, S, device="meta", memory=torch.empty(
            mem_shape, device="meta") if memory else None)
        assert sorted(tshapes) == sorted(jshapes)
        assert all(tuple(tshapes[k].shape) == tuple(jshapes[k].shape) for k in jshapes)
        for flag in (True, False):
            js.set_cache_seq_shard(flag)
            ts.set_cache_seq_shard(flag)
            for mesh in MESHES:
                jm, tm = _meshes(mesh)
                want = js.cache_pspecs(jcfg, jm, jshapes)
                got = ts.cache_pspecs(tcfg, tm, tshapes)
                assert {k: tuple(v) for k, v in got.items()} == {
                    k: tuple(v) for k, v in want.items()}, (flag, mesh, B)


def test_fit_spec_drops_axes_that_do_not_divide():
    jm, tm = _meshes("2x16x16")
    for spec, shape in (((("pod", "data"), "model"), (64, 49155)),
                        (("model", None, ("pod", "data")), (16, 3, 32)),
                        (("data", "model"), (1,)), ((None, "model"), (5, 32))):
        want = js.fit_spec(JP(*spec), shape, jm)
        got = ts.fit_spec(ts.P(*spec), shape, tm)
        assert tuple(got) == tuple(want), (spec, shape)


def _ref_state_leaves(tree):
    return [(_jkey(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_state_leaves(tree):
    return [(path_key(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("grad_sync", ["auto", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_shape_matches_reference(arch, grad_sync):
    """At FULL (deepseek-v3-671b included), with no storage: compressed
    at dp = 4 carries [4, bucket] error buckets."""
    dp = 4
    jm = AbstractMesh((dp,), ("data",))
    want = jtrainer.train_state_shape(
        jax_config(arch), jtrainer.TrainConfig(grad_sync=grad_sync), mesh=jm)
    got = train_state_shape(get_config(arch), TrainConfig(grad_sync=grad_sync), dp=dp)
    assert all(x.device.type == "meta" for _, x in tree_flatten_with_path(got)[0])
    assert _port_state_leaves(got) == _ref_state_leaves(want)
    if grad_sync == "compressed":
        assert all(e.shape[0] == dp for e in got["gsync_err"])
