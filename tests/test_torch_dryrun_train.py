"""The train step's FLOPs: the port's count against the reference's
compiled ``make_train_step``, equal except for the ops named here.

Both count matrix products only: the port's ``OpCounter`` over the plain
step on ``meta`` tensors, the reference's ``hlo_analysis.weighted_cost``
over its jitted step compiled on the CPU (microbatches 1, SMOKE configs,
B = 2).  Where the counts differ, it is by these ops, each with its
FLOPs (S <= 1024: one attention chunk):

  * ``xent_logits``: with one 512-position chunk of the LM head (S <=
    512), the port recomputes the chunk's logits ``[B*S, d] x [d, V]`` in
    the backward (``torch.utils.checkpoint``); XLA merges the
    reference's recompute with the forward's product (a scan of one trip
    is straight-line code).  Once for the LM head and once for the MTP
    head: ``2 B S d V`` each.
  * ``attention_scores_outside_loop``: the flash backward recomputes the
    scores ``Q K^T``; XLA merges that product with the forward's where
    the attention layer runs outside a loop (the MTP block; every layer
    when a config has one super-block, R = 1): ``2 B H S^2 hd_qk`` a
    layer in the port.
  * ``attention_scores_remat``: with ``remat="full"`` and R >= 2, XLA
    merges the backward's recomputed scores with the remat recompute's:
    ``2 B H S^2 hd_qk`` an attention application inside the loop.
  * ``memory_projection_remat``: with ``remat="full"`` and R = 1 the
    port's recompute of a gated cross-attention layer projects the image
    memory to its keys and values again, ``2 x 2 B T d (Hkv hd)``, which
    the reference's does not.
  * ``ssm_dt_transpose``: the reference's transposed ``dt`` scaling
    einsum is a dot, ``2 B S H P`` a Mamba2 layer, that the port's
    autograd computes as a multiply and a sum: counted by the reference
    only (negative here).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.hlo_analysis import weighted_cost as hlo_weighted_cost
from repro.train import trainer as jtr
from repro_torch.configs import get_config
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models.transformer import layer_pattern
from repro_torch.train.trainer import TrainConfig, make_train_step, train_state_shape

B = 2
SELF_ATTN = ("attn", "attn_moe", "dec", "mla_moe")
CASES = [("qwen2-0.5b", 512, "none"), ("qwen2-0.5b", 1024, "full"),
         ("zamba2-2.7b", 1024, "none"), ("zamba2-2.7b", 512, "full"),
         ("deepseek-v3-671b", 512, "none"), ("deepseek-v3-671b", 1024, "full"),
         ("llama-3.2-vision-11b", 1024, "none"), ("llama-3.2-vision-11b", 512, "full"),
         ("deepseek-moe-16b", 1024, "full")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def named_ops(cfg, S: int, remat: str) -> dict:
    """The ops by which the port's count exceeds the reference's, with
    their FLOPs (module docstring)."""
    assert S <= 1024, "one attention chunk"
    pattern, R, shared = layer_pattern(cfg)
    out = {}
    if S <= 512:
        out["xent_logits"] = (2 if cfg.mtp else 1) * 2 * B * S * cfg.d_model * cfg.vocab

    def scores(typ):
        hd = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim if typ == "mla_moe" else cfg.hd
        return 2 * B * cfg.n_heads * S * S * hd

    in_loop = R * sum(scores(t) for t in pattern if t in SELF_ATTN)
    in_loop += R * scores("attn") if shared else 0
    if R == 1:
        out["attention_scores_outside_loop"] = in_loop
    elif remat == "full":
        out["attention_scores_remat"] = in_loop
    if cfg.mtp:
        out["attention_scores_outside_loop"] = (
            out.get("attention_scores_outside_loop", 0) + scores("attn"))
    if R == 1 and remat == "full" and "xattn" in pattern:
        out["memory_projection_remat"] = pattern.count("xattn") * 2 * (
            2 * B * cfg.n_image_tokens * cfg.d_model * cfg.n_kv_heads * cfg.hd)
    n_ssm = R * pattern.count("ssm")
    if n_ssm:
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        out["ssm_dt_transpose"] = -n_ssm * 2 * B * S * heads * s.head_dim
    return {k: v for k, v in out.items() if v}


def _batch(cfg, S, make):
    b = {"tokens": make((B, S), "int32"), "labels": make((B, S), "int32")}
    if cfg.family == "vlm":
        b["memory_embeds"] = make((B, cfg.n_image_tokens, cfg.d_model), "float32")
    if cfg.family == "encdec":
        b["memory_embeds"] = make((B, cfg.n_audio_frames, cfg.d_model), "float32")
    return b


def port_flops(arch, S, remat) -> int:
    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(microbatches=1, remat=remat)
    batch = _batch(cfg, S, lambda s, dt: torch.empty(s, dtype=getattr(torch, dt),
                                                     device="meta"))
    state = train_state_shape(cfg, tcfg)
    with OpCounter() as c:
        make_train_step(cfg, tcfg)(state, batch)
    return c.flops


def reference_flops(arch, S, remat) -> float:
    cfg = jax_config(arch, smoke=True)
    tcfg = jtr.TrainConfig(microbatches=1, remat=remat)
    batch = _batch(cfg, S, lambda s, dt: jax.ShapeDtypeStruct(s, getattr(jnp, dt)))
    step = jax.jit(jtr.make_train_step(cfg, tcfg))
    text = step.lower(jtr.train_state_shape(cfg, tcfg), batch).compile().as_text()
    return hlo_weighted_cost(text)["flops_weighted"]


@pytest.mark.parametrize("arch,S,remat", CASES)
def test_train_step_flops_equal_reference_but_the_named_ops(arch, S, remat):
    named = named_ops(get_config(arch, smoke=True), S, remat)
    got, want = port_flops(arch, S, remat), reference_flops(arch, S, remat)
    assert want > 0
    assert got - want == sum(named.values()), (got, want, named)


def test_every_named_op_occurs():
    """Each name above is held by at least one case, with FLOPs."""
    seen = set()
    for arch, S, remat in CASES:
        seen |= set(named_ops(get_config(arch, smoke=True), S, remat))
    assert seen == {"xent_logits", "attention_scores_outside_loop",
                    "attention_scores_remat", "memory_projection_remat",
                    "ssm_dt_transpose"}
    assert named_ops(get_config("qwen2-0.5b", smoke=True), 1024, "none") == {}
