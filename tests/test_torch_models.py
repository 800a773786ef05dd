"""The port's model zoo (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, on the CPU, module by module.

Every check feeds the same numpy inputs (from the conftest seed) to both
packages; weights come from the JAX package's init and are carried across
with ``lm_from_params``, biases and norm scales drawn at random first
(``_torch_inputs.perturb_lm_params``).  Tolerances, all stated at the
check:

* configs, accounting, rope frequencies, logical axes: equal;
* norms, rope, attention, FFN: within 1e-5 (float32, one op order apart);
* MoE: routing indices, keeps and slots EQUAL, y within
  ``1e-5 * max(1, max|jax|)``, the aux loss within 1e-6;
* SSD / Mamba: within 1e-5 (2e-5 for the chunk padding, which sums over
  more terms);
* whole models: logits within ``1e-4 * max(1, max|jax|)``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import apply_lm as japply_lm
from repro.models import init_lm as jinit_lm
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import partitioning as jpart
from repro.models import reduced as jreduced
from repro.models import ssm as jssm
from repro.models import unbox as junbox
from repro.models.config import LM_SHAPES as JSHAPES
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import flatten_with_paths
from repro_torch import models as tm
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import partitioning as tpart
from repro_torch.models import ssm as tssm

from _torch_inputs import lm_inputs, perturb_lm_params

torch.set_num_threads(1)

ARCHS = jconfigs.ARCH_IDS
LM_TOL = 1e-4           # logits: LM_TOL * max(1, max|jax|)
OP_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=what)


def _close_scaled(got, want, tol, what=""):
    """max |got - want| <= tol * max(1, max |want|): sums whose terms cancel
    keep the error of their largest terms."""
    want = np.asarray(want, np.float64)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _cfgs(arch, **over):
    return (jreduced(jconfigs.get_config(arch), dtype="float32", **over),
            tm.reduced(tconfigs.get_config(arch), dtype="float32", **over))


@functools.lru_cache(maxsize=None)
def _boxed(arch):
    """The JAX package's Boxed tree of the reduced float32 ``arch``."""
    jcfg, _ = _cfgs(arch)
    return jinit_lm(jax.random.PRNGKey(1), jcfg)


# ----------------------------------------------------------------------- #
# Configs                                                                  #
# ----------------------------------------------------------------------- #
def test_registry_equal():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in tm.LM_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for alias, mod in tconfigs.ALIASES.items():
        assert tconfigs.get_config(alias) == tconfigs.get_config(mod)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal(arch):
    """Every field, the accounting and the layer pattern, at the published
    widths and reduced; the input specs and skip rules of every shape."""
    full_j, full_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    red_j, red_t = _cfgs(arch)
    for j, t in ((full_j, full_t), (red_j, red_t)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.block_size == j.block_size
        assert t.resolved_head_dim == j.resolved_head_dim
        assert t.ssm_heads == j.ssm_heads
        assert [(t.layer_kind(i), t.layer_ffn(i))
                for i in range(t.num_layers)] == \
            [(j.layer_kind(i), j.layer_ffn(i)) for i in range(j.num_layers)]
    for shape in JSHAPES:
        assert tconfigs.shape_supported(full_t, shape) == \
            jconfigs.shape_supported(full_j, shape)
        tspec = tconfigs.input_specs(full_t, shape)
        jspec = jconfigs.input_specs(full_j, shape)
        assert tspec.keys() == jspec.keys()
        for k, (shp, dt) in tspec.items():
            assert shp == jspec[k].shape
            assert str(dt).removeprefix("torch.") == str(jspec[k].dtype)


def test_partitioning_without_policy_is_identity():
    x = torch.ones(2, 3)
    assert tpart.constrain(x, "act_btd") is x
    assert jpart.get_policy() == {} and tpart.get_policy() == {}
    with tpart.activation_policy({}):
        assert tpart.constrain(x, "logits") is x
    # with a policy for its kind installed, a plain tensor has no mesh to
    # be placed on: it raises (kinds without a policy pass through)
    with tpart.activation_policy({"logits": ("data",)}):
        assert tpart.constrain(x, "act_btd") is x
        with pytest.raises(TypeError, match="plain tensor"):
            tpart.constrain(x, "logits")
    assert tpart.get_policy() == {}


# ----------------------------------------------------------------------- #
# Layers                                                                   #
# ----------------------------------------------------------------------- #
def test_norms(seeded_rng):
    x = seeded_rng.normal(size=(2, 5, 48)).astype(np.float32) * 3 + 1
    scale = seeded_rng.normal(size=48).astype(np.float32)
    bias = seeded_rng.normal(size=48).astype(np.float32)
    _close(tlayers.rms_norm(_t(x), _t(scale), 1e-5),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5),
           OP_TOL, "rms_norm")
    _close(tlayers.layer_norm(_t(x), _t(scale), _t(bias), 1e-5),
           jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias), 1e-5), OP_TOL,
           "layer_norm")


@pytest.mark.parametrize("arch", ["qwen2_05b", "stablelm_12b"])
def test_rope(arch, seeded_rng):
    """Interleaved pairs; stablelm rotates only a quarter of head_dim."""
    cfg = tconfigs.get_config(arch)
    hd = cfg.resolved_head_dim
    want_f = jlayers.rope_frequencies(hd, cfg.rope_fraction, cfg.rope_theta)
    got_f = tlayers.rope_frequencies(hd, cfg.rope_fraction, cfg.rope_theta)
    np.testing.assert_array_equal(got_f, want_f)
    assert got_f.shape == (int(hd * cfg.rope_fraction) // 2,)
    x = seeded_rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    pos = seeded_rng.integers(0, 4096, (2, 7)).astype(np.int32)
    _close(tlayers.apply_rope(_t(x), _t(pos), _t(got_f)),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              jnp.asarray(want_f)), OP_TOL, arch)


ATTN_CASES = {
    # name: (Sq, Skv, causal, q_offset, kv_len, chunk)
    "causal_full": (64, 64, True, 0, None, 0),
    "causal_chunked": (64, 64, True, 0, None, 16),
    "kv_len_full": (1, 12, False, 6, 7, 0),
    "kv_len_chunked": (3, 48, True, 20, 23, 16),
    "cross": (9, 24, False, 0, None, 0),
}


@pytest.mark.parametrize("case", ATTN_CASES)
def test_gqa_attention(case, seeded_rng):
    """Head h reads kv head h // G (4 query heads over 2 kv heads)."""
    Sq, Skv, causal, off, kv_len, chunk = ATTN_CASES[case]
    B, H, Hkv, D = 2, 4, 2, 8
    q = seeded_rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = seeded_rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = seeded_rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    want = jlayers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, q_offset=off,
                                 kv_len=kv_len, chunk=chunk)
    got = tlayers.gqa_attention(_t(q), _t(k), _t(v), causal=causal,
                                q_offset=off, kv_len=kv_len, chunk=chunk)
    _close(got, want, OP_TOL, case)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_ffn(act, seeded_rng):
    """GELU is the tanh approximation (``jax.nn.gelu``'s default)."""
    p = jax.tree.map(np.asarray, junbox(jlayers.init_ffn(
        jax.random.PRNGKey(3), 32, 80, act, jnp.float32))[0])
    p = perturb_lm_params(p, seeded_rng)
    x = seeded_rng.normal(size=(2, 5, 32)).astype(np.float32)
    _close(tlayers.apply_ffn({k: _t(v) for k, v in p.items()}, _t(x), act),
           jlayers.apply_ffn(p, jnp.asarray(x), act), OP_TOL, act)


# ----------------------------------------------------------------------- #
# MoE                                                                      #
# ----------------------------------------------------------------------- #
def _jax_routing(p, x, cfg):
    """The JAX package's router and dispatch plan (``models/moe.py``,
    ``apply_moe`` lines 62-89: ``lax.top_k``, stable ``argsort``,
    ``searchsorted``, overflow to slot C), returned for comparison."""
    B, S, _ = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    N = S * K
    C = max(int(np.ceil(N / E * cfg.moe_capacity_factor)), 1)
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, K)

    def group(idx_g):
        flat_e = idx_g.reshape(-1)
        flat_t = jnp.repeat(jnp.arange(S), K)
        order = jnp.argsort(flat_e, stable=True)
        se, st = flat_e[order], flat_t[order]
        seg_start = jnp.searchsorted(se, jnp.arange(E), side="left")
        rank = jnp.arange(N) - seg_start[se]
        keep = rank < C
        return se, st, keep, jnp.where(keep, rank, C)

    return (np.asarray(idx),) + tuple(np.asarray(a)
                                      for a in jax.vmap(group)(idx))


MOE_CASES = {
    # name: (arch, S, capacity factor, duplicate router columns)
    "qwen2_moe_shared": ("qwen2_moe_a27b", 16, 1.25, False),
    "llama4_top1": ("llama4_maverick", 16, 1.25, False),
    "jamba_overflow": ("jamba_v01_52b", 24, 0.5, False),
    "ties": ("qwen2_moe_a27b", 12, 1.25, True),
}


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe(case, seeded_rng):
    """Routing indices, keeps and slots equal (``ties``: two experts with
    the same router column, so top-k must break ties toward the lower
    index as ``lax.top_k`` does); y within 1e-5 * max(1, max|jax|), the
    aux loss within 1e-6."""
    arch, S, cf, dup = MOE_CASES[case]
    jcfg, tcfg = _cfgs(arch, moe_capacity_factor=cf)
    p = jax.tree.map(np.array, junbox(jmoe.init_moe(
        jax.random.PRNGKey(5), jcfg))[0])
    if dup:
        p["router"][:, 2] = p["router"][:, 0]
    x = seeded_rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    want_idx, want_se, want_st, want_keep, want_slot = _jax_routing(
        p, jnp.asarray(x), jcfg)
    tp = {k: (_t(v) if not isinstance(v, dict) else
              {kk: _t(vv) for kk, vv in v.items()}) for k, v in p.items()}
    _, idx, (se, st, _, keep, slot) = tmoe.moe_routing(tp, _t(x), tcfg)
    for got, want, what in ((idx, want_idx, "idx"), (se, want_se, "se"),
                            (st, want_st, "st"), (keep, want_keep, "keep"),
                            (slot, want_slot, "slot")):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
    if cf < 1:
        assert not want_keep.all()          # the overflow path ran
    if dup:     # expert 0 picked means a tie with expert 2 was broken
        assert (want_idx == 0).any()
    y, aux = tmoe.apply_moe(tp, _t(x), tcfg)
    jy, jaux = jax.jit(functools.partial(jmoe.apply_moe, cfg=jcfg))(
        p, jnp.asarray(x))
    _close_scaled(y, jy, OP_TOL, "y")
    assert abs(float(aux) - float(jaux)) <= 1e-6


# ----------------------------------------------------------------------- #
# SSM                                                                      #
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("S,Q", [(29, 8), (16, 16), (5, 64)])
def test_ssd_chunked(S, Q, seeded_rng):
    """S not a multiple of Q pads the last chunk."""
    B, H, P, N = 2, 3, 4, 5
    X = seeded_rng.normal(size=(B, S, H, P)).astype(np.float32)
    Bv = seeded_rng.normal(size=(B, S, H, N)).astype(np.float32)
    Cv = seeded_rng.normal(size=(B, S, H, N)).astype(np.float32)
    dt = seeded_rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    dA = -dt * 0.7
    want = jssm._ssd_chunked(*map(jnp.asarray, (X, Bv, Cv, dt, dA)), Q)
    got = tssm._ssd_chunked(*map(_t, (X, Bv, Cv, dt, dA)), Q)
    _close(got, want, 2e-5, f"S={S} Q={Q}")


def _mamba_params(cfg, rng):
    p = jax.tree.map(np.asarray, junbox(jssm.init_mamba(
        jax.random.PRNGKey(7), cfg))[0])
    return p, {k: _t(v) for k, v in perturb_lm_params(p, rng).items()}


def test_mamba_prefill_and_decode(seeded_rng):
    """``apply_mamba`` over 21 tokens (chunk 8), then one decode step from
    a random state; float32 A_log / D / dt_bias whatever the dtype."""
    jcfg, tcfg = _cfgs("mamba2_27b")
    p, tp = _mamba_params(jcfg, seeded_rng)
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    x = seeded_rng.normal(size=(2, 21, jcfg.d_model)).astype(np.float32)
    _close(tssm.apply_mamba(tp, _t(x), tcfg, chunk=8),
           jax.jit(functools.partial(jssm.apply_mamba, cfg=jcfg, chunk=8))(
               jp, jnp.asarray(x)), OP_TOL, "apply_mamba")
    st = jssm.init_mamba_state(jcfg, 2)
    h = seeded_rng.normal(size=st["h"].shape).astype(np.float32)
    conv = seeded_rng.normal(size=st["conv"].shape).astype(np.float32)
    x1 = x[:, :1]
    jy, jst = jax.jit(functools.partial(jssm.apply_mamba_decode, cfg=jcfg))(
        jp, jnp.asarray(x1), {"h": jnp.asarray(h), "conv": jnp.asarray(conv)})
    ty, tst = tssm.apply_mamba_decode(tp, _t(x1), {"h": _t(h),
                                                   "conv": _t(conv)}, tcfg)
    _close(ty, jy, OP_TOL, "decode y")
    _close(tst["h"], jst["h"], OP_TOL, "decode h")
    _close(tst["conv"], jst["conv"], 0.0, "decode conv")
    bf = tssm.init_mamba(torch.Generator().manual_seed(0),
                         dataclasses.replace(tcfg, dtype="bfloat16"))
    assert {k: b.value.dtype for k, b in bf.items()
            if k in ("A_log", "D", "dt_bias")} == dict.fromkeys(
        ("A_log", "D", "dt_bias"), torch.float32)
    assert bf["in_proj"].value.dtype == torch.bfloat16


# ----------------------------------------------------------------------- #
# Whole models                                                             #
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_lm(arch, seeded_rng):
    """Logits within 1e-4 * max(1, max|jax|), the MoE aux loss within
    1e-6, of all ten reduced float32 archs (S=16; pixtral with 8 patches
    in front, whisper with 24 encoder frames)."""
    jcfg, tcfg = _cfgs(arch)
    params = perturb_lm_params(jax.tree.map(np.asarray,
                                            junbox(_boxed(arch))[0]),
                               seeded_rng)
    model = tm.lm_from_params(tcfg, params, device="cpu")
    toks, extra = lm_inputs(jcfg, 2, 16, seeded_rng)
    want, jaux = jax.jit(functools.partial(japply_lm, jcfg))(
        params, jnp.asarray(toks),
        extra_embeds=None if extra is None else jnp.asarray(extra))
    with torch.no_grad():
        got, aux = tm.apply_lm(tcfg, model, toks, extra_embeds=extra)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= LM_TOL * scale
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_axes(arch):
    """``lm_to_params`` gives the JAX package's unboxed tree (same keys,
    shapes, dtypes and values) and ``lm_axes`` its logical axes."""
    jcfg, tcfg = _cfgs(arch)
    boxed = _boxed(arch)
    params = jax.tree.map(np.asarray, junbox(boxed)[0])
    model = tm.lm_from_params(tcfg, params, device="cpu")
    want = {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    got = dict(flatten_with_paths(tm.lm_to_params(model)))
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    want_axes = {jax.tree_util.keystr(path): b.axes for path, b in
                 jax.tree_util.tree_flatten_with_path(
                     boxed, is_leaf=lambda x: isinstance(x, jlayers.Boxed))[0]}
    assert tm.lm_axes(model) == want_axes
