"""The port's training path (``repro_torch.training``,
``repro_torch.data.BatchPipeline``, ``repro_torch.launch.train``) against
the JAX package's, on the CPU.

Weights come from the JAX package's init (biases and norm scales drawn
at random, ``_torch_inputs.perturb_lm_params``) carried across with
``lm_from_params``; inputs are numpy arrays from a seed.  Tolerances,
each stated at its check:

* AdamW: parameters and moments within ``1e-6 * max(1, max|jax|)``,
  ``grad_norm`` and ``lr`` within 1e-6 relative (float32, one rounding
  order apart: the global norm's sum);
* loss within 1e-5 relative, every gradient leaf within
  ``1e-4 * max(1, max|jax leaf|)`` of ``jax.value_and_grad``'s, MoE
  routing indices equal;
* a train step's parameters within 5e-3 (``tests/test_training.py``'s
  bound for microbatch accumulation);
* gradient compression, pipeline batches: equal;
* the driver: losses within 1e-4 relative across packages, and a
  checkpoint written by either package resumes in the other.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro import models as jm
from repro import training as jt
from repro.data import BatchPipeline as JPipeline
from repro.data import CompressedCorpus as JCorpus
from repro.data import synthetic as jsynthetic
from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch import training as tt
from repro_torch.checkpoint import flatten_with_paths
from repro_torch.data import BatchPipeline, CompressedCorpus, synthetic
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer

from _torch_inputs import lm_inputs, perturb_lm_params
from test_torch_models import _jax_routing

torch.set_num_threads(1)

OPT_TOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 5e-3          # tests/test_training.py:127
DRIVER_RTOL = 1e-4
FAMILY_ARCHS = ["qwen2_05b", "qwen2_moe_a27b", "llama4_maverick",
                "jamba_v01_52b", "mamba2_27b", "whisper_large_v3",
                "pixtral_12b"]
B, S = 2, 12


def _np(x):
    """A tensor or array as numpy; bfloat16 widened to float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _flat(tree):
    """``{keystr: numpy}`` of a JAX or a port tree."""
    if any(isinstance(v, torch.Tensor) for _, v in flatten_with_paths(tree)):
        return {k: _np(v) for k, v in flatten_with_paths(tree)}
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            if v.dtype == jnp.bfloat16 else np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _scaled_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max(initial=0.0)) / max(
        1.0, float(np.abs(want).max(initial=0.0)))


def _trees_close(got, want, tol, what):
    g, w = _flat(got), _flat(want)
    assert list(g) == list(w), what
    for k in w:
        err = _scaled_err(g[k], w[k])
        assert err <= tol, f"{what} {k}: {err:.3g} of scale (bound {tol})"


# ----------------------------------------------------------------------- #
# AdamW                                                                    #
# ----------------------------------------------------------------------- #
OPT_SHAPES = {"w": (16, 9), "b": (9,), "blocks": [{"k": (3, 4, 5)},
                                                 {"k": (2, 2)}]}


def _opt_tree(rng, scale=1.0):
    def leaf(s):
        return (scale * rng.normal(size=s)).astype(np.float32)
    return {"w": leaf(OPT_SHAPES["w"]), "b": leaf(OPT_SHAPES["b"]),
            "blocks": [{"k": leaf(b["k"])} for b in OPT_SHAPES["blocks"]]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_matches_jax(dtype, schedule, seeded_rng):
    """Five updates with clipping (the gradients' norm is above
    ``clip_norm``), warmup and the schedule: parameters and moments
    within 1e-6 of scale, ``grad_norm`` and ``lr`` within 1e-6."""
    kw = dict(lr=0.05, clip_norm=1.0, warmup_steps=2, schedule=schedule,
              total_steps=5, weight_decay=0.1)
    jopt, topt = jt.AdamW(**kw), tt.AdamW(**kw)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    p0 = _opt_tree(seeded_rng)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), p0)
    # torch's own copy: the update writes ``tp`` in place while the
    # jitted JAX update may still be reading ``jp``, which can alias p0
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(td), p0)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    assert tstate.count.dtype == torch.int32
    update = jax.jit(jopt.update)
    for _ in range(5):
        g = _opt_tree(seeded_rng, scale=3.0)
        jp, jstate, jmet = update(
            jax.tree.map(lambda a: jnp.asarray(a).astype(jd), g), jstate, jp)
        got = topt.update(jax.tree.map(lambda a: torch.from_numpy(a).to(td),
                                       g), tstate, tp)
        assert got[0] is tp                       # written in place
        _, tstate, tmet = got
        assert float(jmet["grad_norm"]) > kw["clip_norm"]
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=OPT_TOL)
        _trees_close(tp, jp, OPT_TOL, "params")
        _trees_close(tstate.mu, jstate.mu, OPT_TOL, "mu")
        _trees_close(tstate.nu, jstate.nu, OPT_TOL, "nu")
        assert int(tstate.count) == int(jstate.count)
        assert all(v.dtype == torch.float32 for _, v in
                   flatten_with_paths((tstate.mu, tstate.nu)))


def test_adamw_decreases_quadratic():
    opt = tt.AdamW(lr=0.1, weight_decay=0.0, clip_norm=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.3


def test_adamw_grad_clip_reported():
    opt = tt.AdamW(lr=0.0, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    _, _, m = opt.update({"w": torch.tensor([3.0, 4.0, 0.0])}, state, params)
    assert abs(float(m["grad_norm"]) - 5.0) < 1e-5


# ----------------------------------------------------------------------- #
# Loss and gradients                                                       #
# ----------------------------------------------------------------------- #
def test_cross_entropy_matches_jax(seeded_rng):
    """``gather`` against the one-hot contraction: equal to the last bit
    for the gold logit; the CE and z-loss within 1e-5 relative, with and
    without a mask."""
    logits = (4 * seeded_rng.normal(size=(3, 7, 50))).astype(np.float32)
    labels = seeded_rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (seeded_rng.random((3, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = jt.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
        got = tt.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL)


def _cfgs(arch, **over):
    return (jm.reduced(jconfigs.get_config(arch), dtype="float32", **over),
            tm.reduced(tconfigs.get_config(arch), dtype="float32", **over))


@functools.lru_cache(maxsize=None)
def _loss_case(arch):
    """(jax cfg, port cfg, params, batch, jax loss, jax metrics, jax
    grads): one ``jax.jit(jax.value_and_grad(make_loss_fn(cfg)))``."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(sum(map(ord, arch)) + 1)
    params = perturb_lm_params(jax.tree.map(np.asarray, jm.unbox(
        jm.init_lm(jax.random.PRNGKey(2), jcfg))[0]), rng)
    toks, extra = lm_inputs(jcfg, B, S, rng)
    batch = {"tokens": toks,
             "labels": rng.integers(0, jcfg.vocab_size,
                                    (B, S)).astype(np.int32)}
    if extra is not None:
        batch["extra_embeds"] = extra
    (loss, met), grads = jax.jit(jax.value_and_grad(
        jt.make_loss_fn(jcfg), has_aux=True))(
            params, jax.tree.map(jnp.asarray, batch))
    return (jcfg, tcfg, params, batch, float(loss),
            {k: float(v) for k, v in met.items()},
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_jax(arch, remat, monkeypatch):
    """One reduced arch of each family: the loss within 1e-5 relative,
    its terms likewise, every gradient leaf within 1e-4 of scale; for
    MoE layers the routing indices at each layer's input equal the JAX
    package's router on the same input."""
    jcfg, tcfg, params, batch, jloss, jmet, jgrads = _loss_case(arch)
    model = tm.lm_from_params(tcfg, params, device="cpu")
    model.requires_grad_(True)
    seen = []

    def spy(p, x, cfg):
        seen.append((p, x.detach()))
        return tmoe.apply_moe(p, x, cfg)
    monkeypatch.setattr(ttransformer, "apply_moe", spy)
    loss, met = tt.make_loss_fn(tcfg, remat=remat)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=LOSS_RTOL)
    for k, v in met.items():
        assert abs(float(v.detach()) - jmet[k]) <= LOSS_RTOL * max(
            1.0, abs(jmet[k])), k
    _trees_close(tm.lm_grads(model), jgrads, GRAD_TOL, "grads")
    assert bool(tcfg.moe_num_experts) == bool(seen)
    for p, x in seen:
        _, idx, _ = tmoe.moe_routing(p, x, tcfg)
        want = _jax_routing({"router": _np(p["router"])}, jnp.asarray(
            _np(x)), jcfg)[0]
        np.testing.assert_array_equal(idx.numpy(), want)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _remat_run(model, cfg, batch, remat):
    """(bytes of the tensors autograd saves in the forward pass outside
    the layers' checkpoints, weight matmuls run by the backward pass)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = tt.make_loss_fn(cfg, remat=remat)(model, batch)
    with _CountMatmuls() as mm:
        loss.backward()
    return total[0], mm.n


def test_remat_saves_less_and_changes_no_value():
    """Under autograd ``remat`` keeps only the layers' inputs; the
    backward pass of ``True`` recomputes the weight matmuls, that of
    "dots" runs no more of them than without remat (their outputs are
    kept).  The gradients are the same; without gradients ``remat``
    changes nothing."""
    jcfg, tcfg, params, batch, *_ = _loss_case("qwen2_05b")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = tm.lm_from_params(tcfg, params, device="cpu")
    model.requires_grad_(True)
    saved, mms, grads = {}, {}, {}
    for remat in (False, "dots", True):
        saved[remat], mms[remat] = _remat_run(model, tcfg, tb, remat)
        grads[remat] = _flat(tm.lm_grads(model))
        model.zero_grad(set_to_none=True)
    assert saved[True] == saved["dots"] < saved[False] / 4
    assert mms["dots"] == mms[False] < mms[True]
    for remat in ("dots", True):
        for k, v in grads[False].items():
            np.testing.assert_array_equal(grads[remat][k], v)
    with torch.no_grad():
        a, _ = tm.apply_lm(tcfg, model, tb["tokens"], remat=True)
        b, _ = tm.apply_lm(tcfg, model, tb["tokens"], remat=False)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown remat"):
        tm.apply_lm(tcfg, model, tb["tokens"], remat="everything")


# ----------------------------------------------------------------------- #
# Train and eval steps                                                     #
# ----------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_step(microbatches):
    """The JAX package's jitted train step on the qwen2 loss case, and
    its parameters and metrics after one step (clipping off: it differs
    across accumulation schemes)."""
    jcfg, tcfg, params, batch, *_ = _loss_case("qwen2_05b")
    opt = jt.AdamW(lr=1e-2, clip_norm=0.0)
    step = jax.jit(jt.make_train_step(jcfg, opt, microbatches=microbatches))
    p, st, met = step(params, opt.init(params),
                      jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, st), \
        {k: float(v) for k, v in met.items()}


def _port_step(microbatches, remat=True):
    jcfg, tcfg, params, batch, *_ = _loss_case("qwen2_05b")
    opt = tt.AdamW(lr=1e-2, clip_norm=0.0)
    model = tm.lm_from_params(tcfg, params, device="cpu")
    step = tt.make_train_step(tcfg, opt, remat=remat,
                              microbatches=microbatches)
    model, st, met = step(model, opt.init(tm.lm_to_params(model)),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    return model, st, met


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    """Parameters after one step within 5e-3 of the JAX package's, the
    first moments within 1e-4 of scale (the gradients' bound), the loss
    and metrics within 1e-5 relative; no gradient is left on the
    model."""
    want_p, want_st, want_met = _jax_step(microbatches)
    model, st, met = _port_step(microbatches)
    _trees_close(tm.lm_to_params(model), want_p, STEP_TOL, "params")
    _trees_close(st.mu, want_st.mu, GRAD_TOL, "mu")
    assert int(st.count) == int(want_st.count) == 1
    for k in ("loss", "ce", "z", "moe_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), want_met[k],
                                   rtol=LOSS_RTOL, atol=1e-12, err_msg=k)
    assert all(p.grad is None for p in model.parameters())


def test_microbatch_accumulation_matches_full_batch():
    """The port's microbatches=2 against its own microbatches=1 (the JAX
    package's bound); with a bfloat16 model the sum is float32."""
    p1 = _flat(tm.lm_to_params(_port_step(1)[0]))
    p2 = _flat(tm.lm_to_params(_port_step(2, remat=False)[0]))
    assert max(float(np.abs(p1[k] - p2[k]).max()) for k in p1) < STEP_TOL


def test_bf16_microbatches_accumulate_in_float32(monkeypatch):
    """Two microbatches of a bfloat16 model: the gradients the optimizer
    sees are float32 (the bfloat16 ``.grad`` of each microbatch summed
    into float32), and the step leaves the parameters bfloat16."""
    jcfg, tcfg, params, batch, *_ = _loss_case("qwen2_05b")
    cfg = tm.reduced(tconfigs.get_config("qwen2_05b"))
    assert cfg.dtype == "bfloat16"
    model = tm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = tt.AdamW(lr=1e-3)
    seen = []
    real = tt.AdamW.update

    def spy(self, grads, state, params):
        seen.extend(v.dtype for _, v in flatten_with_paths(grads))
        return real(self, grads, state, params)
    monkeypatch.setattr(tt.AdamW, "update", spy)
    step = tt.make_train_step(cfg, opt, microbatches=2)
    model, st, met = step(model, opt.init(tm.lm_to_params(model)),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert seen and set(seen) == {torch.float32}
    assert {p.dtype for p in model.parameters()} >= {torch.bfloat16}
    assert np.isfinite(float(met["loss"]))


def test_eval_step_matches_loss():
    jcfg, tcfg, params, batch, jloss, *_ = _loss_case("qwen2_05b")
    model = tm.lm_from_params(tcfg, params, device="cpu")
    met = tt.make_eval_step(tcfg)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), jloss, rtol=LOSS_RTOL)
    assert not met["loss"].requires_grad


# ----------------------------------------------------------------------- #
# Gradient compression                                                     #
# ----------------------------------------------------------------------- #
def _grad_tree(rng, n=512):
    return {"w": rng.normal(size=n).astype(np.float32),
            "m": [rng.normal(size=(7, 9)).astype(np.float32),
                  np.round(rng.normal(size=(40,)) * 4).astype(np.float32)]}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_compression_equals_jax(seeded_rng):
    """``topk_compress`` (with error feedback over steps; the third leaf
    has many ties at the threshold), ``int8_roundtrip`` (half-way values
    included: round half to even; a 256k-entry leaf, where a quotient one
    rounding off would flip some value) and ``topk_wire_bytes``:
    equal."""
    g = _grad_tree(seeded_rng)
    g["m"].append((np.arange(-64, 64) / 2 * 0.125).astype(np.float32))
    g["big"] = seeded_rng.normal(size=(256, 1024)).astype(np.float32)
    jerr, terr = jt.init_error(g), tt.init_error(_t(g))
    for k in (0.05, 0.01, 0.3):
        js, jerr = jt.topk_compress(jax.tree.map(jnp.asarray, g), jerr, k)
        ts, terr = tt.topk_compress(_t(g), terr, k)
        for got, want in ((ts, js), (terr, jerr)):
            g_, w_ = _flat(got), _flat(want)
            for key in w_:
                np.testing.assert_array_equal(g_[key], w_[key])
        assert tt.topk_wire_bytes(_t(g), k) == jt.topk_wire_bytes(g, k)
    want = _flat(jt.int8_roundtrip(jax.tree.map(jnp.asarray, g)))
    got = _flat(tt.int8_roundtrip(_t(g)))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    x = g["m"][2]
    q, s = tt.int8_quantize(torch.from_numpy(x))
    jq, js_ = jt.int8_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js_)
    np.testing.assert_array_equal(tt.int8_dequantize(q, s).numpy(),
                                  np.asarray(jt.int8_dequantize(jq, js_)))


def test_topk_error_feedback_conserves_mass():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=512).astype(np.float32))}
    err = tt.init_error(g)
    sent = torch.zeros(512)
    T = 60
    for _ in range(T):
        sparse, err = tt.topk_compress(g, err, k_frac=0.05)
        sent = sent + sparse["w"]
    np.testing.assert_allclose((sent + err["w"]).numpy(),
                               T * g["w"].numpy(), rtol=1e-4, atol=1e-3)
    assert float(err["w"].abs().max()) < T * float(g["w"].abs().max()) / 2
    assert tt.topk_wire_bytes(g, 0.05) == max(1, int(512 * 0.05)) * 8


def test_topk_sparsity():
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy(rng.normal(size=1000).astype(np.float32))}
    sparse, _ = tt.topk_compress(g, tt.init_error(g), k_frac=0.01)
    assert int((sparse["w"] != 0).sum()) <= 12     # ~1% + ties


def test_int8_roundtrip_error_bound():
    rng = np.random.default_rng(2)
    g = {"w": torch.from_numpy(rng.normal(size=2048).astype(np.float32))}
    rt = tt.int8_roundtrip(g)
    scale = float(g["w"].abs().max()) / 127.0
    assert float((rt["w"] - g["w"]).abs().max()) <= scale * 0.5 + 1e-6


# ----------------------------------------------------------------------- #
# The batch pipeline                                                       #
# ----------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _corpora():
    """The same files through both packages' stores: corpus D (one file
    shorter than a window: tiled) plus two files of corpus A."""
    files = (synthetic.make_table2_corpus("D")
             + synthetic.make_table2_corpus("A")[:2])
    assert all((a == b).all() for a, b in zip(
        files, jsynthetic.make_table2_corpus("D")
        + jsynthetic.make_table2_corpus("A")[:2]))
    return (JCorpus.build(files, vocab_size=1200),
            CompressedCorpus.build(files, vocab_size=1200))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("shard", [None, 0, 1])
def test_pipeline_batches_equal_jax(shard, prefetch):
    """Steps 0-9 through ``batch_at`` and through the iterator (with and
    without the prefetch thread), the full batch and each shard of 2:
    bit-equal to the JAX package's, int32."""
    jcc, tcc = _corpora()
    kw = dict(global_batch=4, seq_len=300, seed=11, prefetch=prefetch)
    if shard is not None:
        kw.update(shard=shard, num_shards=2)
    jp, tp = JPipeline(jcc, **kw), BatchPipeline(tcc, **kw)
    try:
        for step in range(10):
            for got, want in zip(tp.batch_at(step), jp.batch_at(step)):
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
        jit, tit = iter(jp), iter(tp)
        for _ in range(10):
            for got, want in zip(next(tit), next(jit)):
                np.testing.assert_array_equal(got, want)
        assert dataclasses.astuple(tp.state) == dataclasses.astuple(jp.state)
    finally:
        jp.close()
        tp.close()


def test_pipeline_determinism_and_sharding():
    files = synthetic.make_table2_corpus("D")
    cc = CompressedCorpus.build(files, vocab_size=400)
    kw = dict(global_batch=8, seq_len=32, seed=7, prefetch=0)
    full = BatchPipeline(cc, **kw)
    x0, _ = BatchPipeline(cc, shard=0, num_shards=2, **kw).batch_at(5)
    x1, _ = BatchPipeline(cc, shard=1, num_shards=2, **kw).batch_at(5)
    xf, yf = full.batch_at(5)
    assert (np.concatenate([x0, x1]) == xf).all()
    assert (xf[:, 1:] == yf[:, :-1]).all()
    assert (BatchPipeline(cc, **kw).batch_at(5)[0] == xf).all()
    with pytest.raises(ValueError, match="divide"):
        BatchPipeline(cc, global_batch=3, seq_len=8, num_shards=2)


# ----------------------------------------------------------------------- #
# The driver                                                               #
# ----------------------------------------------------------------------- #
def _tiny_cfgs():
    return _cfgs("qwen2_05b", num_layers=2, d_model=32, d_ff=64,
                 vocab_size=400)


def _tiny_pipes():
    files = synthetic.make_table2_corpus("D")
    kw = dict(global_batch=4, seq_len=16, seed=0, prefetch=0)
    return (JPipeline(JCorpus.build(files, vocab_size=400), **kw),
            BatchPipeline(CompressedCorpus.build(files, vocab_size=400),
                          **kw))


def _quiet(s):
    pass


def test_loss_decreases_and_restart_exactness(tmp_path):
    """The JAX package's driver test on the port: the loss falls, and a
    run crashed at step 6 and resumed from its step-4 checkpoint ends on
    the uninterrupted run's losses (bit-equal on one CPU thread)."""
    _, cfg = _tiny_cfgs()
    _, pl = _tiny_pipes()
    opt = tt.AdamW(lr=1e-2, warmup_steps=2)

    def model():
        return tm.init_lm(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    out = tt.train(cfg, model(), opt, pl, steps=10,
                   ckpt_dir=str(tmp_path / "a"), ckpt_every=4,
                   log_every=100, log=_quiet)
    assert out["history"][-1] < out["history"][0]
    assert out["last_step"] == 10 and len(out["history"]) == 10
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        tt.train(cfg, model(), opt, pl, steps=10,
                 ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
                 injector=tt.FailureInjector(at_step=6), log_every=100,
                 log=_quiet)
    logs = []
    resumed = model()
    out2 = tt.train(cfg, resumed, opt, pl, steps=10,
                    ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
                    log_every=100, log=logs.append)
    assert "[driver] resumed from checkpoint step 4" in logs
    assert out2["params"] is resumed
    assert out2["history"] == out["history"][4:]
    for a, b in zip(out["params"].parameters(), resumed.parameters()):
        assert torch.equal(a, b)


def test_straggler_watchdog():
    events = []
    wd = tt.StragglerWatchdog(threshold=2.0,
                              on_straggler=lambda s, dt, ema: events.append(s))
    for step, dt in enumerate([1.0, 1.0, 1.1, 5.0, 1.0]):
        wd.observe(step, dt)
    assert events == [3] and wd.events == 1


@functools.lru_cache(maxsize=None)
def _jax_train_fns():
    """The tiny config's JAX weights and one jitted JAX train step,
    shared by every JAX driver run below (one compile)."""
    jcfg, _ = _tiny_cfgs()
    params = jax.tree.map(np.asarray, jm.unbox(
        jm.init_lm(jax.random.PRNGKey(0), jcfg))[0])
    opt = jt.AdamW(lr=1e-2, warmup_steps=2)
    return params, opt, jax.jit(jt.make_train_step(jcfg, opt))


def _jax_train(steps, ckpt_dir=None):
    jcfg, _ = _tiny_cfgs()
    params, opt, step = _jax_train_fns()
    jp, _ = _tiny_pipes()
    return jt.train(jcfg, params, opt, jp, steps=steps, ckpt_dir=ckpt_dir,
                    ckpt_every=4, train_step=step, log_every=100,
                    log=_quiet)["history"]


def _port_train(steps, ckpt_dir=None):
    _, cfg = _tiny_cfgs()
    params, *_ = _jax_train_fns()
    _, tp = _tiny_pipes()
    model = tm.lm_from_params(cfg, params, device="cpu")
    return tt.train(cfg, model, tt.AdamW(lr=1e-2, warmup_steps=2), tp,
                    steps=steps, ckpt_dir=ckpt_dir, ckpt_every=4,
                    log_every=100, log=_quiet)["history"]


def test_driver_losses_match_jax():
    """The same weights, data and optimizer: the port's first 6 losses
    within 1e-4 relative of the JAX package's ``train``."""
    np.testing.assert_allclose(_port_train(6), _jax_train(6),
                               rtol=DRIVER_RTOL)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_driver_resumes_the_other_packages_checkpoint(writer, tmp_path):
    """A step-4 checkpoint (parameters and AdamW state, float32) written
    by one package's ``train`` resumes in the other's: its losses at
    steps 4-5 within 1e-4 relative of the uninterrupted JAX run's."""
    d = str(tmp_path / "ck")
    want = _jax_train(6)[4:]
    if writer == "torch":
        _port_train(4, d)
        got = _jax_train(6, d)
    else:
        _jax_train(4, d)
        got = _port_train(6, d)
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=DRIVER_RTOL)


def test_adamw_state_carries_across(seeded_rng):
    """``adamw_state_from_jax`` / ``adamw_state_to_jax``: the JAX
    package's state, leaf for leaf, count int32."""
    jcfg, tcfg = _tiny_cfgs()
    params = jax.tree.map(np.asarray, jm.unbox(
        jm.init_lm(jax.random.PRNGKey(0), jcfg))[0])
    st = jt.AdamW().init(params)
    st = jt.AdamWState(count=jnp.int32(3), mu=jax.tree.map(
        lambda a: jnp.asarray(seeded_rng.normal(size=a.shape),
                              jnp.float32), st.mu), nu=st.nu)
    port = tm.adamw_state_from_jax(st, device="cpu")
    assert isinstance(port, tt.AdamWState)
    assert port.count.dtype == torch.int32 and int(port.count) == 3
    back = tm.adamw_state_to_jax(port)
    assert _flat(back.mu).keys() == _flat(st.mu).keys()
    for k, v in _flat(st.mu).items():
        np.testing.assert_array_equal(_flat(back.mu)[k], v)
    model = tm.lm_from_params(tcfg, params, device="cpu")
    assert _flat(port.mu).keys() == _flat(tm.lm_to_params(model)).keys()


# ----------------------------------------------------------------------- #
# The launcher                                                             #
# ----------------------------------------------------------------------- #
def test_launcher_on_cpu(capsys):
    out = tlaunch.main(["--device", "cpu", "--reduced", "--steps", "3",
                        "--global-batch", "4", "--seq-len", "16",
                        "--microbatches", "2", "--mesh", "1x1"])
    text = capsys.readouterr().out
    assert "[train] corpus: {" in text
    assert "[train] done: loss" in text and "stragglers" in text
    assert len(out["history"]) == 3 and out["last_step"] == 3
    assert all(np.isfinite(out["history"]))
    assert out["params"].device.type == "cpu"
    assert int(out["opt_state"].count) == 3


def test_launcher_needs_a_card_and_one_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--reduced", "--steps", "1"])
    # a 2x1 mesh in a world of one rank; a coordinator without a mesh
    for argv, match in ((["--mesh", "2x1"], "needs 2 ranks"),
                        (["--coordinator", "localhost:1234"], "need --mesh")):
        with pytest.raises(ValueError, match=match):
            tlaunch.main(["--device", "cpu", "--reduced", "--steps", "1"]
                         + argv)


def test_train_entry_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _tiny_cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.adamw_state_from_jax(tt.AdamWState(np.int32(0), {}, {}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_lm(cfg)
