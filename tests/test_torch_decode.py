"""The port's LM serving path (``repro_torch.models`` decode,
``repro_torch.serving`` decode factories, ``repro_torch.launch.serve``)
against the JAX package's, on the CPU, as a whole.

Weights come from the JAX package's init (biases and norm scales drawn at
random, ``_torch_inputs.perturb_lm_params``) carried across with
``lm_from_params``.  Each JAX reference is built once per module: one
``jax.jit(decode_step)`` per arch, stepped through the prompt.
Tolerances:

* cache layouts (keys, shapes, dtypes, ``pos``): equal;
* ``decode_step`` logits and every cache entry, step by step: within
  ``1e-4 * max(1, max|jax|)`` of the JAX package's;
* the port's own decode against its parallel ``apply_lm``: within
  ``3e-3 * max(1, max|full|)`` (the JAX package's bound,
  ``tests/test_models.py``);
* ``greedy_generate`` tokens: equal.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jm
from repro.serving import greedy_generate as jgreedy
from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch.checkpoint import flatten_with_paths
from repro_torch.launch import serve as tserve
from repro_torch.serving import (greedy_generate, make_prefill_step,
                                 make_serve_step)

from _torch_inputs import lm_inputs, perturb_lm_params

torch.set_num_threads(1)

LM_TOL = 1e-4          # against the JAX package: LM_TOL * max(1, max|jax|)
PARALLEL_TOL = 3e-3    # decode against parallel, the JAX package's bound
DECODE_ARCHS = ["stablelm_12b", "qwen2_05b", "qwen2_moe_a27b",
                "jamba_v01_52b", "mamba2_27b", "whisper_large_v3"]
GREEDY_ARCHS = ["qwen2_05b", "qwen2_moe_a27b", "mamba2_27b",
                "whisper_large_v3"]
B, S = 2, 10


def _cfgs(arch):
    """Reduced float32 configs; MoE without drops (capacity factor 4), so
    decode equals parallel, as in ``tests/test_models.py``."""
    over = {}
    if jconfigs.get_config(arch).moe_num_experts:
        over["moe_capacity_factor"] = 4.0
    return (jm.reduced(jconfigs.get_config(arch), dtype="float32", **over),
            tm.reduced(tconfigs.get_config(arch), dtype="float32", **over))


@functools.lru_cache(maxsize=None)
def _case(arch):
    """(jax cfg, port cfg, jax params, port model, tokens, extra)."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(sum(map(ord, arch)))
    params = perturb_lm_params(jax.tree.map(np.asarray, jm.unbox(
        jm.init_lm(jax.random.PRNGKey(1), jcfg))[0]), rng)
    model = tm.lm_from_params(tcfg, params, device="cpu")
    toks, extra = lm_inputs(jcfg, B, S, rng)
    return jcfg, tcfg, params, model, toks, extra


@functools.lru_cache(maxsize=None)
def _jax_decode(arch):
    """The JAX package's per-step logits and caches over the prompt (one
    jitted ``decode_step``)."""
    jcfg, _, params, _, toks, extra = _case(arch)
    cache = jm.init_cache(jcfg, B, S)
    if jcfg.family == "encdec":
        cache = jm.prefill_cross(jcfg, params, cache, jnp.asarray(extra))
    step = jax.jit(functools.partial(jm.decode_step, jcfg))
    out = []
    for t in range(S):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]))
        out.append((np.asarray(lg), jax.tree.map(np.asarray, cache)))
    return out


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_init_cache_layout(arch):
    jcfg = jm.reduced(jconfigs.get_config(arch), dtype="float32")
    tcfg = tm.reduced(tconfigs.get_config(arch), dtype="float32")
    want = jm.init_cache(jcfg, 3, 7)
    got = tm.init_cache(tcfg, 3, 7, device="cpu")
    assert got["pos"] == int(want["pos"]) == 0
    jflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    tflat = dict(flatten_with_paths(got))
    assert list(tflat) == list(jflat)
    for k, v in jflat.items():
        if k == "['pos']":
            continue
        assert tuple(tflat[k].shape) == v.shape, k
        assert str(tflat[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert not tflat[k].any(), k


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_matches_jax(arch):
    """Logits and every cache entry, step by step, within
    1e-4 * max(1, max|jax|); the port's decode also equals its own
    parallel ``apply_lm`` within the JAX package's 3e-3 bound."""
    _, tcfg, _, model, toks, extra = _case(arch)
    cache = tm.init_cache(tcfg, B, S, device="cpu")
    outs = []
    with torch.no_grad():
        if tcfg.family == "encdec":
            cache = tm.prefill_cross(tcfg, model, cache, extra)
        for t, (jlg, jcache) in enumerate(_jax_decode(arch)):
            lg, cache = tm.decode_step(tcfg, model, cache, toks[:, t:t + 1])
            assert _scaled_err(lg, jlg) <= LM_TOL, (t, _scaled_err(lg, jlg))
            assert cache["pos"] == int(jcache["pos"]) == t + 1
            jflat = dict(flatten_with_paths(jcache))
            for key, val in flatten_with_paths(cache):
                if key != "['pos']":
                    assert _scaled_err(val, jflat[key]) <= LM_TOL, (t, key)
            outs.append(lg)
        full, _ = tm.apply_lm(tcfg, model, toks, extra_embeds=extra)
    dec = torch.cat(outs, dim=1)
    assert _scaled_err(dec, full.numpy()) <= PARALLEL_TOL


@pytest.mark.parametrize("arch", GREEDY_ARCHS)
def test_greedy_generate_matches_jax(arch):
    """Six new tokens after the ten-token prompt, equal to the JAX
    package's ``greedy_generate``."""
    jcfg, tcfg, params, model, toks, extra = _case(arch)
    want = np.asarray(jgreedy(jcfg, params, jnp.asarray(toks), 6,
                              extra_embeds=None if extra is None
                              else jnp.asarray(extra)))
    got = greedy_generate(tcfg, model, toks, 6, extra_embeds=extra,
                          device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_step_and_prefill_factories():
    """The factories' greedy token is the argmax of the decode logits;
    categorical sampling is reproducible from its generator; prefill is
    ``apply_lm``."""
    _, tcfg, _, model, toks, _ = _case("qwen2_05b")
    step = make_serve_step(tcfg)
    cache = tm.init_cache(tcfg, B, S, device="cpu")
    nxt, cache, lg = step(model, cache, toks[:, :1])
    assert nxt.shape == (B, 1) and nxt.dtype == torch.int32
    assert torch.equal(nxt[:, 0].long(), lg[:, -1].argmax(-1))
    samples = []
    for _ in range(2):
        c = tm.init_cache(tcfg, B, S, device="cpu")
        g = torch.Generator().manual_seed(3)
        samples.append(make_serve_step(tcfg, sample="categorical",
                                       temperature=0.7)(
            model, c, toks[:, :1], g)[0])
    assert torch.equal(samples[0], samples[1])
    assert ((samples[0] >= 0) & (samples[0] < tcfg.vocab_size)).all()
    with pytest.raises(ValueError, match="sampling"):
        make_serve_step(tcfg, sample="top_p")
    full, _ = tm.apply_lm(tcfg, model, toks)
    assert torch.equal(make_prefill_step(tcfg)(model, toks), full)


def test_width_faithful_qwen2_depth_cut(seeded_rng):
    """qwen2-0.5b at its published widths (d_model 896, 14 heads over 2 kv
    heads, head_dim 64, d_ff 4864, QKV bias, tied head), cut to 2 layers
    and a 4096-word vocab: logits and three decode steps within
    1e-4 * max(1, max|jax|)."""
    over = dict(num_layers=2, vocab_size=4096, dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_config("qwen2_05b"), **over)
    tcfg = dataclasses.replace(tconfigs.get_config("qwen2_05b"), **over)
    assert (tcfg.num_heads, tcfg.num_kv_heads, tcfg.resolved_head_dim,
            tcfg.qkv_bias, tcfg.tie_embeddings) == (14, 2, 64, True, True)
    params = perturb_lm_params(jax.tree.map(np.asarray, jm.unbox(
        jm.init_lm(jax.random.PRNGKey(2), jcfg))[0]), seeded_rng)
    model = tm.lm_from_params(tcfg, params, device="cpu")
    toks, _ = lm_inputs(jcfg, 2, 8, seeded_rng)
    want, _ = jax.jit(functools.partial(jm.apply_lm, jcfg))(
        params, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = tm.apply_lm(tcfg, model, toks)
    assert _scaled_err(got, want) <= LM_TOL
    jcache, tcache = jm.init_cache(jcfg, 2, 3), tm.init_cache(tcfg, 2, 3,
                                                             device="cpu")
    jstep = jax.jit(functools.partial(jm.decode_step, jcfg))
    for t in range(3):
        jlg, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        with torch.no_grad():
            tlg, tcache = tm.decode_step(tcfg, model, tcache,
                                         toks[:, t:t + 1])
        assert _scaled_err(tlg, jlg) <= LM_TOL, t


def test_serve_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` prints the JAX
    launcher's two lines."""
    out = tserve.main(["--device", "cpu", "--arch", "qwen2-0.5b",
                       "--batch", "2", "--prompt-len", "3", "--steps", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert re.fullmatch(r"\[serve\] qwen2-0\.5b: \d+ tok/s \(batch 2\)",
                        lines[0])
    assert lines[1] == f"[serve] request 0 ids: {out['ids']}"
    assert len(out["ids"]) == 4


def test_entry_points_raise_without_cuda(monkeypatch):
    """No fallback: the default device is the card, and without one every
    entry point raises unless asked for the CPU."""
    _, tcfg, _, model, toks, _ = _case("qwen2_05b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tm.init_lm(tcfg),
                 lambda: tm.init_cache(tcfg, 1, 4),
                 lambda: tm.lm_from_params(tcfg, tm.lm_to_params(model)),
                 lambda: greedy_generate(tcfg, model, toks, 2),
                 lambda: tserve.main(["--arch", "qwen2-0.5b"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tm.init_lm(tcfg, device="cpu").device.type == "cpu"
