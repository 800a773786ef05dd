"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on a
fake process group, counted per rank; the port of the JAX package's
``launch/dryrun.py``.

For each cell this driver:
  1. builds the exact assigned config and its inputs on the ``meta``
     device (parameters, AdamW moments, decode caches and batches: shapes
     and dtypes, no memory);
  2. places them as DTensors by the sharding rules
     (``distributed/sharding.py``: DP x FSDP x TP x EP x SP) on a
     ``DeviceMesh`` over a ``"fake"`` process group of 256 ranks
     (``single``, 16x16) or 512 (``multi``, 2x16x16), as rank 0 of it;
  3. runs one train, prefill or decode step eagerly under the activation
     policy and the per-rank counter of ``utils/hlo_analysis.py``;
  4. records per-rank memory, FLOPs, bytes, the collective-byte
     histogram and the model-FLOPs accounting into
     ``<out>/<arch>__<shape>__<mesh>.json``, in the JAX package's keys.

Where the JAX package compiles, the port runs the step once on shapes:
XLA's cost analysis becomes the count of the eager ops each rank runs
(``counting: "eager"``; every layer is counted, so ``scan_repeats`` is
recorded for the roofline and never applied).  ``lower_s`` is the
seconds to build and place the cell, ``compile_s`` those of the counted
step.  ``argument_bytes`` and ``output_bytes`` are one rank's shards of
the step's inputs (as the rules place them) and outputs.
``temp_bytes``, ``alias_bytes`` and ``code_bytes`` are ``null``: an eager
run has no compiler's buffer plan, the step updates the parameters and
moments in place (nothing is donated), and there is no generated code.
The JAX package's ``--fast`` (a single scan-pass compile) has no eager
counterpart and is gone.

The caller owns the process group: :func:`fake_world` creates it and
destroys it on exit; :func:`run_cell` builds its mesh over it.

Resumable: existing JSONs are skipped unless --force.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Dict, Iterator, Optional

import torch

from repro_torch.configs import (ALIASES, get_config, input_specs,
                                 shape_supported)
from repro_torch.distributed import (NamedSharding, batch_shardings,
                                     cache_shardings, default_rules,
                                     distribute_lm)
from repro_torch.distributed.sharding import (MeshShape, PartitionSpec,
                                              mesh_axes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_cache
from repro_torch.models.config import LM_SHAPES, ModelConfig
from repro_torch.models.partitioning import activation_policy
from repro_torch.models.transformer import LM, init_tree
from repro_torch.serving import make_prefill_step, make_serve_step
from repro_torch.training import AdamW, make_train_step
from repro_torch.utils.hlo_analysis import (count_ops, op_histogram,
                                            parse_collectives,
                                            total_collective_bytes)

P = PartitionSpec

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "dryrun_out")


def model_flops(cfg, shape_name: str) -> float:
    """MODEL_FLOPS per step: 6*N*D train (N active params, D tokens),
    2*N*D forward-only (prefill/decode)."""
    spec = LM_SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return 6.0 * n_active * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return 2.0 * n_active * tokens
    tokens = spec.global_batch * 1           # one token per stream
    return 2.0 * n_active * tokens


def make_activation_policy(cfg, shape_name: str, mesh, rules,
                           variant: str = "baseline") -> Dict:
    """PartitionSpecs pinning activations through the layer boundaries.

    act_btd: [B, S/1, d] -> batch over (pod, data), replicated over model.
    logits:  [B, S, V]   -> batch over (pod, data), vocab over model.
    Skipped when the dim does not divide (long_500k batch=1)."""
    spec = LM_SHAPES[shape_name]
    sizes = mesh_axes(mesh)
    ba = rules.batch_axes
    b_assign = ba[0] if len(ba) == 1 else tuple(ba)
    b_size = math.prod(sizes[a] for a in ba)
    model_sz = sizes.get("model", 1)
    pol: Dict = {}
    b_ok = spec.global_batch % b_size == 0
    v_ok = cfg.vocab_size % model_sz == 0
    s_ok = spec.seq_len % model_sz == 0 and spec.kind in ("train", "prefill")
    if b_ok:
        if variant == "fullsp" and s_ok:
            # Megatron-style full sequence parallelism: the layer carry
            # stays seq-sharded over `model`
            pol["act_btd"] = P(b_assign, "model", None)
        else:
            pol["act_btd"] = P(b_assign, None, None)
        pol["logits"] = P(b_assign, None, "model" if v_ok else None)
    elif v_ok:
        pol["logits"] = P(None, None, "model")
    # SP attention: shard q over seq on the model axis whenever head counts
    # don't divide it; full-seq shapes only (decode q has S=1).
    if spec.kind in ("train", "prefill") and cfg.num_heads:
        heads_ok = (cfg.num_kv_heads % model_sz == 0)
        if not heads_ok and spec.seq_len % model_sz == 0 and b_ok:
            pol["attn_q"] = P(b_assign, "model", None, None)
    return pol


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A ``"fake"`` process group of ``size`` ranks, this process rank 0:
    collectives return at once and move no data.  Destroyed on exit."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _placed(shape, dtype, sharding: NamedSharding):
    """A meta DTensor of global ``shape``: rank 0's shard, placed."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(sharding.shard_shape(shape), dtype=dtype,
                        device="meta")
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def _place_tree(tree, shardings):
    """``tree`` (meta tensors, other leaves kept) as meta DTensors placed
    by the matching leaves of ``shardings``."""
    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(v, s) for v, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor):
        return _placed(tuple(tree.shape), tree.dtype, shardings)
    return tree


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (a module's
    parameters included)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.nn.Module):
        return _local_bytes(list(tree.parameters()))
    if isinstance(tree, dict):
        return _local_bytes(list(tree.values()))
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


def build_cell(arch: str, shape_name: str, mesh, rules,
               microbatches: int = 1, remat=True,
               cfg: Optional[ModelConfig] = None):
    """Returns ``(cfg, step, args)``: ``step(*args)`` runs the cell on
    ``mesh`` (a ``DeviceMesh``), its inputs meta DTensors placed by
    ``rules``.  ``cfg`` replaces the arch's config (a reduced one)."""
    cfg = cfg or get_config(arch)
    spec = LM_SHAPES[shape_name]
    with torch.device("meta"):
        model = LM(cfg, init_tree(cfg, None))
    distribute_lm(model, mesh, rules)
    ins = input_specs(cfg, shape_name)
    probes = {k: torch.empty(s, dtype=dt, device="meta")
              for k, (s, dt) in ins.items()}
    shardings = batch_shardings(probes, mesh, rules)
    batch = _place_tree(probes, shardings)

    if spec.kind == "train":
        from repro_torch.models import lm_to_params
        opt = AdamW(lr=1e-4)
        state = opt.init(lm_to_params(model))
        step = make_train_step(cfg, opt, remat=remat,
                               microbatches=microbatches)
        return cfg, step, (model, state, batch)

    if spec.kind == "prefill":
        prefill = make_prefill_step(cfg)

        def step(m, b):
            return prefill(m, b["tokens"], extra_embeds=b.get(
                "extra_embeds"))
        return cfg, step, (model, batch)

    # decode: serve_step against a seq_len-deep cache
    cache = init_cache(cfg, spec.global_batch, spec.seq_len, device="meta")
    cache = _place_tree(cache, cache_shardings(cfg, cache, mesh, rules))
    serve = make_serve_step(cfg)

    def step(m, c, t):
        nxt, c, _ = serve(m, c, t)
        return nxt, c
    return cfg, step, (model, cache, batch["tokens"])


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str = OUT_DIR, force: bool = False,
             microbatches: int = 1, remat="full",
             fsdp_over_pod: bool = False, tag: str = "",
             policy_variant: str = "baseline", rules=None,
             cfg: Optional[ModelConfig] = None,
             mesh_shape: Optional[MeshShape] = None) -> Optional[Dict]:
    """One cell's record (read back when its JSON exists, unless
    ``force``).  Needs a process group of the mesh's size
    (:func:`fake_world`).  ``cfg`` and ``mesh_shape`` replace the arch's
    config and the production mesh (reduced cells on small worlds)."""
    cfg = cfg or get_config(arch)
    name = f"{ALIASES.get(arch, arch)}__{shape_name}__{mesh_kind}"
    if tag:
        name += f"__{tag}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    ok, reason = shape_supported(cfg, shape_name)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": reason}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] SKIP {name}: {reason}")
        return rec

    shape = mesh_shape or make_production_mesh(
        multi_pod=(mesh_kind == "multi"))
    rules = rules or default_rules(shape, fsdp_over_pod=fsdp_over_pod)
    policy = make_activation_policy(cfg, shape_name, shape, rules,
                                    variant=policy_variant)
    t0 = time.time()
    try:
        from torch.distributed.device_mesh import init_device_mesh
        sizes = mesh_axes(shape)
        mesh = init_device_mesh("cpu", tuple(sizes.values()),
                                mesh_dim_names=tuple(sizes))
        cfg, step, args = build_cell(arch, shape_name, mesh, rules,
                                     microbatches=microbatches,
                                     remat=remat, cfg=cfg)
        arg_bytes = _local_bytes(args)
        t1 = time.time()
        with activation_policy(policy), count_ops() as counted:
            outs = step(*args)
        t2 = time.time()
        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "tag": tag, "status": "ok",
            "devices": mesh.size(),
            "lower_s": round(t1 - t0, 2), "compile_s": round(t2 - t1, 2),
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": _local_bytes(outs),
                "temp_bytes": None,
                "alias_bytes": None,
                "code_bytes": None,
            },
            "cost": {
                "flops_per_device": float(counted.flops),
                "bytes_per_device": float(counted.bytes),
            },
            "collectives": parse_collectives(counted),
            "collective_bytes_per_device": total_collective_bytes(counted),
            "ops": op_histogram(counted),
            "model_flops_total": model_flops(cfg, shape_name),
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count(),
            "counting": "eager",
            "scan_repeats": cfg.num_layers // cfg.block_size,
        }
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] OK   {name}: step {rec['compile_s']}s, "
              f"{arg_bytes / (1 << 30):.2f} GiB/dev, "
              f"{rec['cost']['flops_per_device'] / 1e9:.1f} GFLOP/dev, "
              f"coll {rec['collective_bytes_per_device'] / 1e6:.1f} MB/dev")
        return rec
    except Exception as e:  # record failures; they are bugs to fix
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "error", "error": repr(e),
               "trace": traceback.format_exc()[-2000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] FAIL {name}: {e}")
        return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="assignment id, e.g. yi-9b (default: all)")
    ap.add_argument("--shape", default=None,
                    help="train_4k|prefill_32k|decode_32k|long_500k")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--fsdp-over-pod", action="store_true")
    ap.add_argument("--policy", default="baseline",
                    choices=["baseline", "fullsp"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = ([args.arch] if args.arch else list(ALIASES.keys()))
    shapes = ([args.shape] if args.shape else list(LM_SHAPES.keys()))
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    failures = 0
    for mk in meshes:
        with fake_world(512 if mk == "multi" else 256):
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, mk, out_dir=args.out,
                                   force=args.force,
                                   microbatches=args.microbatches,
                                   remat=(False if args.remat == "none"
                                          else args.remat),
                                   fsdp_over_pod=args.fsdp_over_pod,
                                   policy_variant=args.policy,
                                   tag=args.tag)
                    if rec and rec.get("status") == "error":
                        failures += 1
    print(f"[dryrun] done, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
