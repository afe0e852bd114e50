"""`LM.use_mesh` held for values on a real 2x2 ("data","model") mesh of
four gloo processes on the host's CPU, against the one-process port with
the same attention mode and MoE groups: the loss and gradients of one
step, one train step's loss and first moments, and ten decode steps'
logits on a cache whose sequence is sharded over "model" (the decode
writes both model ranks' halves of its 16 positions).  The smoke configs
of a dense arch (q_groups), an MoE arch (kv_heads, experts over "model")
and a hybrid arch (kv_seq, the SSM scan) cover the three attention modes.

  python -m repro_torch.launch.meshcheck

prints each arch's mode and worst differences as one JSON line, and
exits 1 if any is past `failures`' tolerances.  Each rank runs one torch
thread: more oversubscribe the host's cores (~5x slower)."""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ARCHS = ("phi3-medium-14b", "qwen3-moe-235b-a22b", "hymba-1.5b")
MODES = {"phi3-medium-14b": "q_groups", "qwen3-moe-235b-a22b": "kv_heads",
         "hymba-1.5b": "kv_seq"}
WORLD = 4


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _norms(tree_p, tree_m):
    """(path, |a - b|, |a|) for each leaf of two trees, the second's
    DTensors gathered."""
    from repro_torch.models.common import tree_leaves_with_path
    return [("/".join(path), float((a - _full(b)).norm()), float(a.norm()))
            for (path, a), (_, b) in zip(tree_leaves_with_path(tree_p),
                                         tree_leaves_with_path(tree_m))]


def _check_arch(arch: str, mesh) -> dict:
    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm import SyntheticLMData
    from repro_torch.models.transformer import LM
    from repro_torch.sharding import rules
    from repro_torch.sharding.dtensor import sharded_context
    from repro_torch.train import steps
    cfg = get_config(arch, "smoke")
    lm_m = LM(cfg).use_mesh(mesh)
    lm_p = LM(cfg)              # the same function on one process
    lm_p.attn_mode, lm_p.moe_groups = lm_m.attn_mode, lm_m.moe_groups
    state = steps.init_train_state(lm_p, prng.PRNGKey(0, device="cpu"),
                                   device="cpu")
    batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=4).batch_for_step(0, device="cpu")
    loss_p, _, g_p = steps.value_and_grad(lm_p, state.params, batch)
    state_m = rules.tree_distribute(steps.train_state_axes(lm_m), state, mesh)
    batch_m = {k: rules.distribute(v, rules.batch_pspec(mesh), mesh)
               for k, v in batch.items()}
    with sharded_context(True):
        loss_m, _, g_m = steps.value_and_grad(lm_m, state_m.params, batch_m)
    new_p, met_p = steps.make_train_step(lm_p)(state, batch)
    new_m, met_m = steps.make_train_step(lm_m)(state_m, batch_m)
    cache_p = lm_p.init_cache(4, 16, device="cpu")
    c0 = lm_m.init_cache(4, 16, device="cpu")
    cache_m = rules.tree_distribute(rules.cache_axes_tree(c0), c0, mesh)
    decode = []
    for i in range(10):
        tok = batch["tokens"][:, i:i + 1]
        lp, cache_p = lm_p.decode_step(state.params, tok, cache_p)
        lm_, cache_m = lm_m.decode_step(
            state_m.params, rules.distribute(tok, rules.batch_pspec(mesh),
                                             mesh), cache_m)
        decode.append(float((_full(lm_) - lp).abs().max() / lp.abs().max()))
    return {"mode": lm_m.attn_mode, "moe_groups": lm_m.moe_groups,
            "decode": decode,
            "loss": (float(loss_p), float(_full(loss_m))),
            "step_loss": (float(met_p["loss"]), float(_full(met_m["loss"]))),
            "grads": _norms(g_p, g_m),
            "moments": _norms(new_p.opt["m"], new_m.opt["m"])}


def worker(rank: int, store_path: str, q) -> None:
    """One rank of the 2x2 mesh; rank 0 puts {arch: result} (or a
    traceback) on `q`."""
    import torch
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             WORLD),
                                rank=rank, world_size=WORLD)
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = {arch: _check_arch(arch, mesh) for arch in ARCHS}
        if rank == 0:
            q.put(out)
        dist.destroy_process_group()
    except BaseException:
        import traceback
        q.put(traceback.format_exc())
        raise


def run(store_dir, timeout: float = 600.0):
    """The four ranks in spawned processes with a FileStore under
    `store_dir`; returns rank 0's dict, or the first traceback (a str).
    Every process is joined or killed before it returns."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(r, str(Path(store_dir) /
                                                     "store"), q))
             for r in range(WORLD)]
    try:
        for p in procs:
            p.start()
        return q.get(timeout=timeout)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()


def failures(out) -> list:
    """What in `run`'s result is off: a traceback, a mode other than
    MODES, a loss off by more than atol 1e-5 + rtol 1e-4, a gradient or
    first moment off by more than 1e-5 of its L2 norm, or a decode step's
    max difference past 1e-5 of the logits' max."""
    if not isinstance(out, dict):
        return [f"a rank failed: {out}"]
    bad = []
    modes = {a: out[a]["mode"] for a in ARCHS}
    if modes != MODES:
        bad.append(f"attention modes {modes}, want {MODES}")
    for arch, r in out.items():
        for want, got in (r["loss"], r["step_loss"]):
            if not abs(got - want) <= 1e-5 + 1e-4 * abs(want):
                bad.append(f"{arch}: loss {got!r} against {want!r}")
        for name, diff, norm in r["grads"] + r["moments"]:
            if not diff <= 1e-5 * max(norm, 1e-30):
                bad.append(f"{arch}: {name} differs by {diff} of {norm}")
        if not max(r["decode"]) <= 1e-5:
            bad.append(f"{arch}: decode differs {r['decode']}")
    return bad


def summary(out: dict) -> dict:
    """Each arch's mode, MoE groups and worst relative differences."""
    def worst(rows):
        return max(d / max(n, 1e-30) for _, d, n in rows)
    return {arch: {"mode": r["mode"], "moe_groups": r["moe_groups"],
                   "loss_rel": abs(r["loss"][1] - r["loss"][0])
                   / max(abs(r["loss"][0]), 1e-30),
                   "grad_rel_l2": worst(r["grads"]),
                   "moment_rel_l2": worst(r["moments"]),
                   "decode_rel": max(r["decode"])}
            for arch, r in out.items()}


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="meshcheck_") as tmp:
        out = run(tmp)
    bad = failures(out)
    print(json.dumps({"summary": summary(out) if isinstance(out, dict)
                      else None, "failures": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
