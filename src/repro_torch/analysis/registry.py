"""Declared entry points for the analysis passes.

Three registries live here:

`HOT_PATH_ROOTS` — the roots of the host-sync pass, file (repo-relative)
-> function qualnames.  Eager PyTorch traces nothing, so no root can be
discovered from a decorator: each is declared.  The table holds the port's
twin of every jit root of the JAX package (under the same qualname unless
`RENAMED_ROOTS` names it otherwise; `port_root`), plus the kernel wrappers
that every die draw and every fused multiply-add go through.

`NO_TWIN` — the JAX package's jit roots ("file::qualname") and shape
contracts (by name) that have no counterpart in the port, each with the
reason.

`shape_contracts()` — the shape-contract registry, twin for twin the
reference's; `port_contracts()` those of the port's own architectures
(`configs.registry.PORT_ARCHS`), which the reference does not have.
Each `ShapeContract` builds its inputs with `torch.empty` under
`FakeTensorMode` on a given device, runs the real entry point on them
(no FLOPs, no transfer: the kernels answer through their custom ops'
fake implementations) and returns None on success or a mismatch
description.  The same contract can run on real, seeded inputs
(`ShapeContract.trace(device, fake=False)`), so
the card can hold its fake result against a real one.

`configs.registry.ARCH_STATUS` decides which model-zoo archs the pass may
treat as quarantined: every registered arch MUST carry a status ("live"
archs need a contract below; "legacy" archs get a smoke-geometry contract
so drift in quarantined code is still caught, just reported as legacy).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch

HOT_PATH_ROOTS: Dict[str, Set[str]] = {
    # the detector's forward: every mode of every sweep, the QAT loss and
    # the service's lanes call it
    "src/repro_torch/models/detector.py": {"IRCDetector.apply"},
    "src/repro_torch/mc/ensemble.py": {"sample_ensemble",
                                       "sample_ensemble_with_keys"},
    # the crossbar forward every single-chip path runs
    "src/repro_torch/core/crossbar.py": {"crossbar_apply"},
    "src/repro_torch/core/nonideal.py": {"resolve_sa", "sensed_diff"},
    # consulted by IRCDetector._gconv_ensemble's routing on every group
    # conv of every chunk (host-side table lookups on concrete shapes)
    "src/repro_torch/kernels/autotune.py": {"kernel_wins", "best_blocks",
                                            "lookup"},
    # the device-model sampling hooks, reached from sample_chip_planes
    # through the `device=` seam that the static call graph cannot follow
    "src/repro_torch/device/analytic.py": {
        "AnalyticDeviceModel.variation_mask"},
    "src/repro_torch/device/measured.py": {
        "MeasuredDeviceModel.variation_mask",
        "MeasuredDeviceModel.variation_factor"},
    "src/repro_torch/device/retention.py": {"RetentionDrift.variation_mask"},
    "src/repro_torch/device/base.py": {"DeviceModel.sa_offset_sigma",
                                       "DeviceModel.ir_drop_factors"},
    # the kernels' entry points; beside the JAX package's four, the
    # wrappers of the die sampling and the fused multiply-add, which every
    # sampled die and the plain route's epilogue launch
    "src/repro_torch/kernels/ops.py": {
        "flash_attention", "irc_mvm", "irc_mvm_chips", "ternary_matmul",
        "xla_fma", "threefry_fold_in", "threefry_split", "threefry_draw"},
    "src/repro_torch/mc/detector_mc.py": {"_sample_and_forward",
                                          "committee_wave_forward"},
    "src/repro_torch/mc/engine.py": {"ensemble_apply",
                                     "ensemble_apply_kernel"},
    # the port's own MLA block (no twin in the JAX package): the batched
    # prefill, the absorbed decode, and the routed experts, whose group
    # ends stay on the device
    "src/repro_torch/models/transformer.py": {"LM.prefill"},
    "src/repro_torch/models/mla.py": {"prefill", "decode"},
    "src/repro_torch/models/moe.py": {"routed_block"},
}

# Roots whose port twin has another qualname (same file under src/repro_torch)
RENAMED_ROOTS: Dict[str, str] = {
    "src/repro/mc/detector_mc.py::_sampled_chunk_forward":
        "_sample_and_forward",
}

_CHUNK_IN_STEPS = (
    "the JAX package's cached one-program chunk (sample, apply and the "
    "metrics under one jit); the port's run_mc runs the chunk as eager "
    "steps through sample_ensemble and ensemble_apply / "
    "ensemble_apply_kernel, roots and contracts of their own, and logs "
    "fused=False")
_NO_DONATION = (
    "buffer donation has no eager counterpart: run_mc calls ensemble_apply "
    "/ ensemble_apply_kernel (roots and contracts of their own) and frees "
    "the chunk's ensemble with `del`")

NO_TWIN: Dict[str, str] = {
    "src/repro/mc/detector_mc.py::_ensemble_forward":
        "a jit wrapper of IRCDetector.apply(mode='ensemble') for the "
        "blocking sweep; the port's blocking sweep calls IRCDetector.apply "
        "(a root) directly: nothing is compiled, so no wrapper exists",
    "src/repro/mc/engine.py::_ensemble_apply_donated": _NO_DONATION,
    "src/repro/mc/engine.py::_fused_chunk_metrics": _CHUNK_IN_STEPS,
    "_ensemble_apply_donated": _NO_DONATION,
    "_fused_chunk_metrics": _CHUNK_IN_STEPS,
}


def port_root(reference_root: str) -> Optional[Tuple[str, str]]:
    """(port file, qualname) of one of the JAX package's jit roots
    ("file::qualname"), or None when it is in `NO_TWIN`."""
    if reference_root in NO_TWIN:
        return None
    file, qual = reference_root.split("::")
    port_file = file.replace("src/repro/", "src/repro_torch/", 1)
    return port_file, RENAMED_ROOTS.get(reference_root, qual)


class Inputs:
    """A contract's inputs on `device`: `torch.empty` tensors when `fake`
    (the contract runs under `FakeTensorMode`), otherwise values drawn
    from a generator seeded with `seed`: uniforms in [0, 1), {0, 1} word
    lines, normal latent weights, seeded PRNG keys."""

    def __init__(self, device, fake: bool, seed: int = 0):
        self.device = torch.device(device)
        self.fake = fake
        self.seed = seed
        self._gen = torch.Generator().manual_seed(seed)

    def _draw(self, shape, dtype, fn) -> torch.Tensor:
        if self.fake:
            return torch.empty(shape, dtype=dtype, device=self.device)
        return fn(tuple(shape)).to(dtype=dtype, device=self.device)

    def floats(self, shape) -> torch.Tensor:
        return self._draw(shape, torch.float32,
                          lambda s: torch.rand(s, generator=self._gen))

    def normals(self, shape) -> torch.Tensor:
        return self._draw(shape, torch.float32,
                          lambda s: torch.randn(s, generator=self._gen))

    def bits(self, shape) -> torch.Tensor:
        return self._draw(shape, torch.float32, lambda s: torch.randint(
            0, 2, s, generator=self._gen))

    def ints(self, shape, high: int, dtype=torch.int64) -> torch.Tensor:
        return self._draw(shape, dtype, lambda s: torch.randint(
            0, high, s, generator=self._gen))

    def arange(self, n: int) -> torch.Tensor:
        return self._draw((n,), torch.int64, lambda s: torch.arange(n))

    def key(self, salt: int = 0) -> torch.Tensor:
        """A [2] key: PRNGKey(seed) folded with `salt`."""
        from repro_torch import prng
        if self.fake:
            return torch.empty((2,), dtype=torch.int64, device=self.device)
        return prng.fold_in(prng.PRNGKey(self.seed, self.device), salt)

    def keys(self, n: int) -> torch.Tensor:
        """[n, 2] keys: PRNGKey(seed) folded with 0..n-1."""
        from repro_torch import prng
        if self.fake:
            return torch.empty((n, 2), dtype=torch.int64, device=self.device)
        return prng.fold_in(prng.PRNGKey(self.seed, self.device),
                            torch.arange(n, device=self.device))


Body = Callable[[Inputs], Tuple[Any, Optional[str]]]


@dataclasses.dataclass(frozen=True)
class ShapeContract:
    """One shape contract: `run()` returns None or a mismatch.

    `body(inputs)` runs the entry point and returns (its output, the
    mismatch against the declared shape/dtype/device or None).  `route`
    says which IRC MVM route the contract takes: "kernel" (K1 must
    launch), "plain" (K1 must not), or "" (the autotuner's table picks, or
    no IRC MVM is reached)."""
    name: str           # e.g. "detector.apply[train,ternary]"
    file: str           # repo-relative file the contract protects
    body: Body
    arch: Optional[str] = None   # registry arch this contract covers
    route: str = ""

    def trace(self, device="cuda", fake: bool = True
              ) -> Tuple[Any, Optional[str]]:
        """(output, mismatch) on `device`: under `FakeTensorMode` when
        `fake`, on seeded real inputs otherwise."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = (FakeTensorMode(allow_non_fake_inputs=True) if fake
                else contextlib.nullcontext())
        with mode, torch.no_grad():
            return self.body(Inputs(device, fake))

    def run(self, device="cuda") -> Optional[str]:
        return self.trace(device)[1]


def _expect(out, inp: Inputs, shape, dtype, what: str) -> Optional[str]:
    if tuple(out.shape) != tuple(shape):
        return f"{what}: expected shape {tuple(shape)}, got {tuple(out.shape)}"
    if out.dtype != dtype:
        return f"{what}: expected dtype {dtype}, got {out.dtype}"
    if out.device.type != inp.device.type:
        return f"{what}: expected device {inp.device.type}, got {out.device}"
    return None


def _det_and_params(inp: Inputs, scheme: str):
    """Smoke-geometry detector + its params (`init` on the inputs' key)."""
    from repro_torch.configs import yolo_irc
    from repro_torch.models.detector import IRCDetector
    det = IRCDetector(yolo_irc.smoke(scheme))
    return det, det.init(inp.key(), device=inp.device)


def _det_forward(inp: Inputs, scheme: str, mode: str):
    from repro_torch.core.nonideal import NonidealConfig
    det, params = _det_and_params(inp, scheme)
    B = 2
    images = inp.floats((B, *det.cfg.img_hw, 3))
    cfg_ni = NonidealConfig.none() if mode == "train" else NonidealConfig.all()
    out = det.apply(params, images, mode=mode, key=inp.key(1), cfg_ni=cfg_ni)
    gh, gw, ho = det.head_geometry()
    return out, _expect(out, inp, (B, gh, gw, ho), torch.float32,
                        f"detector.apply[{mode},{scheme}]")


def _det_ensemble(inp: Inputs, n_chips: int,
                  use_kernel: Optional[bool] = None):
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.mc.detector_mc import build_detector_ensemble
    det, params = _det_and_params(inp, "ternary")
    B = 2
    images = inp.floats((B, *det.cfg.img_hw, 3))
    ens = build_detector_ensemble(inp.key(1), det, params, n_chips,
                                  cfg=NonidealConfig.all())
    out = det.apply(params, images, mode="ensemble", ensemble=ens,
                    cfg_ni=NonidealConfig.all(), use_kernel=use_kernel)
    gh, gw, ho = det.head_geometry()
    tag = ",kernel" if use_kernel else ""
    return out, _expect(out, inp, (n_chips, B, gh, gw, ho), torch.float32,
                        f"detector.apply[ensemble x{n_chips}{tag}]")


def _pipelined_chunk(inp: Inputs, n_chips: int):
    """The pipelined sweep's chunk: hoisted planes in, sampled ensemble +
    whole-network forward out (`_sample_and_forward`, the twin of the JAX
    package's `_sampled_chunk_forward`)."""
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.mc.detector_mc import _sample_and_forward, detector_planes
    det, params = _det_and_params(inp, "ternary")
    B = 2
    planes, meta = detector_planes(det, params)
    out = _sample_and_forward(
        params, inp.floats((B, *det.cfg.img_hw, 3)), inp.key(1),
        inp.arange(n_chips), planes, det_cfg=det.cfg, spec=det.spec,
        cfg_ni=NonidealConfig.all(), sa_extra=0.0, meta=meta)
    gh, gw, ho = det.head_geometry()
    return out, _expect(out, inp, (n_chips, B, gh, gw, ho), torch.float32,
                        f"_sampled_chunk_forward[x{n_chips}]")


def _committee_wave(inp: Inputs, slots: int, committee: int):
    """The serving engine's wave: [slots] request lanes, each its own
    committee forward keyed by its request key -> [slots, chips, gh, gw,
    ho]."""
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.mc.detector_mc import (committee_wave_forward,
                                            detector_planes)
    det, params = _det_and_params(inp, "ternary")
    planes, meta = detector_planes(det, params)
    out = committee_wave_forward(
        params, inp.floats((slots, *det.cfg.img_hw, 3)), inp.keys(slots),
        inp.arange(committee), planes, det_cfg=det.cfg, spec=det.spec,
        cfg_ni=NonidealConfig.all(), sa_extra=0.0, meta=meta)
    gh, gw, ho = det.head_geometry()
    return out, _expect(out, inp, (slots, committee, gh, gw, ho),
                        torch.float32,
                        f"committee_wave_forward[s{slots},x{committee}]")


def _qat_step(inp: Inputs, train_chips: int):
    from torch.utils._pytree import tree_flatten
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.steps import make_det_qat_step
    det, params = _det_and_params(inp, "ternary")
    opt = adamw_init(params)
    step = make_det_qat_step(det, train_chips=train_chips)
    B = 2
    gh, gw, _ = det.head_geometry()
    A = det.cfg.n_anchors
    targets = {"txywh": inp.floats((B, gh, gw, A, 4)),
               "obj": inp.bits((B, gh, gw, A)),
               "cls": inp.ints((B, gh, gw, A), det.cfg.n_classes)}
    lr = torch.full((), 1e-3, dtype=torch.float32, device=inp.device)
    out = step(params, opt, inp.floats((B, *det.cfg.img_hw, 3)), targets,
               lr, inp.key(1), inp.key(2))
    new_params, new_opt, loss = out
    for got, want, what in ((new_params, params, "params"),
                            (new_opt, opt, "opt")):
        got_leaves, got_td = tree_flatten(got)
        want_leaves, want_td = tree_flatten(want)
        if got_td != want_td:
            return out, (f"qat_step[chips={train_chips}]: {what} tree "
                         f"changed ({want_td} -> {got_td})")
        for a, b in zip(got_leaves, want_leaves):
            if a.shape != b.shape or a.dtype != b.dtype:
                return out, (f"qat_step[chips={train_chips}]: {what} leaf "
                             f"{tuple(b.shape)}/{b.dtype} -> "
                             f"{tuple(a.shape)}/{a.dtype}")
    return out, _expect(loss, inp, (), torch.float32,
                        f"qat_step[chips={train_chips}] loss")


_LAYER = dict(n_chips=3, batch=4, fan_in=60, n_out=20, bias_rows=16)


def _ensemble_apply(inp: Inputs, kernel: bool, per_chip_x: bool = False,
                    device_name: Optional[str] = None, t_days: float = 0.0):
    from repro_torch.core.mapping import ternary_planes
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.mc import engine as mc_engine
    from repro_torch.mc.ensemble import sample_ensemble
    model = None
    if device_name is not None:
        from repro_torch.device import get_device_model
        model = get_device_model(device_name, t_days=t_days)
    C, B, K, N = (_LAYER[k] for k in ("n_chips", "batch", "fan_in", "n_out"))
    cfg = NonidealConfig.all()
    mapped = ternary_planes(inp.normals((K, N)),
                            bias_rows=_LAYER["bias_rows"])
    ens = sample_ensemble(inp.key(), mapped, C, cfg=cfg, device=model)
    x = inp.bits((C, B, K) if per_chip_x else (B, K))
    apply = (mc_engine.ensemble_apply_kernel if kernel
             else mc_engine.ensemble_apply)
    out = apply(ens, x, cfg=cfg, per_chip_x=per_chip_x, device=model)
    name = "ensemble_apply_kernel" if kernel else "ensemble_apply"
    if per_chip_x:
        name += "[per_chip_x]"
    if model is not None:
        name += f"[{model.name}]"
    return out, _expect(out, inp, (C, B, N), torch.float32, name)


def _device_sampling(inp: Inputs, device_name: str, t_days: float):
    """The device-seam sampling roots: a measured / aged backend must sample
    the same ensemble geometry as the analytic path — backends change
    values, never shapes."""
    from repro_torch.core.mapping import ternary_planes
    from repro_torch.core.nonideal import NonidealConfig
    from repro_torch.device import get_device_model
    from repro_torch.mc.ensemble import sample_ensemble
    model = get_device_model(device_name, t_days=t_days)
    C, K, N = (_LAYER[k] for k in ("n_chips", "fan_in", "n_out"))
    mapped = ternary_planes(inp.normals((K, N)),
                            bias_rows=_LAYER["bias_rows"])
    ens = sample_ensemble(inp.key(), mapped, C, cfg=NonidealConfig.all(),
                          device=model)
    return ens.ep, _expect(ens.ep, inp, (C, K + _LAYER["bias_rows"], N),
                           torch.float32, f"sample_ensemble[{model.name}]")


def _lm_smoke(inp: Inputs, arch: str):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import LM
    cfg = get_config(arch, "smoke")
    lm = LM(cfg)
    params = lm.init(inp.key(), device=inp.device)
    B, S = 2, 16
    out = lm.apply(params, inp.ints((B, S), cfg.vocab_size), remat="none")[0]
    return out, _expect(out, inp, (B, S, cfg.vocab_size), torch.float32,
                        f"LM.apply[{arch}-smoke]")


def _lm_serve_step(inp: Inputs, arch: str, step: str):
    """LM.prefill of a [2, 16] batch into a fresh cache, then ("decode")
    one decode step: the last logits [2, 1, V] float32, and the cache's
    index at the positions written."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import LM
    cfg = get_config(arch, "smoke")
    lm = LM(cfg)
    params = lm.init(inp.key(), device=inp.device)
    B, S = 2, 16
    cache = lm.init_cache(B, 32, device=inp.device)
    out, cache = lm.prefill(params, inp.ints((B, S), cfg.vocab_size), cache)
    if step == "decode":
        out, cache = lm.decode_step(params, inp.ints((B, 1), cfg.vocab_size),
                                    cache)
    what = f"LM.{step}[{arch}-smoke]"
    want = S + (step == "decode")
    return out, (_expect(out, inp, (B, 1, cfg.vocab_size), torch.float32,
                         what)
                 or (None if cache["index"] == want else
                     f"{what}: cache index {cache['index']}, not {want}"))


def port_contracts() -> List[ShapeContract]:
    """The serving steps of each of the port's own architectures at its
    smoke widths: the batched prefill and a decode step after it."""
    from repro_torch.configs.registry import PORT_ARCHS
    return [ShapeContract(f"LM.{step}[{arch}-smoke]",
                          "src/repro_torch/models/transformer.py",
                          lambda i, a=arch, s=step: _lm_serve_step(i, a, s),
                          arch)
            for arch in sorted(PORT_ARCHS) for step in ("prefill", "decode")]


def shape_contracts() -> List[ShapeContract]:
    """Every declared entry-point contract, detector/MC first."""
    from repro_torch.configs.registry import ARCH_STATUS, list_archs

    det_file = "src/repro_torch/models/detector.py"
    mc_file = "src/repro_torch/mc/engine.py"
    chunk_file = "src/repro_torch/mc/detector_mc.py"
    steps_file = "src/repro_torch/train/steps.py"
    det = "yolo-irc"
    C = ShapeContract
    contracts = [
        C("detector.apply[train,ternary]", det_file,
          lambda i: _det_forward(i, "ternary", "train"), det, "plain"),
        C("detector.apply[train,binary]", det_file,
          lambda i: _det_forward(i, "binary", "train"), det, "plain"),
        C("detector.apply[eval,ternary]", det_file,
          lambda i: _det_forward(i, "ternary", "eval"), det, "plain"),
        C("detector.apply[eval,binary]", det_file,
          lambda i: _det_forward(i, "binary", "eval"), det, "plain"),
        C("detector.apply[ensemble x4]", det_file,
          lambda i: _det_ensemble(i, 4), det),
        C("detector.apply[ensemble x4,kernel]", det_file,
          lambda i: _det_ensemble(i, 4, use_kernel=True), det, "kernel"),
        C("_sampled_chunk_forward[x3]", chunk_file,
          lambda i: _pipelined_chunk(i, 3), det),
        C("committee_wave_forward[s2,x3]", chunk_file,
          lambda i: _committee_wave(i, 2, 3), det),
        C("qat_step[chips=1]", steps_file, lambda i: _qat_step(i, 1), det,
          "plain"),
        C("qat_step[chips=4]", steps_file, lambda i: _qat_step(i, 4), det,
          "plain"),
        C("ensemble_apply", mc_file, lambda i: _ensemble_apply(i, False),
          det, "plain"),
        C("ensemble_apply_kernel", mc_file,
          lambda i: _ensemble_apply(i, True), det, "kernel"),
        C("ensemble_apply_kernel[per_chip_x]", mc_file,
          lambda i: _ensemble_apply(i, True, per_chip_x=True), det,
          "kernel"),
        C("sample_ensemble[measured]", "src/repro_torch/device/measured.py",
          lambda i: _device_sampling(i, "measured", 0.0), det, "plain"),
        C("sample_ensemble[measured@t30d]",
          "src/repro_torch/device/retention.py",
          lambda i: _device_sampling(i, "measured", 30.0), det, "plain"),
        C("ensemble_apply[measured]", mc_file,
          lambda i: _ensemble_apply(i, False, device_name="measured"), det,
          "plain"),
        C("ensemble_apply_kernel[measured@t30d]", mc_file,
          lambda i: _ensemble_apply(i, True, device_name="measured",
                                    t_days=30.0), det, "kernel"),
    ]
    for arch in list_archs():
        if ARCH_STATUS.get(arch) == "legacy":
            contracts.append(C(
                f"LM.apply[{arch}-smoke] (legacy)",
                "src/repro_torch/configs/registry.py",
                lambda i, a=arch: _lm_smoke(i, a), arch))
    return contracts
