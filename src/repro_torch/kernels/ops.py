"""Public entry points of the IRC MVM kernels: checks and dispatch.

A CPU tensor goes to the plain PyTorch version (`repro_torch.kernels.ref`);
a CUDA tensor goes to the hand-written Hopper kernel (`csrc/irc_mvm.cu`), or
the call raises — there is no fallback from the card to the plain version.
Each kernel wrapper counts its launches in a plain integer (`LAUNCHES`), so a
run can show that its main path went through the kernel; calls served by the
plain version do not count.

Nothing needs padding: the kernel masks ragged R, N and B itself.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.ref import (IrcEpilogueParams, irc_mvm_chips_ref,
                                     irc_mvm_ref)

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES: Dict[str, int] = {"irc_mvm_chips": 0, "irc_mvm": 0}


def reset_launches() -> None:
    """Set every launch counter to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x, ep, en, gp, gn, eps_sa, rnd_bits):
    if ep.ndim != 3 or en.shape != ep.shape:
        raise ValueError(f"ep/en must be [C,R,N], got {tuple(ep.shape)} and "
                         f"{tuple(en.shape)}")
    C, R, N = ep.shape
    if x.ndim not in (2, 3) or x.shape[-1] != R or (
            x.ndim == 3 and x.shape[0] != C):
        raise ValueError(f"x must be [B,{R}] or [{C},B,{R}], got "
                         f"{tuple(x.shape)}")
    B = x.shape[-2]
    if gp.shape != gn.shape or gp.shape not in ((R, N), (C, R, N)):
        raise ValueError(f"gp/gn must be [{R},{N}] or [{C},{R},{N}], got "
                         f"{tuple(gp.shape)} and {tuple(gn.shape)}")
    for name, t in (("eps_sa", eps_sa), ("rnd_bits", rnd_bits)):
        if t.shape != (C, B, N):
            raise ValueError(f"{name} must be [{C},{B},{N}], got "
                             f"{tuple(t.shape)}")
    devs = {t.device for t in (x, ep, en, gp, gn, eps_sa, rnd_bits)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    return devs.pop()


def irc_mvm_chips(x: torch.Tensor, ep: torch.Tensor, en: torch.Tensor,
                  gp: torch.Tensor, gn: torch.Tensor, eps_sa: torch.Tensor,
                  rnd_bits: torch.Tensor, params: IrcEpilogueParams
                  ) -> torch.Tensor:
    """Chip-batched fused IRC MVM: x [B,R] shared (or [C,B,R] per chip),
    effective planes ep/en [C,R,N], placement planes gp/gn [R,N] shared or
    [C,R,N], periphery noise eps_sa/rnd_bits [C,B,N] -> [C,B,N] float32,
    in ONE kernel launch on the card."""
    dev = _check(x, ep, en, gp, gn, eps_sa, rnd_bits)
    if dev.type == "cpu":
        return irc_mvm_chips_ref(x, ep, en, gp, gn, eps_sa, rnd_bits, params)
    out = _launch(dev, x, ep, en, gp, gn, eps_sa, rnd_bits, params)
    LAUNCHES["irc_mvm_chips"] += 1
    return out


def irc_mvm(x: torch.Tensor, ep: torch.Tensor, en: torch.Tensor,
            gp: torch.Tensor, gn: torch.Tensor, eps_sa: torch.Tensor,
            rnd_bits: torch.Tensor, params: IrcEpilogueParams
            ) -> torch.Tensor:
    """Single-chip fused IRC MVM: x [B,R], planes [R,N], eps_sa/rnd_bits
    [B,N] -> [B,N]; the C = 1 case of the same kernel."""
    if x.ndim != 2 or ep.ndim != 2:
        raise ValueError(f"irc_mvm takes x [B,R] and planes [R,N], got "
                         f"{tuple(x.shape)} and {tuple(ep.shape)}")
    args = (x, ep[None], en[None], gp, gn, eps_sa[None], rnd_bits[None])
    dev = _check(*args)
    if dev.type == "cpu":
        return irc_mvm_ref(x, ep, en, gp, gn, eps_sa, rnd_bits, params)
    out = _launch(dev, *args, params)[0]
    LAUNCHES["irc_mvm"] += 1
    return out


def _launch(dev, x, ep, en, gp, gn, eps_sa, rnd_bits, params):
    """One kernel launch on checked operands; raises if the kernel cannot
    be built or the launch is refused (there is no fallback)."""
    if dev.type != "cuda":
        raise RuntimeError(f"the IRC MVM runs on CPU or CUDA, not {dev}")
    from repro_torch.kernels import irc_mvm as kern
    kern.load()
    ops = [t.contiguous().float() for t in
           (x, ep, en, gp, gn, eps_sa, rnd_bits)]
    C, _, N = ep.shape
    out = torch.empty((C, x.shape[-2], N), dtype=torch.float32, device=dev)
    kern.launch_chips(*ops, out, params)
    return out


def irc_mvm_from_mapped(key: torch.Tensor, x_bits: torch.Tensor, mapped,
                        cfg, spec, *, sa_extra_units: float = 0.0,
                        output: str = "binary") -> torch.Tensor:
    """Kernel-backed single-chip `crossbar_forward` (single-shot): samples
    the chip's planes and periphery noise with the same key discipline,
    then calls `irc_mvm`.  Runs where `x_bits` lives."""
    from repro_torch import prng
    from repro_torch.core.crossbar import sample_chip_planes
    from repro_torch.core.mapping import extend_inputs
    gp, gn = mapped.g_pos, mapped.g_neg
    ep, en, k_sa = sample_chip_planes(key, gp, gn, mapped.scheme, cfg, spec)
    k_off, k_rng = prng.split(k_sa)
    x_ext = extend_inputs(x_bits, mapped)
    B, N = x_ext.shape[0], gp.shape[1]
    eps_sa = prng.normal(k_off, (B, N))
    rnd = prng.bernoulli(k_rng, 0.5, (B, N)).float()
    params = IrcEpilogueParams.from_macro(
        spec, sa_extra=sa_extra_units, output=output,
        apply_nonlinearity=cfg.nonlinearity, apply_ir=cfg.ir_drop,
        apply_sa=cfg.sa_variation, apply_range=cfg.sensing_range)
    return irc_mvm(x_ext, ep, en, gp, gn, eps_sa, rnd, params)
